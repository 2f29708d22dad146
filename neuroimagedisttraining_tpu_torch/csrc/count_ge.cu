// counts[j] = #{ i : x[i] >= thr[j] } for up to 1024 thresholds in any order,
// and the whole histogram select of the k-th largest value built on it.
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/topk.py
// (_count_ge_pallas -> _count_ge_kernel), whose sequential grid compared
// every element with every threshold and carried f32 counts in one output
// block from step to step, and the bracket loop of kth_largest around it.
//
// The counting pass (count_ge_kernel, and each round of the select): blocks
// run in any order and each element is compared with about log2(nbins)
// thresholds, not all of them:
//   1. the block holds the thresholds sorted in shared memory (a bitonic
//      sort of 64-bit keys: an order-preserving image of the value above
//      the threshold's index; NaN last, ties by index);
//   2. for each of its elements of x, a thread finds by branchless binary
//      search how many sorted thresholds are <= it (x >= thr[j] exactly
//      when thr[j] is one of them; a NaN element finds none) and adds one to
//      that per-block integer bin in shared memory. Each thread takes four
//      elements at a time (one 16-byte load, four searches side by side);
//   3. a suffix sum over the bins gives the block's count for each sorted
//      threshold, added once to the 64-bit integer count of the threshold it
//      came from. A NaN threshold counts nothing, as x >= NaN is false.
// Integer atomics are exact and their order does not matter, so the counts
// are exact at any size (the reference's f32 counts are exact below 2^24);
// a block's own bins are 32-bit, exact below 2^32 elements per block. The
// ragged tail of x (n mod 4 elements) is masked, not padded.
//
// The select (kth_largest on the card): 1 + rounds launches over a small
// zeroed device state (SelectState), with no host sync and no small torch
// ops between them:
//   - count_ge_minmax_kernel reduces min, max and the all-finite flag of x
//     (integer atomics on order keys);
//   - count_ge_round_kernel counts x against the round's ladder, which the
//     previous launch left sorted in the state;
//   - the last block of each launch to finish (a __threadfence and an atomic
//     ticket) runs the epilogue: the longest prefix of counts >= k and the
//     next bracket by the rule of ops/topk.py's plain loop (select_bracket),
//     the next ladder by the reference's linspace formula, each operation
//     rounded on its own, sorted once by that block; then it zeroes the
//     counts and the ticket. The result is the bracket's lo, or NaN when x
//     holds a non-finite value.
// The scores stay resident in the 50 MB L2 after the first pass.
//
// Bound: bytes (NVIDIA H100 SXM data-sheet peaks at its 700 W limit). Both
// functions need one read of x from HBM: 10.3 MB for 2.57 M scores, about
// 3.1 us at 3.35 TB/s; the select's later passes find x in L2. The search
// needs ceil(log2(nbins + 1)) = 10 compares per element at 512 thresholds,
// 26 M a pass: 0.4 us at 67 T per second, 1.6 us for the min/max pass and
// 4 rounds of the select.
#include "common.cuh"

#include <stddef.h>

namespace {

constexpr int MAX_BINS = 1024;
constexpr int THREADS = MAX_BINS;  // one thread per bin in the suffix sum
constexpr unsigned FULL = 0xffffffffu;

// What the select keeps on the device between its launches. The wrapper
// hands over a zeroed buffer of sizeof(SelectState) bytes; every epilogue
// leaves counts and ticket zero again.
struct SelectState {
  unsigned long long counts[MAX_BINS];  // this round's counts, by ladder index
  float sv[MAX_BINS];  // this round's ladder, sorted ascending, NaN last
  int si[MAX_BINS];    // the ladder index of each sorted value
  unsigned ticket;     // blocks of this launch that are done
  unsigned key_max;    // order key of the largest non-NaN x
  unsigned key_min;    // ~order key of the smallest non-NaN x
  unsigned nonfinite;  // 1 when x holds NaN or +-inf
  float lo, hi;        // the bracket
  float result;        // the k-th largest value, or NaN
  int nv;              // non-NaN values in sv
};

// An unsigned image of f with the order of the floats (-0 just below +0);
// every NaN maps above +inf.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  if (isnan(f)) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ladder value i of num from lo to hi: the reference's linspace formula,
// lo * (1 - i / (num - 1)) + hi * (i / (num - 1)), hi appended; each
// operation rounded on its own (no contraction into an FMA)
__device__ __forceinline__ float ladder(float lo, float hi, int i, int num) {
  if (i == num - 1) return hi;
  const float step = __fdiv_rn((float)i, (float)(num - 1));
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, step)), __fmul_rn(hi, step));
}

// #{ r : sv[r] <= v } for sv sorted ascending with NaN after its nv numbers;
// size is a power of two >= nv, and sv holds 2 * size - 1 readable slots.
__device__ __forceinline__ int rank_le(const float* sv, int size, float v) {
  int pos = 0;
  for (int s = size; s > 0; s >>= 1)
    if (sv[pos + s - 1] <= v) pos += s;
  return pos;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int size = 1;
  while (size < n) size <<= 1;
  return size;
}

struct Shared {
  unsigned long long key[MAX_BINS];
  float sv[2 * MAX_BINS];         // sorted values, NaN after
  int si[MAX_BINS];               // their original indices
  unsigned int hist[MAX_BINS + 1];  // elements by rank_le
  unsigned int wsum[THREADS / 32];
  int flag;
};

// Sort this thread's threshold tv (t < nbins; NaN for the others) with the
// block's: fills sh.sv[0 .. MAX_BINS) (NaN after the nv numbers) and sh.si;
// returns nv. Ends with a __syncthreads.
__device__ int sort_ladder(Shared& sh, float tv, int nbins) {
  const int t = threadIdx.x;
  const int size = pow2_at_least(nbins);
  // slots past nbins sort after every threshold, NaN ones included
  sh.key[t] = ((unsigned long long)order_key(tv) << 32) | (unsigned)t;
  const int nv = __syncthreads_count(t < nbins && !isnan(tv));
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (t < size / 2) {
        const int i = 2 * t - (t & (j - 1));  // the pair (i, i + j)
        const unsigned long long a = sh.key[i], b = sh.key[i + j];
        if ((a > b) == ((i & k) == 0)) {      // ascending where bit k clear
          sh.key[i] = b;
          sh.key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  sh.si[t] = (int)(sh.key[t] & 0xffffffffu);
  sh.sv[t] = t < nv ? key_value((unsigned)(sh.key[t] >> 32)) : nan_f();
  __syncthreads();
  return nv;
}

// The counting pass over sh.sv (sorted, nv numbers, sort width size): the
// block's count for sorted threshold t = #{ its elements >= sv[t] }, added
// to counts[sh.si[t]].
__device__ void count_pass(Shared& sh, const float* __restrict__ x,
                           long long n, int size, int nv,
                           unsigned long long* counts) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  sh.sv[t + MAX_BINS] = nan_f();
  sh.hist[t] = 0u;
  if (t == 0) sh.hist[MAX_BINS] = 0u;
  __syncthreads();
  const float* sv = sh.sv;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long n4 = n >> 2;
  for (long long i = (long long)blockIdx.x * THREADS + t; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 v = __ldg(&x4[i]);
    int a = 0, b = 0, c = 0, d = 0;
    for (int s = size; s > 0; s >>= 1) {  // four searches side by side
      if (sv[a + s - 1] <= v.x) a += s;
      if (sv[b + s - 1] <= v.y) b += s;
      if (sv[c + s - 1] <= v.z) c += s;
      if (sv[d + s - 1] <= v.w) d += s;
    }
    if (a) atomicAdd(&sh.hist[a], 1u);
    if (b) atomicAdd(&sh.hist[b], 1u);
    if (c) atomicAdd(&sh.hist[c], 1u);
    if (d) atomicAdd(&sh.hist[d], 1u);
  }
  if (blockIdx.x == 0 && t < (int)(n & 3)) {
    const int p = rank_le(sv, size, __ldg(&x[(n4 << 2) + t]));
    if (p) atomicAdd(&sh.hist[p], 1u);
  }
  __syncthreads();

  // block count of sorted threshold t = #{ elements with rank > t }: an
  // inclusive suffix sum of hist[t + 1 .. nv], by warp then across warps
  unsigned cnt = t < nv ? sh.hist[t + 1] : 0u;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(FULL, cnt, o);
    if (lane + o < 32) cnt += y;
  }
  if (lane == 0) sh.wsum[warp] = cnt;
  __syncthreads();
  for (int w = warp + 1; w < THREADS / 32; ++w) cnt += sh.wsum[w];
  if (t < nv && cnt) atomicAdd(&counts[sh.si[t]], (unsigned long long)cnt);
}

// True in every thread of the last block of the grid to get here; its
// writes before the call, and every other block's, are visible after it.
__device__ bool last_block(Shared& sh, unsigned* ticket) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sh.flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.flag) return false;
  __threadfence();
  return true;
}

// Epilogue tail: the bracket (lo, hi) is final for this launch. Writes it
// and the result, and (unless this was the last round) the next ladder,
// sorted, for the next round.
__device__ void next_ladder(Shared& sh, SelectState* st, float lo, float hi,
                            int nbins, bool last) {
  const int t = threadIdx.x;
  if (t == 0) {
    st->lo = lo;
    st->hi = hi;
    st->result = __ldcg(&st->nonfinite) ? nan_f() : lo;
    st->ticket = 0u;
  }
  if (last) return;
  const int nv = sort_ladder(sh, t < nbins ? ladder(lo, hi, t, nbins)
                                           : nan_f(), nbins);
  st->sv[t] = sh.sv[t];
  st->si[t] = sh.si[t];
  if (t == 0) st->nv = nv;
}

__global__ void __launch_bounds__(THREADS)
count_ge_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ thr, int nbins,
                unsigned long long* __restrict__ counts) {
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int nv = sort_ladder(sh, t < nbins ? thr[t] : nan_f(), nbins);
  count_pass(sh, x, n, pow2_at_least(nbins), nv, counts);
}

// First pass of the select: min, max and the all-finite flag of x; the
// last block sets the bracket to [min, max] and sorts the first ladder.
__global__ void __launch_bounds__(THREADS)
count_ge_minmax_kernel(const float* __restrict__ x, long long n, int nbins,
                       int rounds, SelectState* st) {
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  unsigned kmax = 0u, kmin = 0u, bad = 0u;  // kmin holds ~key: max of them
  auto take = [&](float v) {
    bad |= !isfinite(v);
    if (!isnan(v)) {
      const unsigned k = order_key(v);
      kmax = max(kmax, k);
      kmin = max(kmin, ~k);
    }
  };
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long n4 = n >> 2;
  for (long long i = (long long)blockIdx.x * THREADS + t; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 v = __ldg(&x4[i]);
    take(v.x);
    take(v.y);
    take(v.z);
    take(v.w);
  }
  if (blockIdx.x == 0 && t < (int)(n & 3)) take(__ldg(&x[(n4 << 2) + t]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmax = max(kmax, __shfl_xor_sync(FULL, kmax, o));
    kmin = max(kmin, __shfl_xor_sync(FULL, kmin, o));
    bad |= __shfl_xor_sync(FULL, bad, o);
  }
  if (lane == 0) {
    if (kmax) atomicMax(&st->key_max, kmax);
    if (kmin) atomicMax(&st->key_min, kmin);
    if (bad) atomicOr(&st->nonfinite, 1u);
  }
  if (!last_block(sh, &st->ticket)) return;
  const unsigned kx = __ldcg(&st->key_max);
  const unsigned kn = __ldcg(&st->key_min);
  // no number at all (every x NaN): a NaN bracket, and NaN as the result
  const float lo = kn ? key_value(~kn) : nan_f();
  const float hi = kx ? key_value(kx) : nan_f();
  __syncthreads();
  next_ladder(sh, st, lo, hi, nbins, rounds == 0);
}

// One round of the select: count x against the sorted ladder in the state;
// the last block narrows the bracket to the longest prefix of bins holding
// at least k elements and leaves the next round's ladder.
__global__ void __launch_bounds__(THREADS)
count_ge_round_kernel(const float* __restrict__ x, long long n, int nbins,
                      long long k, int last, SelectState* st) {
  __shared__ Shared sh;
  __shared__ int first;
  const int t = threadIdx.x;
  const int nv = st->nv;
  sh.sv[t] = t < nbins ? st->sv[t] : nan_f();
  sh.si[t] = t < nbins ? st->si[t] : 0;
  count_pass(sh, x, n, pow2_at_least(nbins), nv, st->counts);
  if (!last_block(sh, &st->ticket)) return;

  // counts fall as the threshold rises, except for sub-ulp ladder wiggle in
  // the last rounds: the longest prefix of counts >= k, as the plain loop
  const long long c =
      t < nbins ? (long long)__ldcg(&st->counts[t]) : 0ll;
  if (t == 0) first = nbins;
  __syncthreads();
  if (t < nbins && c < k) atomicMin(&first, t);
  __syncthreads();
  const int j = max(first - 1, 0);
  const float lo = st->lo, hi = st->hi;
  const float nlo = ladder(lo, hi, j, nbins);
  const float nhi = j + 1 < nbins ? ladder(lo, hi, j + 1, nbins) : hi;
  if (t < nbins) st->counts[t] = 0ull;
  __syncthreads();  // every thread has read lo and hi
  next_ladder(sh, st, nlo, nhi, nbins, last != 0);
}

int blocks_for(long long n, int max_blocks) {
  long long blocks = (n / 4 + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

}  // namespace

// Blocks a launch uses on the current device: one resident wave (the three
// kernels share their shared-memory layout; the widest sets the wave).
NIDT_EXPORT int count_ge_num_blocks(int* nblocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_ge_round_kernel,
                                                THREADS, 0);
  *nblocks = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaGetLastError();
}

// x 16-byte aligned; counts zeroed by the caller; 1 <= nbins <= 1024.
NIDT_EXPORT int count_ge_launch(const float* x, long long n, const float* thr,
                                int nbins, unsigned long long* counts,
                                int max_blocks, void* stream) {
  count_ge_kernel<<<blocks_for(n, max_blocks), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, n, thr, nbins,
                                                          counts);
  return (int)cudaGetLastError();
}

// Bytes of the select's state, and the byte offset of its float result.
NIDT_EXPORT int kth_state_layout(int* bytes, int* result_offset) {
  *bytes = (int)sizeof(SelectState);
  *result_offset = (int)offsetof(SelectState, result);
  return 0;
}

// The whole select: 1 + rounds launches on one stream, no host sync. x is
// 16-byte aligned with n >= 1; state is a zeroed buffer of the size
// kth_state_layout gives; 2 <= nbins <= 1024.
NIDT_EXPORT int kth_select_launch(const float* x, long long n, long long k,
                                  int nbins, int rounds, void* state,
                                  int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SelectState* st = static_cast<SelectState*>(state);
  const int blocks = blocks_for(n, max_blocks);
  count_ge_minmax_kernel<<<blocks, THREADS, 0, s>>>(x, n, nbins, rounds, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int r = 0; r < rounds; ++r) {
    count_ge_round_kernel<<<blocks, THREADS, 0, s>>>(x, n, nbins, k,
                                                     r == rounds - 1, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
