// counts[j] = #{ i : x[i] >= thr[j] } for up to 1024 thresholds in any order.
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/topk.py
// (_count_ge_pallas -> _count_ge_kernel), whose sequential grid compared
// every element with every threshold and carried f32 counts in one output
// block from step to step. Here blocks run in any order and each element is
// compared with about log2(nbins) thresholds, not all of them:
//   1. each block sorts its copy of the thresholds in shared memory: a
//      bitonic sort of 64-bit keys (an order-preserving image of the value
//      above the threshold's index; NaN last, ties by index);
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
// Bound: bytes. x is read once: 10.3 MB for 2.57 M scores, about 3.1 us at
// 3.35 TB/s. The search needs ceil(log2(nbins + 1)) = 10 compares per
// element at 512 thresholds, 26 M in all: 0.4 us at 67 T per second.
#include "common.cuh"

namespace {

constexpr int MAX_BINS = 1024;
constexpr int THREADS = MAX_BINS;  // one thread per bin in the suffix sum
constexpr unsigned FULL = 0xffffffffu;

// An unsigned image of f with the order of the floats (-0 just below +0);
// every NaN maps above +inf.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  if (isnan(f)) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// #{ r : sv[r] <= v } for sv sorted ascending with NaN after its nv numbers;
// size is a power of two >= nv, and sv holds 2 * size - 1 readable slots.
__device__ __forceinline__ int rank_le(const float* sv, int size, float v) {
  int pos = 0;
  for (int s = size; s > 0; s >>= 1)
    if (sv[pos + s - 1] <= v) pos += s;
  return pos;
}

__global__ void __launch_bounds__(THREADS)
count_ge_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ thr, int nbins,
                unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long key[MAX_BINS];
  __shared__ float sv[2 * MAX_BINS];         // sorted values, NaN after
  __shared__ int si[MAX_BINS];               // their original indices
  __shared__ unsigned int hist[MAX_BINS + 1];  // elements by rank_le
  __shared__ unsigned int wsum[THREADS / 32];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float nan = __int_as_float(0x7fc00000);

  int size = 1;  // sort width: the power of two >= nbins
  while (size < nbins) size <<= 1;
  const float tv = t < nbins ? thr[t] : nan;
  // slots past nbins sort after every threshold, NaN ones included
  key[t] = ((unsigned long long)order_key(tv) << 32) | (unsigned)t;
  sv[t + MAX_BINS] = nan;
  hist[t] = 0u;
  if (t == 0) hist[MAX_BINS] = 0u;
  const int nv = __syncthreads_count(t < nbins && !isnan(tv));
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (t < size / 2) {
        const int i = 2 * t - (t & (j - 1));  // the pair (i, i + j)
        const unsigned long long a = key[i], b = key[i + j];
        if ((a > b) == ((i & k) == 0)) {      // ascending where bit k clear
          key[i] = b;
          key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  const int idx = (int)(key[t] & 0xffffffffu);
  si[t] = idx;
  sv[t] = t < nv ? thr[idx] : nan;
  __syncthreads();

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
    if (a) atomicAdd(&hist[a], 1u);
    if (b) atomicAdd(&hist[b], 1u);
    if (c) atomicAdd(&hist[c], 1u);
    if (d) atomicAdd(&hist[d], 1u);
  }
  if (blockIdx.x == 0 && t < (int)(n & 3)) {
    const int p = rank_le(sv, size, __ldg(&x[(n4 << 2) + t]));
    if (p) atomicAdd(&hist[p], 1u);
  }
  __syncthreads();

  // block count of sorted threshold t = #{ elements with rank > t }: an
  // inclusive suffix sum of hist[t + 1 .. nv], by warp then across warps
  unsigned cnt = t < nv ? hist[t + 1] : 0u;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(FULL, cnt, o);
    if (lane + o < 32) cnt += y;
  }
  if (lane == 0) wsum[warp] = cnt;
  __syncthreads();
  for (int w = warp + 1; w < THREADS / 32; ++w) cnt += wsum[w];
  if (t < nv && cnt) atomicAdd(&counts[si[t]], (unsigned long long)cnt);
}

}  // namespace

// Blocks the launch uses on the current device: one resident wave.
NIDT_EXPORT int count_ge_num_blocks(int* nblocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_ge_kernel,
                                                THREADS, 0);
  *nblocks = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaGetLastError();
}

// x 16-byte aligned; counts zeroed by the caller; 1 <= nbins <= 1024.
NIDT_EXPORT int count_ge_launch(const float* x, long long n, const float* thr,
                                int nbins, unsigned long long* counts,
                                int max_blocks, void* stream) {
  long long blocks = (n / 4 + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  count_ge_kernel<<<(int)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, n, thr, nbins,
                                                          counts);
  return (int)cudaGetLastError();
}
