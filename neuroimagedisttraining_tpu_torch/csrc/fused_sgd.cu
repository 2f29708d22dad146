// Fused masked-SGD tail over every parameter leaf at once, updated in place:
//   g' = clip ? (ok ? g : (g / gnorm) * clip) : g
//   g' = g' + wd * p                 (if wd > 0)
//   t  = g' + momentum * t; g' = t   (if momentum > 0)
//   p  = p + (-lr) * g'
//   p  = p * mask                    (if masked)
// with gnorm = sqrt(sum of g^2 over every leaf) and ok = gnorm < clip.
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/fused_update.py
// (_leaf_pallas -> _make_kernel), one pallas_call per leaf over [rows, 128]
// blocks, with the global norm left to a separate XLA reduction.
//
// Bound: memory. At the flagship AlexNet3D (2,570,241 parameters over 24
// leaves, 19 of them <= 16,384 elements) one step reads p, g, t and mask
// and writes p and t once: 24 bytes a parameter, 61.7 MB, 18.4 us at
// 3.35 TB/s (NVIDIA H100 SXM data sheet). The norm's read of g comes from
// HBM; the apply's second read of g (10.3 MB) finds it in the 50 MB L2.
// Per leaf, the cost is not bytes but launches: one per leaf, each ~4 us
// of mostly empty device time for the small leaves, and the norm as ~75
// small torch ops. The design:
//
// 1. One multi-tensor pass. A launch takes a table of up to MAX_LEAVES
//    leaf descriptors {p, g, t, m, n, first chunk} by value in its kernel
//    parameters (__grid_constant__: 1,544 bytes, under the classic 4 KB
//    kernel-parameter limit). A longer leaf list (resnet18 has 62 leaves,
//    vgg11 34; the flagship 24) is cut into consecutive tables of
//    MAX_LEAVES leaves, each stepped by launches of its own: the step
//    takes two launches a table, and the flagship's stays at two. The
//    work is cut into CHUNK-float chunks that never straddle two leaves
//    (2.57 M parameters make 645); a block finds
//    a chunk's leaf by binary search over the first-chunk column and walks
//    its chunks in a grid-stride loop over about one resident wave of
//    blocks, so the small leaves share blocks with the large ones. Loads
//    and stores are 16-byte float4 where every pointer of the leaf is
//    16-byte aligned (a chunk
//    starts at a multiple of CHUNK floats), with a scalar tail for the
//    last n % 4 elements; a leaf with an unaligned pointer takes the
//    scalar loop. The stages are template parameters, as _make_kernel's
//    static flags are, so a disabled stage costs nothing.
// 2. The global norm on the device. fused_sgd_norm_kernel squares and sums
//    its chunks of g in fp64 (each square of a float is exact in fp64) in a
//    fixed order and writes one partial per block (a wave of its own: one
//    chunk a block at the flagship) into one buffer shared by every
//    table's launch, each at its own offset; in the last table's launch
//    the last block to finish (a __threadfence and an atomic ticket, which
//    it resets for the next step; the earlier launches ended before it
//    started) sums all the partials in a fixed order (thread t takes
//    partials t, t + 256, ... in index order, then a fixed shuffle and
//    warp tree),
//    rounds sqrt(sum) to float once, and writes [ok, gnorm, lr] into the
//    step's scalar buffer. The apply launch reads them. No torch op
//    computes scalars, the host never syncs, and two calls are bit-equal:
//    nothing depends on the order of atomics. The fp64 sum is within a few
//    float ulps of the plain fp32 sum of torch (within rtol 2e-6); the
//    kernel's ok = gnorm < clip can differ from the plain one's only where
//    gnorm lies within that tolerance of clip.
// 3. Two launches and one host call a step: fused_sgd_step_launch queues
//    the norm and the apply (the apply alone without a clip);
//    fused_sgd_apply_launch is the apply under given scalars. One
//    cooperative launch with a grid-wide sync would save a launch but not
//    the norm pass's read of g, and needs the whole grid resident; two
//    launches were kept.
//
// Every product and sum of the update is rounded on its own (__fmul_rn /
// __fadd_rn / __fdiv_rn, no contraction into FMA), so under the same
// [ok, gnorm, lr] the pass is bit-equal to the plain PyTorch chain, which
// rounds each operation separately too.
#include "common.cuh"

#include <string.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;                      // floats a chunk
constexpr int ITEMS = CHUNK / (4 * THREADS);     // float4s a thread a chunk
constexpr int MAX_LEAVES = 32;                   // leaves a table
constexpr int LEAF_WORDS = 6;                    // int64 words a table row
constexpr unsigned FULL = 0xffffffffu;

// One row of the host table, as ops/fused_update.py packs it (int64 words).
struct Leaf {
  float* p;
  const float* g;
  float* t;           // null without momentum
  const float* m;     // null without a mask
  long long n;        // elements
  long long first;    // the leaf's first chunk
};
static_assert(sizeof(Leaf) == LEAF_WORDS * 8, "Leaf is one host table row");

struct Table {
  Leaf leaf[MAX_LEAVES];
  int nleaves;
  int nchunks;
};

// clip, wd and momentum by value; lr when no lr pointer is given
struct Hyper {
  float clip, wd, mom, lr;
};

__device__ __forceinline__ int leaf_of(const Table& tab, int c) {
  int lo = 0, hi = tab.nleaves - 1;  // the last leaf whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.leaf[mid].first <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(uintptr_t bits) {
  return (bits & 15u) == 0;
}

// ---------------------------------------------------------------------------
// the global norm: per-block fp64 partials, the last block finishes
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
fused_sgd_norm_kernel(const __grid_constant__ Table tab, double* partials,
                      int part0, bool finish, unsigned* ticket, float* scal,
                      const Hyper h, const float* __restrict__ lr) {
  __shared__ double wsum[THREADS / 32];
  __shared__ int last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double acc = 0.0;
  for (int c = blockIdx.x; c < tab.nchunks; c += gridDim.x) {
    const Leaf& L = tab.leaf[leaf_of(tab, c)];
    const long long off = (long long)(c - L.first) * CHUNK;
    const int len = (int)min((long long)CHUNK, L.n - off);
    const float* __restrict__ g = L.g + off;
    if (aligned16((uintptr_t)L.g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int n4 = len >> 2;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = t + k * THREADS;
        if (i < n4) {
          const float4 v = __ldg(&g4[i]);
          acc = fma((double)v.x, (double)v.x, acc);
          acc = fma((double)v.y, (double)v.y, acc);
          acc = fma((double)v.z, (double)v.z, acc);
          acc = fma((double)v.w, (double)v.w, acc);
        }
      }
      const int i = (n4 << 2) + t;
      if (i < len) acc = fma((double)g[i], (double)g[i], acc);
    } else {
      for (int i = t; i < len; i += THREADS)
        acc = fma((double)g[i], (double)g[i], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(FULL, acc, o);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += wsum[w];
    partials[part0 + blockIdx.x] = s;
  }
  if (!finish) return;  // a later table's launch finishes the norm

  // the last block to finish: every partial is written
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  const int nparts = part0 + (int)gridDim.x;
  for (int i = t; i < nparts; i += THREADS) s += __ldcg(&partials[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  if (t == 0) {
    s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += wsum[w];
    const float gnorm = (float)sqrt(s);
    scal[0] = gnorm < h.clip ? 1.f : 0.f;
    scal[1] = gnorm;
    scal[2] = lr != nullptr ? *lr : h.lr;
    *ticket = 0u;  // ordered before the next launch on the stream
  }
}

// ---------------------------------------------------------------------------
// the apply: every leaf's update in one pass
// ---------------------------------------------------------------------------

struct Step {
  bool ok;
  float gnorm, clip, wd, mom, neg_lr;
};

template <bool CLIP, bool WD, bool TRACE, bool MASK>
__device__ __forceinline__ void update(float& p, float g, float& t, float m,
                                       const Step& s) {
  if (CLIP && !s.ok) g = __fmul_rn(__fdiv_rn(g, s.gnorm), s.clip);
  if (WD) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  if (TRACE) {
    g = __fadd_rn(g, __fmul_rn(s.mom, t));
    t = g;
  }
  float pn = __fadd_rn(p, __fmul_rn(s.neg_lr, g));
  if (MASK) pn = __fmul_rn(pn, m);
  p = pn;
}

template <bool CLIP, bool WD, bool TRACE, bool MASK>
__device__ __forceinline__ void update4(float4& p, const float4& g, float4& t,
                                        const float4& m, const Step& s) {
  update<CLIP, WD, TRACE, MASK>(p.x, g.x, t.x, m.x, s);
  update<CLIP, WD, TRACE, MASK>(p.y, g.y, t.y, m.y, s);
  update<CLIP, WD, TRACE, MASK>(p.z, g.z, t.z, m.z, s);
  update<CLIP, WD, TRACE, MASK>(p.w, g.w, t.w, m.w, s);
}

// scal: [ok, gnorm] (read under CLIP only); lr: the lr on the device, or
// null for h.lr
template <bool CLIP, bool WD, bool TRACE, bool MASK>
__global__ void __launch_bounds__(THREADS)
fused_sgd_apply_kernel(const __grid_constant__ Table tab, const Hyper h,
                       const float* __restrict__ scal,
                       const float* __restrict__ lr) {
  Step s;
  s.ok = CLIP ? scal[0] > 0.5f : true;
  s.gnorm = CLIP ? scal[1] : 1.f;
  s.clip = h.clip;
  s.wd = h.wd;
  s.mom = h.mom;
  s.neg_lr = -(lr != nullptr ? *lr : h.lr);
  const int tid = threadIdx.x;
  for (int c = blockIdx.x; c < tab.nchunks; c += gridDim.x) {
    const Leaf& L = tab.leaf[leaf_of(tab, c)];
    const long long off = (long long)(c - L.first) * CHUNK;
    const int len = (int)min((long long)CHUNK, L.n - off);
    float* p = L.p + off;
    const float* g = L.g + off;
    float* t = TRACE ? L.t + off : nullptr;
    const float* m = MASK ? L.m + off : nullptr;
    uintptr_t bits = (uintptr_t)L.p | (uintptr_t)L.g;
    if (TRACE) bits |= (uintptr_t)L.t;
    if (MASK) bits |= (uintptr_t)L.m;
    if (aligned16(bits)) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* t4 = reinterpret_cast<float4*>(t);
      const float4* m4 = reinterpret_cast<const float4*>(m);
      const int n4 = len >> 2;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 pv[ITEMS], gv[ITEMS], tv[ITEMS], mv[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {  // every load of the chunk in flight
        const int i = tid + k * THREADS;
        pv[k] = gv[k] = tv[k] = mv[k] = zero;
        if (i < n4) {
          pv[k] = p4[i];
          gv[k] = __ldg(&g4[i]);
          if (TRACE) tv[k] = t4[i];
          if (MASK) mv[k] = __ldg(&m4[i]);
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = tid + k * THREADS;
        if (i < n4) {
          update4<CLIP, WD, TRACE, MASK>(pv[k], gv[k], tv[k], mv[k], s);
          p4[i] = pv[k];
          if (TRACE) t4[i] = tv[k];
        }
      }
      const int i = (n4 << 2) + tid;  // the last n % 4 elements of a leaf
      if (i < len) {
        float tt = TRACE ? t[i] : 0.f;
        update<CLIP, WD, TRACE, MASK>(p[i], g[i], tt, MASK ? m[i] : 1.f, s);
        if (TRACE) t[i] = tt;
      }
    } else {
      for (int i = tid; i < len; i += THREADS) {
        float tt = TRACE ? t[i] : 0.f;
        update<CLIP, WD, TRACE, MASK>(p[i], g[i], tt, MASK ? m[i] : 1.f, s);
        if (TRACE) t[i] = tt;
      }
    }
  }
}

using ApplyLaunch = void (*)(const Table&, const Hyper&, const float*,
                             const float*, int, cudaStream_t);

template <int F>
void launch_apply(const Table& tab, const Hyper& h, const float* scal,
                  const float* lr, int blocks, cudaStream_t s) {
  fused_sgd_apply_kernel<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0,
                         (F & 8) != 0><<<blocks, THREADS, 0, s>>>(tab, h, scal,
                                                                  lr);
}

// by the flags' bits: 1 clip, 2 wd, 4 trace, 8 mask
constexpr ApplyLaunch APPLY[16] = {
    launch_apply<0>,  launch_apply<1>,  launch_apply<2>,  launch_apply<3>,
    launch_apply<4>,  launch_apply<5>,  launch_apply<6>,  launch_apply<7>,
    launch_apply<8>,  launch_apply<9>,  launch_apply<10>, launch_apply<11>,
    launch_apply<12>, launch_apply<13>, launch_apply<14>, launch_apply<15>};

int tables_of(int nleaves) { return (nleaves + MAX_LEAVES - 1) / MAX_LEAVES; }

// Table k of the nleaves rows of the host table (as the planner of
// ops/fused_update.py made it, first chunks counted over every leaf):
// leaves [k * MAX_LEAVES, (k + 1) * MAX_LEAVES), first chunks counted from
// the table's own first chunk, as ops/fused_update.py's Plan.tables cuts
// them; false when the rows are not a valid plan.
bool fill(Table& tab, const long long* table, int nleaves, int nchunks,
          int k) {
  if (nleaves < 1 || nchunks < 0 || k < 0 || k >= tables_of(nleaves))
    return false;
  const int l0 = k * MAX_LEAVES;
  const int n = std::min(MAX_LEAVES, nleaves - l0);
  memcpy(tab.leaf, table + (size_t)l0 * LEAF_WORDS, sizeof(Leaf) * n);
  const long long c0 = tab.leaf[0].first;
  const long long c1 = l0 + n < nleaves
                           ? table[(size_t)(l0 + n) * LEAF_WORDS + 5]
                           : (long long)nchunks;
  if (c0 < 0 || c1 < c0 || c1 > nchunks) return false;
  for (int i = 0; i < n; ++i) tab.leaf[i].first -= c0;
  tab.nleaves = n;
  tab.nchunks = (int)(c1 - c0);
  return true;
}

int blocks_for(int nchunks, int max_blocks) {
  return nchunks < max_blocks ? (nchunks > 0 ? nchunks : 1) : max_blocks;
}

int apply(const Table& tab, const Hyper& h, int flags, const float* scal,
          const float* lr, int max_blocks, cudaStream_t s) {
  APPLY[flags & 15](tab, h, scal, lr, blocks_for(tab.nchunks, max_blocks), s);
  return (int)cudaGetLastError();
}

}  // namespace

// The table's layout, for the wrapper to check against its own constants.
NIDT_EXPORT int fused_sgd_layout(int* chunk, int* max_leaves,
                                 int* leaf_words) {
  *chunk = CHUNK;
  *max_leaves = MAX_LEAVES;
  *leaf_words = LEAF_WORDS;
  return 0;
}

// Blocks a launch of each kernel uses on the current device at most: one
// resident wave (of the widest apply kernel, and of the norm kernel).
NIDT_EXPORT int fused_sgd_num_blocks(int* apply_blocks, int* norm_blocks) {
  int dev = 0, sms = 0, apply_sm = 0, norm_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &apply_sm, fused_sgd_apply_kernel<true, true, true, true>, THREADS, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &norm_sm, fused_sgd_norm_kernel, THREADS, 0);
  *apply_blocks = sms * (apply_sm > 0 ? apply_sm : 1);
  *norm_blocks = sms * (norm_sm > 0 ? norm_sm : 1);
  return (int)cudaGetLastError();
}

// The apply alone under given scalars scal = [ok, gnorm, lr] on the device:
// one launch a table. table: the host table (LEAF_WORDS int64 words a leaf).
NIDT_EXPORT int fused_sgd_apply_launch(const long long* table, int nleaves,
                                       int nchunks, float clip, float wd,
                                       float momentum, int flags,
                                       const float* scal, int max_blocks,
                                       void* stream) {
  const Hyper h{clip, wd, momentum, 0.f};
  for (int k = 0; k < std::max(tables_of(nleaves), 1); ++k) {
    Table tab;
    if (!fill(tab, table, nleaves, nchunks, k))
      return (int)cudaErrorInvalidValue;
    const int err = apply(tab, h, flags, scal, scal + 2, max_blocks,
                          static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}

// One whole step: with a clip (flags & 1), every table's norm launch (the
// last one's last block finishes [ok, gnorm, lr] into scal), then every
// table's apply reading scal; without, the applies alone. lr is the lr on
// the device, or null for lr_value. work: a zeroed buffer of
// 8 + 8 * norm_blocks * tables bytes (the ticket, then the partials), left
// with its ticket zero.
NIDT_EXPORT int fused_sgd_step_launch(const long long* table, int nleaves,
                                      int nchunks, float clip, float wd,
                                      float momentum, int flags,
                                      const float* lr, float lr_value,
                                      float* scal, void* work,
                                      int apply_blocks, int norm_blocks,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{clip, wd, momentum, lr_value};
  const int ntables = std::max(tables_of(nleaves), 1);
  const float* scal_in = nullptr;
  const float* lr_in = lr;
  if (flags & 1) {
    unsigned* ticket = static_cast<unsigned*>(work);
    double* partials = static_cast<double*>(work) + 1;
    int part0 = 0;
    for (int k = 0; k < ntables; ++k) {
      Table tab;
      if (!fill(tab, table, nleaves, nchunks, k))
        return (int)cudaErrorInvalidValue;
      const int blocks = blocks_for(tab.nchunks, norm_blocks);
      fused_sgd_norm_kernel<<<blocks, THREADS, 0, s>>>(
          tab, partials, part0, k == ntables - 1, ticket, scal, h, lr);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      part0 += blocks;
    }
    scal_in = scal;
    lr_in = scal + 2;
  }
  for (int k = 0; k < ntables; ++k) {
    Table tab;
    if (!fill(tab, table, nleaves, nchunks, k))
      return (int)cudaErrorInvalidValue;
    const int err = apply(tab, h, flags, scal_in, lr_in, apply_blocks, s);
    if (err != 0) return err;
  }
  return 0;
}
