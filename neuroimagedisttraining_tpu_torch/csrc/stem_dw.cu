// Weight gradient of the stem convolution of AlexNet3D:
//   y = conv3d(x, W, stride 2, VALID), C_in = 1, kernel 5^3, C_out = 64
//   dW[kd,kh,kw,c] = sum_{b,od,oh,ow} x[b, 2od+kd, 2oh+kh, 2ow+kw] * g[b,od,oh,ow,c]
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/stemconv.py
// (_dw_pallas -> _dw_kernel), which first materialized a [128, R] tap-by-row
// patch matrix in HBM (about 2 GB at the flagship shape) and then ran a
// split-K MXU product over it. Here dW is a skinny GEMM on the tensor cores,
//   dW[128 taps (125 + 3 computed, never stored), 64 channels]
//     = sum over K = R output positions of A[tap, p] * G[p, c],
// split over K across one resident wave of blocks; nothing is materialized.
//
// Route: mma.sync.m16n8k8 .tf32, the warp-level tensor-core product, not
// wgmma. A is a stride-2 gather from the x tile, A[tap, p] = x[off(tap) +
// 2p], that no shared-memory matrix descriptor describes, so A comes from
// registers; mma.sync's per-warp fragments are a plain (row, col) map from
// the lane, which keeps the gather, the hi/lo split and the ragged masking
// simple. Its TF32 rate is below wgmma's 495 TFLOP/s; moving B to wgmma's
// shared-memory operand is left for a later change.
//
// fp32 accuracy from TF32 units (split TF32): each operand v is split into
// hi = rna_tf32(v) and lo = rna_tf32(v - hi), and the product accumulates
// lo*hi + hi*lo + hi*hi in f32 (the lo*lo term, ~2^-22 of the product, is
// dropped). A single TF32 product is off by ~2e-4 of the largest entry, too
// much for the fp32 contract (TF32 is off in the port). cvt leaves the low
// 13 bits of its result unspecified: hi is masked before v - hi. The
// tensor cores' accumulate does not round to nearest, so its chains are
// kept short (row_product) and summed on the CUDA cores. Where x holds
// TF32 values only (the slice's integer voxels) its lo part is 0 and those
// products are skipped: a first pass over x (stem_dw_xlow_kernel, 136 MB at
// the flagship shape) decides it for the whole call.
//
// Work items: one (b, od, block of NR output rows oh, tile of 64 ow). For
// fixed (b, c, od) the NR rows of g are one contiguous run of NR * OW
// floats, and one x tile of 5 x (2 NR + 3) rows serves all NR rows (one-row
// items would stage 25 x rows per row). Items are staged by the tensor
// memory accelerator into a ring of two stages (bulk copies completing on
// the stage's mbarrier): item i+1 lands while item i is multiplied.
// Tensor-map TMA cannot describe these tensors (its global strides must be
// multiples of 16 bytes: OW = 59, OH * OW = 4189 and W = 121 floats are
// not), so a copy takes the 16-byte-aligned chunks that cover a run, and
// the products read the run from its offset 0..3. Where an item spans whole
// rows (OW <= 64, the flagship) a g channel's NR rows and an x plane's XHR
// rows are one run each: 69 copies an item instead of 311, which the TMA
// unit issues one after another. Positions past OW are zeroed in the g
// fragments.
//
// 8 warps: two groups take alternate k8 steps of every row, and each warp
// holds a 64-tap x 32-channel tile (16 m16n8 tiles: 16 mma per product per
// step against 24 shared-memory loads). Each block ends with one partial
// [125, 64] (its two groups added in a fixed order); a last kernel sums the
// partials in block order. No float atomics: the result is the same bits
// on every run on a card.
//
// Layouts (checked by the Python wrapper): x [B, D, H, W] contiguous (the
// single input channel), g [B, 64, OD, OH, OW] contiguous (NCDHW, as the
// convolution's backward hands it over: one channel's OW positions are one
// row), dW [125, 64] = DHWIO, both inputs 16-byte aligned.
//
// Bound at the flagship shape (B 16, 121x145x121, R = 3,954,416 positions;
// NVIDIA H100 SXM data-sheet peaks at its 700 W limit): 1.148 GB of
// compulsory traffic take 0.343 ms at 3.35 TB/s, and each TF32 product of
// 63.27 GFLOP 0.128 ms at 495 TFLOP/s. On the slice's integer voxels x has
// no low part, two products run (0.256 ms) and bytes bound the call at
// 0.343 ms; on a general float x three run (0.383 ms) and operations bound
// it. The design answers with tensor cores for the products, two products
// instead of three where x is TF32 already, and the copies under the
// products.
#include "common.cuh"

namespace {

constexpr int KS = 5;               // kernel size per spatial dim
constexpr int TAPS = KS * KS * KS;  // 125
constexpr int CO = 64;              // output channels
constexpr int NR = 4;               // output rows oh per work item
constexpr int TW = 64;              // output positions along W per item
constexpr int GCH = TW / 4 + 1;     // 16-byte chunks of one g row slot: 64
constexpr int GRW = 4 * GCH;        // positions and the 0..3 of alignment
constexpr int GST = NR * GRW + 4;   // channel stride (20 mod 32: at most
                                    // 2-way bank conflicts on B)
constexpr int XHR = 2 * NR + 3;     // x rows along H per kd
constexpr int XROWS = KS * XHR;     // (kd, h) rows of the x tile
constexpr int XCH = (2 * TW + 3 + 3 + 3) / 4;  // chunks of an x row slot:
constexpr int XRW = 4 * XCH;        // 131 columns and the alignment (136)
constexpr int XST = XRW + 4;        // x row stride (12 mod 32, fewest bank
                                    // conflicts on the stride-2 gather)
constexpr int GSZ = CO * GST;       // floats of one stage's g tile
constexpr int STAGE = GSZ + XROWS * XST;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * STAGE * 4 + STAGES * 8;  // + barriers
constexpr int THREADS = 256;        // 8 warps: 2 k groups x 2 along taps
                                    // x 2 along channels
static_assert(GST % 4 == 0 && XST % 4 == 0 && GSZ % 4 == 0, "16-byte slots");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(CO * NR <= THREADS, "at most one g row slot per thread");
static_assert(XROWS <= THREADS, "one x row slot per thread");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src (16-byte aligned) to dst, of which the first `bytes`
// are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// bytes of the `cap`-byte run at float index q that lie inside [0, total)
__device__ __forceinline__ int run_bytes(long long q, long long total,
                                         int cap) {
  return q >= total ? 0 : (int)min((long long)cap, (total - q) * 4);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival on bar, and `bytes` more for its phase to wait for
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival on bar once this thread's cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{ .reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned) by
// the tensor memory accelerator, completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// v rounded to TF32, as a float with the 13 low mantissa bits zero: cvt
// leaves those bits unspecified (the tensor cores ignore them), and the
// split v - hi needs them cleared
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// the TF32 remainder of v above its high part hi (its own low bits are left
// as cvt gives them: the tensor cores ignore them)
__device__ __forceinline__ unsigned tf32_low(float v, unsigned hi) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v - __uint_as_float(hi)));
  return r;
}

// d += a * b for one m16n8k8 TF32 tile (f32 accumulate)
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Item {
  int b, od, oh0, ow0, nrows, np;
};

__device__ __forceinline__ Item decode(long long it, int OD, int OH, int OW) {
  const int nwt = (OW + TW - 1) / TW;
  const int nhb = (OH + NR - 1) / NR;
  Item m;
  const int wt = (int)(it % nwt);
  long long r = it / nwt;
  const int hb = (int)(r % nhb);
  r /= nhb;
  m.od = (int)(r % OD);
  m.b = (int)(r / OD);
  m.oh0 = hb * NR;
  m.ow0 = wt * TW;
  m.nrows = min(NR, OH - m.oh0);
  m.np = min(TW, OW - m.ow0);
  return m;
}

// Start the copies of one item into one stage; they complete on bar. A
// copy moves the 16-byte-aligned chunks that cover a run, which starts
// 0..3 floats into its slot (its alignment, recomputed where the products
// read it). With RUN (the item spans whole rows: OW <= 64) the NR rows of a
// g channel, and the XHR rows of an x plane, are one run in memory: thread
// c < 64 copies channel c's rows, threads 64..68 one x plane each (69
// copies an item). Else each row is its own run: thread t copies g row
// (c, r) = (t / NR, t % NR) and, for t < XROWS, x row t. A copy stops at
// the end of its tensor; where x ends inside a 16-byte chunk (a batch of
// odd size) that chunk goes by cp.async, zero-filled. Values past the end
// of a row are the next row's, which only meet zeroed g (positions past
// OW) or rows past OH, which are never multiplied. Two arrivals per thread:
// one with the bytes of its bulk copies, one when its cp.async copies land.
template <bool RUN>
__device__ __forceinline__ void issue_item(float* st, unsigned long long* bar,
                                           const Item& m,
                                           const float* __restrict__ x,
                                           const float* __restrict__ g, int B,
                                           int D, int H, int W, int OD,
                                           int OH, int OW, int tid) {
  float* gs = st;
  float* xs = st + GSZ;
  float* gd = nullptr;
  float* xd = nullptr;
  long long gq = 0, xq = 0;
  int gn = 0, xn = 0, xtail = 0;
  // g holds 64 channels: its size is a multiple of 16 bytes
  const long long gtotal = (long long)B * CO * OD * OH * OW;
  const long long xtotal = (long long)B * D * H * W;
  if (RUN ? tid < CO : tid < CO * NR) {
    const int c = RUN ? tid : tid / NR, r = RUN ? 0 : tid % NR;
    const long long start = (((long long)m.b * CO + c) * OD + m.od) * OH * OW +
                            (long long)(m.oh0 + r) * OW + m.ow0;
    gq = start & ~3ll;
    // RUN: rows at OW apart, each read up to 64 positions
    const int len = RUN ? (int)(start & 3) + (NR - 1) * OW + TW : GRW;
    gn = run_bytes(gq, gtotal, (len + 3) / 4 * 16);
    gd = gs + c * GST + r * GRW;
  }
  const int xt = RUN ? tid - CO : tid;  // x run of this thread
  if (xt >= 0 && xt < (RUN ? KS : XROWS)) {
    const int kd = RUN ? xt : xt / XHR;
    const int hr = RUN ? 0 : xt - kd * XHR;
    const long long start =
        (((long long)m.b * D + 2 * m.od + kd) * H + 2 * m.oh0 + hr) * W +
        2 * m.ow0;
    xq = start & ~3ll;
    // RUN: rows at W apart, each read up to its column 2 * 63 + 4
    const int len = RUN ? (int)(start & 3) + (XHR - 1) * W + XRW - 3 : XRW;
    const int n = run_bytes(xq, xtotal, (len + 3) / 4 * 16);
    xn = n & ~15;
    xtail = n - xn;
    xd = xs + (kd * XHR + hr) * XST;
  }
  mbar_arrive_expect(bar, gn + xn);
  if (gn) bulk_copy(gd, g + gq, gn, bar);
  if (xn) bulk_copy(xd, x + xq, xn, bar);
  if (xtail) cp_async16(xd + xn / 4, x + xq + xn / 4, xtail);
  mbar_arrive_cp_async(bar);
}

// flags[block] = 1 where the block finds an x value that is not a TF32
// value (low 13 mantissa bits not all 0), else 0: with none anywhere (the
// slice's integer voxels) the products skip x's low part.
__global__ void stem_dw_xlow_kernel(const float* __restrict__ x, long long n,
                                    int* __restrict__ flags) {
  int inexact = 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long n4 = n >> 2;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(&x4[i]);
    inexact |= ((__float_as_uint(v.x) | __float_as_uint(v.y) |
                 __float_as_uint(v.z) | __float_as_uint(v.w)) &
                0x1fffu) != 0u;
  }
  if (blockIdx.x == 0 && threadIdx.x < (int)(n & 3))
    inexact |= (__float_as_uint(__ldg(&x[(n4 << 2) + threadIdx.x])) &
                0x1fffu) != 0u;
  inexact = __syncthreads_or(inexact);
  if (threadIdx.x == 0) flags[blockIdx.x] = inexact;
}

// tot += the product of one row r of the stage over this warp's 64 taps x 32
// channels and its k8 steps kq = kg, kg + 2, ... With XLO false x is TF32
// already: its low part and the products with it are skipped.
// xa: this row's x-tile offset of each fragment row (tap); ga: its g-tile
// offset of each fragment column (channel); np: valid positions.
template <bool XLO>
__device__ __forceinline__ void row_product(float (&tot)[4][4][4],
                                            const float* xs, const float* gs,
                                            const int (&xa)[4][2],
                                            const int (&ga)[4], int np,
                                            int kg, int tig) {
  // The tensor cores' f32 accumulate does not round to nearest: over a
  // chain of thousands of adds its error builds up one way (2e-4 of the
  // largest entry at the flagship shape, as much as a single TF32
  // product). So a chain is one row of one item (at most 12 adds), and the
  // rows are summed into tot by CUDA-core adds, rounded to nearest.
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  const int nkw = (np + 7) / 8;  // k8 steps holding a valid position
  // unrolled, so that the next step's shared-memory loads issue under this
  // step's products (4 steps a row at the flagship shape)
#pragma unroll 4
  for (int kq = kg; kq < nkw; kq += 2) {
    const int w = kq * 8 + tig;  // this lane's positions: w and w + 4
    unsigned ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* gp = gs + ga[nt] + w;
      float v[2] = {gp[0], gp[4]};
      if (w + 4 >= np) {  // the row's ragged end: the slot holds the next row
        v[0] = w < np ? v[0] : 0.f;
        v[1] = w + 4 < np ? v[1] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bh[nt][q] = tf32_rna(v[q]);
        bl[nt][q] = tf32_low(v[q], bh[nt][q]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float v[4] = {xs[xa[mt][0] + 2 * w], xs[xa[mt][1] + 2 * w],
                          xs[xa[mt][0] + 2 * w + 8],
                          xs[xa[mt][1] + 2 * w + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (XLO) {
          ah[mt][q] = tf32_rna(v[q]);
          al[mt][q] = tf32_low(v[q], ah[mt][q]);
        } else {
          ah[mt][q] = __float_as_uint(v[q]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (XLO) mma_tf32(acc[mt][nt], al[mt], bh[nt]);  // small terms first
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[mt][nt][q] += acc[mt][nt][q];
}

template <bool RUN>
__global__ void __launch_bounds__(THREADS, 1)
stem_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       const int* __restrict__ xlow_flags, int nflags,
                       float* __restrict__ part, int B, int D, int H, int W,
                       int OD, int OH, int OW) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1;         // taps wm*64 .. wm*64+63
  const int wn = (warp >> 1) & 1;  // channels wn*32 .. wn*32+31
  const int kg = warp >> 2;        // k8 steps kq = kg, kg + 2, ...

  // Of the fragment rows this lane reads ([m tile][row half]): the x-tile
  // offset of the tap (row 0), and its offset in x mod 2^32 (for the
  // alignment of the run it reads; RUN: of its plane's run).
  int xo0[4][2];
  unsigned xg0[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = wm * 64 + mt * 16 + hf * 8 + gid;
      const int t = tap < TAPS ? tap : 0;  // taps 125..127: never stored
      const int kd = t / (KS * KS), kh = (t / KS) % KS, kw = t % KS;
      xo0[mt][hf] = RUN ? kd * XHR * XST + kh * W + kw
                        : (kd * XHR + kh) * XST + kw;
      xg0[mt][hf] = RUN ? (unsigned)kd * H * W : ((unsigned)kd * H + kh) * W;
    }
  // the same for the fragment column (channel) of each n tile
  int go0[4];
  unsigned gg0[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = wn * 32 + nt * 8 + gid;
    go0[nt] = c * GST;
    gg0[nt] = (unsigned)c * OD * OH * OW;
  }

  float tot[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[mt][nt][q] = 0.f;

  // Two stages, each with a barrier that completes when its item's copies
  // have landed. Slots no copy reaches (past the end of a tensor) read as
  // the zeros written here, or as values of an earlier item: finite, and
  // only ever multiplied by zeroed g.
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + STAGES * STAGE);
  for (int e = tid; e < STAGES * STAGE; e += THREADS) smem[e] = 0.f;
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) mbar_init(&bar[k], 2 * THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  int inexact = 0;
  for (int e = tid; e < nflags; e += THREADS) inexact |= xlow_flags[e];
  const bool xlo = __syncthreads_or(inexact);  // x has a low part somewhere

  const long long items = (long long)B * OD * ((OH + NR - 1) / NR) *
                          ((OW + TW - 1) / TW);
  for (int k = 0; k < STAGES; ++k) {
    const long long it = blockIdx.x + (long long)k * gridDim.x;
    if (it < items)
      issue_item<RUN>(smem + k * STAGE, &bar[k], decode(it, OD, OH, OW), x,
                      g, B, D, H, W, OD, OH, OW, tid);
  }
  long long it = blockIdx.x;
  for (int i = 0; it < items; ++i, it += gridDim.x) {
    const int st = i % STAGES;
    mbar_wait(&bar[st], (i / STAGES) & 1);  // this item's copies landed
    const Item m = decode(it, OD, OH, OW);
    float* gs = smem + st * STAGE;
    const float* xs = gs + GSZ;
    // the item's first x row and g row in memory, mod 2^32
    const unsigned xg = (((unsigned)m.b * D + 2 * m.od) * H + 2 * m.oh0) * W +
                        2 * m.ow0;
    const unsigned gg = ((unsigned)m.b * CO * OD + m.od) * OH * OW +
                        (unsigned)m.oh0 * OW + m.ow0;
    for (int r = 0; r < m.nrows; ++r) {
      int xa[4][2], ga[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          xa[mt][hf] =
              RUN ? xo0[mt][hf] + 2 * r * W +
                        (int)((xg + xg0[mt][hf]) & 3u)
                  : xo0[mt][hf] + 2 * r * XST +
                        (int)((xg + xg0[mt][hf] + 2u * r * W) & 3u);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ga[nt] = RUN ? go0[nt] + r * OW + (int)((gg + gg0[nt]) & 3u)
                     : go0[nt] + r * GRW + (int)((gg + gg0[nt] + r * OW) & 3u);
      if (xlo)
        row_product<true>(tot, xs, gs, xa, ga, m.np, kg, tig);
      else
        row_product<false>(tot, xs, gs, xa, ga, m.np, kg, tig);
    }
    __syncthreads();  // every read of this stage is done: refill it
    const long long nxt = it + (long long)STAGES * gridDim.x;
    if (nxt < items)
      issue_item<RUN>(gs, &bar[st], decode(nxt, OD, OH, OW), x, g, B, D, H, W,
                      OD, OH, OW, tid);
  }

  // the two k groups' sums, added in a fixed order through shared memory
  // (no copy is in flight: every item issued was waited for)
  float* red = smem;
  if (kg == 1) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int tap = wm * 64 + mt * 16 + hf * 8 + gid;
          *reinterpret_cast<float2*>(&red[tap * CO + wn * 32 + nt * 8 +
                                          2 * tig]) =
              make_float2(tot[mt][nt][2 * hf], tot[mt][nt][2 * hf + 1]);
        }
  }
  __syncthreads();
  if (kg == 1) return;
  // fragment (row gid / gid + 8, columns 2 tig, 2 tig + 1) of each tile
  float* out = part + (long long)blockIdx.x * TAPS * CO;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = wm * 64 + mt * 16 + hf * 8 + gid;
      if (tap < TAPS) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int e = tap * CO + wn * 32 + nt * 8 + 2 * tig;
          const float2 o = *reinterpret_cast<const float2*>(&red[e]);
          *reinterpret_cast<float2*>(&out[e]) =
              make_float2(tot[mt][nt][2 * hf] + o.x,
                          tot[mt][nt][2 * hf + 1] + o.y);
        }
      }
    }
}

// dW[e] = sum over partials in block order (fixed order: deterministic).
__global__ void stem_dw_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dw, int nparts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= TAPS * CO) return;
  const long long stride = (long long)TAPS * CO;
  float s = 0.f;
  int k = 0;
  for (; k + 8 <= nparts; k += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(k + u) * stride + e];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; k < nparts; ++k) s += part[k * stride + e];
  dw[e] = s;
}

cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      stem_dw_partial_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stem_dw_partial_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

}  // namespace

// Number of partial blocks the launch uses on the current device (one
// resident wave at the kernel's dynamic shared memory); the wrapper
// allocates part[nparts, 125, 64].
NIDT_EXPORT int stem_dw_num_parts(int* nparts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_dw_partial_kernel<false>, THREADS, SMEM_BYTES);
  *nparts = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaGetLastError();
}

// part holds nparts partials [125, 64] and then nparts ints (the x
// low-part flags); 3 launches.
NIDT_EXPORT int stem_dw_launch(const float* x, const float* g, float* part,
                               float* dw, int nparts, int B, int D, int H,
                               int W, int OD, int OH, int OW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  int* flags = reinterpret_cast<int*>(part + (long long)nparts * TAPS * CO);
  stem_dw_xlow_kernel<<<nparts, THREADS, 0, s>>>(x, (long long)B * D * H * W,
                                                 flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (OW <= TW)  // an item spans whole rows: one copy per channel, per plane
    stem_dw_partial_kernel<true><<<nparts, THREADS, SMEM_BYTES, s>>>(
        x, g, flags, nparts, part, B, D, H, W, OD, OH, OW);
  else
    stem_dw_partial_kernel<false><<<nparts, THREADS, SMEM_BYTES, s>>>(
        x, g, flags, nparts, part, B, D, H, W, OD, OH, OW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_dw_reduce_kernel<<<(TAPS * CO + 255) / 256, 256, 0, s>>>(part, dw,
                                                                nparts);
  return (int)cudaGetLastError();
}
