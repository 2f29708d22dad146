// Weight gradient of the stem convolution of the AlexNet3D family in
// bfloat16 (the training step under --precision bf16_mixed):
//   y = conv3d(x, W, stride 2, VALID), C_in = 1, kernel 5^3, C_out = 64
//   dW[kd,kh,kw,c] = sum_{b,od,oh,ow} x[b, 2od+kd, 2oh+kh, 2ow+kw] * g[b,od,oh,ow,c]
// with x and g in bfloat16 and the sum in float32; the wrapper rounds dW to
// the bfloat16 weight.
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/stemconv.py
// (_dw_pallas -> _dw_kernel) where it runs in the training compute dtype:
// bf16 x and g, products accumulated in f32, dW cast to the bf16 weight
// (its _bwd). dW is a skinny GEMM
//   dW[128 taps (125 + 3 computed, never stored), 64 channels]
//     = sum over K = R output positions of A[tap, p] * G[p, c],
// split over K across one persistent block per SM; nothing is
// materialized. A bf16 x bf16 product is exact in f32 and the uint8 voxels
// are exact in bf16, so one product on the tensor cores is the whole sum.
//
// Bound at the flagship shape (B 16, 121x145x121; NVIDIA H100 SXM
// data-sheet peaks at its 700 W limit): x 67.9 MB + g 506.2 MB = 574.1 MB
// of compulsory traffic take 0.171 ms at 3.35 TB/s; the 63.27 GFLOP take
// 0.064 ms at 989 TFLOP/s dense bf16. Bytes bound it. The mma.sync design
// this one replaces spent 0.60 ms of its 0.82 on the issue slots of its
// operand loads, and overlapped its copies with them by 0.07 ms. Here:
//
// - A warp-specialised pipeline, one persistent block per SM. In the
//   producer warpgroup one thread keeps TMA copies in flight into a ring of
//   3 stages of one work item each (full and empty mbarriers a stage), and
//   3 warps rewrite each stage's g into a ring of 2 tiles of wgmma's B
//   layout (their own full and empty mbarriers); two consumer warpgroups
//   multiply. The producer warpgroup gives registers back (setmaxnreg), and
//   no role waits on a block-wide barrier.
// - g by the tensor memory accelerator. A channel's run starts 0..7
//   elements into a 16-byte chunk, and the offset differs from channel to
//   channel (OD OH OW = 247,151 = 7 mod 8), so no map lands the runs
//   straight in wgmma's K-major 128B-swizzled B layout: a box whose first
//   element is not 16-byte aligned is an illegal instruction on the card
//   (measured; design (a), a rank-1 map of 64-element boxes, is out).
//   Channels r, r + 8, .., r + 56 are 8 OD OH OW elements apart, a multiple
//   of 16 bytes, and share one offset: a 3-D map {elements of a row, rows,
//   8 channels} fetches all 8 runs in one box from the row holding channel
//   r's start, 8 boxes an item (64 bulk copies an item measured 0.33 ms for
//   the feed alone). Rows are 64 bytes (16-byte rows measured 0.35 ms);
//   where such a box would pass the map's last row, a second map of
//   16-byte rows reaches g's last element. Then design (b): the rewrite
//   warps move each staged run into the swizzled tile, 16 bytes a thread
//   at a time (five 32-bit reads, a funnel shift by the run's offset, one
//   16-byte write), zeros past each output row. The producer passes each
//   box's run start and channel stride to them in shared memory.
// - x by cp.async.bulk: for fixed (b, d) an item's x rows are one
//   contiguous run, 5 copies an item (the 16-byte chunks that cover it;
//   the last elements of x, where its size is not a multiple of 16 bytes,
//   by plain loads of the producer before it arrives).
// - wgmma.mma_async.m64n64k16 .f32.bf16.bf16: A from registers, B from the
//   tile through a matrix descriptor. A is the stride-2 gather A[tap, p] =
//   x[off(tap) + 2 off(p)], which no shared-memory descriptor describes.
//   K is laid out by output row, each row in whole boxes of 64 positions
//   (its columns past OW zero), so a lane's positions in a k16 step sit at
//   offsets fixed at compile time from one base a row: its m16 fragment is
//   8 16-bit loads with immediate offsets a step, no address arithmetic.
//   A warp issues 8 operand loads a 16x64x16 product, against 32 for 8
//   mma.sync in the design before, and no B loads at all.
//
// Work items: one (b, od, block of NR output rows oh); each row takes BPR
// = ceil(OW / 64) boxes (a template parameter), an item 4 / BPR rows, 4
// boxes (at OW = 59: 4 rows of 59 in 4 boxes of 64). For fixed (b, c, od)
// the NR rows of g are one contiguous run. The wrapper picks NR
// (ops/stemconv.py bf16_plan) and refuses what no NR fits. Every item
// multiplies its 4 boxes; positions past the run are zero in A and in B.
//
// Chains: the tensor cores' f32 accumulate does not round to nearest, so a
// chain is one box, 4 k16 steps (the length the float64 check of the
// design before was held at): its first product starts with scale-d = 0,
// and the chain is added to the totals on the CUDA cores after
// wgmma.wait_group; the next chain's operands load while it multiplies.
// Each block writes one partial [125, 64]; a second kernel sums the
// partials in block order. No float atomics: the result is the same bits
// on every run on a card.
//
// What sets the pace (measured at the flagship shape): the rewrite and the
// products share the SM's shared-memory and issue bandwidth and overlap
// badly (0.43 ms together, 0.30 the products alone), while the feed alone
// takes 0.27 ms and hides under them; see PERF.md.
//
// Layouts (checked by the Python wrapper): x [B, D, H, W] contiguous bf16,
// g [B, 64, OD, OH, OW] contiguous bf16 (NCDHW, as the convolution's
// backward hands it over), dW [125, 64] f32 (DHWIO), both inputs 16-byte
// aligned.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int KS = 5;               // kernel size per spatial dim
constexpr int TAPS = KS * KS * KS;  // 125
constexpr int CO = 64;              // output channels
constexpr int BOX = 64;             // positions of one B box (128 bytes)
constexpr int KCAP = 256;           // positions of one item at most
constexpr int NBOX = KCAP / BOX;    // boxes (chains) an item
constexpr int BTILE = CO * BOX * 2;  // bytes of one box of every channel
constexpr int TILE = NBOX * BTILE;   // one item's swizzled B: 32 KB
constexpr int TILES = 2;
// g's two tensor maps: rows of GEA elements (64 bytes), and for the boxes
// that would pass the end of the first map's rows, rows of GEB (16 bytes)
constexpr int GEA = 32, GEB = 8, GEA_LOG = 5, GEB_LOG = 3;
static_assert(GEA == 1 << GEA_LOG && GEB == 1 << GEB_LOG, "powers of two");
constexpr int rows_of(int ge) { return (ge - 1 + KCAP + ge - 1) / ge; }
constexpr int max_i(int a, int b) { return a > b ? a : b; }
// bytes of one box slot (8 channels' runs) of a stage
constexpr int GSLOT = max_i(GEA * rows_of(GEA), GEB * rows_of(GEB)) * 8 * 2;
constexpr int GSTAGE = 8 * GSLOT;  // bytes of a stage's staged g
constexpr int XPL = 1728;          // elements of one x plane slot
constexpr int STAGE = GSTAGE + KS * XPL * 2;  // staged g, then 5 x planes
constexpr int STAGES = 3;
constexpr int META = 16;       // ints a stage: each box's run start, stride
constexpr int SMEM_BYTES = 1024 + TILES * TILE + STAGES * STAGE +
                           2 * (STAGES + TILES) * 8 +
                           STAGES * META * 4;  // + align, barriers, meta
constexpr int CONSUMERS = 256;  // two warpgroups: taps 0-63, 64-127
constexpr int REWRITERS = 96;   // warps 9-11
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int TMAP_ERR = 100000;  // + CUresult of cuTensorMapEncodeTiled
static_assert(XPL % 8 == 0 && STAGE % 128 == 0 && GSLOT % 128 == 0,
              "16-byte x slots, 128-byte aligned boxes");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

typedef unsigned short bf16_t;  // raw bits

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival on bar, and `bytes` more for its phase to wait for
__device__ __forceinline__ void mbar_arrive_expect(unsigned bar,
                                                   unsigned bytes) {
  asm volatile(
      "{ .reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1; }\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{ .reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0]; }\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{ .reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p; }\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` of bar has completed; a wait of more
// than 2^35 cycles (over 17 s) traps, so that a lost arrival ends the
// launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
}

// a bulk copy of `bytes` (a multiple of 16; both ends 16-byte aligned) by
// the tensor memory accelerator, completing on bar
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box {GE, rows, 8 channels} of a map of g from row `row`, completing
// on bar
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map,
                                        int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %2}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(row),
      "r"(bar)
      : "memory");
}

// K-major B operand with the 128-byte swizzle: rows (channels) of 128
// bytes, 8-row groups 1024 bytes apart; the leading offset is unused
__device__ __forceinline__ unsigned long long b_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a * b (scale_d 0) or d += a * b (scale_d 1) for this warpgroup's
// 64 x 64 x 16 tile: a this lane's m16 fragment, b a descriptor
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4],
                                         unsigned long long b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ unsigned pack(bf16_t lo, bf16_t hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

struct Item {
  int b, od, oh0, nrows;
};

__device__ __forceinline__ Item decode(unsigned it, int OD, int OH, int NR,
                                       int nhb) {
  Item m;
  const unsigned r = it / (unsigned)nhb;
  m.oh0 = (int)(it - r * nhb) * NR;
  m.b = (int)(r / (unsigned)OD);
  m.od = (int)(r - (unsigned)m.b * OD);
  m.nrows = min(NR, OH - m.oh0);
  return m;
}

// This lane's A fragment of k16 step S of an item whose output rows take
// BPR boxes (64 positions) each: row r = S / (4 BPR), columns c = c0 + 2 tig
// + {0, 1, 8, 9} with c0 = 16 (S mod 4 BPR). Rows (taps) t0 = gid and t1 =
// gid + 8 read from their row bases x0[r], x1[r] (which hold 4 tig) at
// offsets known here: 2 c0 + {0, 2, 16, 18} elements. Columns at OW or past
// it, and rows past the item's, are zero.
template <int BPR, int S>
__device__ __forceinline__ void a_frag(unsigned (&a)[4],
                                       const bf16_t* const (&x0)[4],
                                       const bf16_t* const (&x1)[4], int tig,
                                       int OW, int nrows) {
  constexpr int r = S / (4 * BPR), c0 = 16 * (S % (4 * BPR));
  const bf16_t* p0 = x0[r] + 2 * c0;
  const bf16_t* p1 = x1[r] + 2 * c0;
  bf16_t v[8] = {p0[0], p0[2], p1[0], p1[2], p0[16], p0[18], p1[16], p1[18]};
  if (r >= nrows) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0;
  } else if (c0 + 16 > OW) {  // the row's end
    const int c = c0 + 2 * tig;
    if (c >= OW) v[0] = v[2] = 0;
    if (c + 1 >= OW) v[1] = v[3] = 0;
    if (c + 8 >= OW) v[4] = v[6] = 0;
    if (c + 9 >= OW) v[5] = v[7] = 0;
  }
  a[0] = pack(v[0], v[1]);
  a[1] = pack(v[2], v[3]);
  a[2] = pack(v[4], v[5]);
  a[3] = pack(v[6], v[7]);
}

// This lane's A fragments of chain (box) J: its 4 k16 steps.
template <int BPR, int J>
__device__ __forceinline__ void build(unsigned (&a)[4][4],
                                      const bf16_t* const (&x0)[4],
                                      const bf16_t* const (&x1)[4], int tig,
                                      int OW, int nrows) {
  a_frag<BPR, 4 * J + 0>(a[0], x0, x1, tig, OW, nrows);
  a_frag<BPR, 4 * J + 1>(a[1], x0, x1, tig, OW, nrows);
  a_frag<BPR, 4 * J + 2>(a[2], x0, x1, tig, OW, nrows);
  a_frag<BPR, 4 * J + 3>(a[3], x0, x1, tig, OW, nrows);
}

// Chain J's products into acc, the first overwriting it; committed as one
// group.
template <int J>
__device__ __forceinline__ void multiply(float (&acc)[32],
                                         const unsigned (&a)[4][4],
                                         unsigned tile_s) {
  wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_rs(acc, a[s], b_desc(tile_s + J * BTILE + 32 * s), s > 0);
  wgmma_commit();
}

// tot += acc once the chain in flight has landed
__device__ __forceinline__ void land(float (&tot)[32], float (&acc)[32]) {
  wgmma_wait_all();
  fence_acc(acc);
#pragma unroll
  for (int e = 0; e < 32; ++e) tot[e] += acc[e];
}

// BPR: boxes of 64 positions an output row takes (OW <= 64 BPR); an item is
// 4 / BPR output rows.
template <int BPR>
__global__ void __launch_bounds__(THREADS, 1)
stem_dw_bf16_partial_kernel(const __grid_constant__ CUtensorMap gmap_a,
                            const __grid_constant__ CUtensorMap gmap_b,
                            const bf16_t* __restrict__ x,
                            float* __restrict__ part, int B, int D, int H,
                            int W, int OD, int OH, int OW, int NR, int gra,
                            int grb, long long rows_a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern follows address bits 4-9: tiles start 1024-aligned
  const unsigned raw_s = smem_addr(smem_raw);
  const unsigned base_s = (raw_s + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (base_s - raw_s);
  const unsigned stage_s = base_s + TILES * TILE;
  const unsigned full_s = stage_s + STAGES * STAGE;
  const unsigned empty_s = full_s + STAGES * 8;
  const unsigned bfull_s = empty_s + STAGES * 8;
  const unsigned bempty_s = bfull_s + TILES * 8;
  int* meta = reinterpret_cast<int*>(base + (bempty_s + TILES * 8 - base_s));
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_s + 8 * s, 1);  // the producer
      mbar_init(empty_s + 8 * s, (CONSUMERS + REWRITERS) / 32);
    }
    for (int t = 0; t < TILES; ++t) {
      mbar_init(bfull_s + 8 * t, REWRITERS / 32);
      mbar_init(bempty_s + 8 * t, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nhb = (OH + NR - 1) / NR;
  const unsigned items = (unsigned)B * OD * nhb;

  if (warp >= CONSUMERS / 32) {
    // ---- the producer warpgroup gives its registers to the consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    if (warp == CONSUMERS / 32) {
      if (lane != 0) return;
      // ---- producer: one thread copies an item into a stage ----
      const long long xtotal = (long long)B * D * H * W;
      const long long hw = (long long)H * W;
      const long long ohw = (long long)OH * OW;
      unsigned i = 0;
      for (unsigned it = blockIdx.x; it < items; it += gridDim.x, ++i) {
        const int st = (int)(i % STAGES);
        const unsigned full = full_s + 8 * st;
        mbar_wait(empty_s + 8 * st, ((i / STAGES) & 1) ^ 1u);
        const Item m = decode(it, OD, OH, NR, nhb);
        const unsigned gst = stage_s + st * STAGE;
        const unsigned xst = gst + GSTAGE;
        // x plane kd: rows 2 oh0 .. 2 oh0 + 2 nrows + 2 of (b, 2 od + kd),
        // from the 16-byte chunk holding its first element
        const long long x0 =
            (((long long)m.b * D + 2 * m.od) * H + 2 * m.oh0) * W;
        const int xn = (2 * m.nrows + 3) * W;
        long long xq[KS];
        int xb[KS];
        unsigned bytes = 0;
#pragma unroll
        for (int kd = 0; kd < KS; ++kd) {
          const long long start = x0 + kd * hw;
          xq[kd] = start & ~7ll;
          const long long n = ((start - xq[kd]) + xn + 7) & ~7ll;
          const long long in = min(n, xtotal - xq[kd]);
          xb[kd] = (int)(in & ~7ll);
          // the last elements of x, inside a 16-byte chunk that passes
          // its end: plain loads, before the arrival that publishes them
          bf16_t* dst = reinterpret_cast<bf16_t*>(base + (xst - base_s)) +
                        kd * XPL;
          for (int t = xb[kd]; t < (int)in; ++t) dst[t] = x[xq[kd] + t];
          bytes += 2u * xb[kd];
        }
        // g: channels r, r + 8, .., r + 56 are 8 OD OH OW elements apart
        // (a multiple of 16 bytes), so their runs sit at one offset from
        // one row of a map: one box of 8 channels for each r, by the map of
        // 64-byte rows unless the box would pass its last row. The rewrite
        // reads each box's first run start and its channel stride here.
        const long long g0 =
            ((long long)m.b * CO * OD + m.od) * ohw + (long long)m.oh0 * OW;
        int* mt = meta + st * META;
        long long row[8];
        bool by_a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const long long start = g0 + (long long)r * OD * ohw;
          by_a[r] = (start >> GEA_LOG) + gra <= rows_a;
          const int sh = by_a[r] ? GEA_LOG : GEB_LOG;  // no 64-bit divide
          row[r] = start >> sh;
          mt[r] = r * (GSLOT / 2) + (int)(start & ((1 << sh) - 1));
          mt[8 + r] = by_a[r] ? GEA * gra : GEB * grb;
          bytes += 16u * mt[8 + r];
        }
        mbar_arrive_expect(full, bytes);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          tma_box(gst + r * GSLOT, by_a[r] ? &gmap_a : &gmap_b, (int)row[r],
                  full);
#pragma unroll
        for (int kd = 0; kd < KS; ++kd)
          if (xb[kd])
            bulk_copy(xst + kd * XPL * 2, x + xq[kd], 2u * xb[kd], full);
      }
    } else {
      // ---- rewrite warps: a stage's g into a tile of wgmma's B layout ----
      const int rt = tid - CONSUMERS - 32;
      unsigned i = 0;
      for (unsigned it = blockIdx.x; it < items; it += gridDim.x, ++i) {
        const int st = (int)(i % STAGES), bt = (int)(i % TILES);
        mbar_wait(full_s + 8 * st, (i / STAGES) & 1);
        mbar_wait(bempty_s + 8 * bt, ((i / TILES) & 1) ^ 1u);
        const Item m = decode(it, OD, OH, NR, nhb);
        const unsigned* sw =
            reinterpret_cast<const unsigned*>(base + TILES * TILE +
                                              st * STAGE);
        const int* mt = meta + st * META;
        unsigned char* tile = base + bt * TILE;
        // 16 bytes a step: chunk q8 of row c of each box j (output row
        // j / BPR, its columns 64 (j % BPR) + 8 q8 ..), c = r + 8 i read
        // from box r's run i; 8 neighbouring lanes write one 128-byte row;
        // every box, zeros past the output row and past the item's rows. A
        // thread takes one (c, q8) through the 4 boxes: their reads go out
        // together.
        int jo[NBOX], end[NBOX];  // a box's offset in the run; its row's end
#pragma unroll
        for (int j = 0; j < NBOX; ++j) {
          jo[j] = (j / BPR) * OW + BOX * (j % BPR);
          end[j] = j / BPR < m.nrows ? OW : 0;
        }
        for (int pr = rt; pr < CO * 8; pr += REWRITERS) {
          const int c = pr >> 3, q8 = pr & 7;
          const int e = mt[c & 7] + (c >> 3) * mt[8 + (c & 7)] + 8 * q8;
          unsigned v[NBOX][5];
#pragma unroll
          for (int j = 0; j < NBOX; ++j) {
            const unsigned* w = sw + ((e + jo[j]) >> 1);
#pragma unroll
            for (int t = 0; t < 5; ++t) v[j][t] = w[t];
          }
          unsigned char* row = tile + c * (BOX * 2) + ((q8 ^ (c & 7)) << 4);
#pragma unroll
          for (int j = 0; j < NBOX; ++j) {
            const int col = BOX * (j % BPR) + 8 * q8;  // its first column
            const bool odd = (e + jo[j]) & 1;
            unsigned o[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              o[t] = odd ? __funnelshift_r(v[j][t], v[j][t + 1], 16) : v[j][t];
            if (col + 8 > end[j]) {
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                if (col + 2 * t >= end[j]) o[t] = 0u;
                else if (col + 2 * t + 1 >= end[j]) o[t] &= 0xffffu;
              }
            }
            *reinterpret_cast<uint4*>(row + j * BTILE) =
                make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
        // the tile is read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bfull_s + 8 * bt);
          mbar_arrive(empty_s + 8 * st);  // done with the staged g
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes taps 64 wg .. 64 wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    const int wg = warp >> 2, wq = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    // this lane's fragment rows (taps gid, gid + 8 of its warp's 16): the
    // offset of (kh, kw) in plane slot kd, and kd
    int toff[2], tkd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = wg * 64 + wq * 16 + h * 8 + gid;
      const int t = tap < TAPS ? tap : 0;  // taps 125..127: never stored
      const int kd = t / (KS * KS), kh = (t / KS) % KS, kw = t % KS;
      tkd[h] = kd;
      toff[h] = kd * XPL + kh * W + kw;
    }
    const unsigned hw32 = (unsigned)H * (unsigned)W;
    float tot[32], acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) tot[e] = acc[e] = 0.f;
    unsigned a0[4][4], a1[4][4];

    unsigned i = 0;
    for (unsigned it = blockIdx.x; it < items; it += gridDim.x, ++i) {
      const int st = (int)(i % STAGES), bt = (int)(i % TILES);
      mbar_wait(full_s + 8 * st, (i / STAGES) & 1);
      mbar_wait(bfull_s + 8 * bt, (i / TILES) & 1);
      const Item m = decode(it, OD, OH, NR, nhb);
      const unsigned tile_s = base_s + bt * TILE;
      const bf16_t* xs = reinterpret_cast<const bf16_t*>(
          base + TILES * TILE + st * STAGE + GSTAGE);
      // each plane slot starts at its run's 16-byte chunk: the run sits
      // 0..7 elements in (x's offsets mod 2^32 keep that residue)
      const unsigned x0 =
          (((unsigned)m.b * D + 2u * m.od) * H + 2u * m.oh0) * W;
      // this lane's taps at column 4 tig of each output row of the item
      const bf16_t* xr0[4];
      const bf16_t* xr1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xr0[r] = xs + toff[0] + (int)((x0 + (unsigned)tkd[0] * hw32) & 7u) +
                 2 * r * W + 4 * tig;
        xr1[r] = xs + toff[1] + (int)((x0 + (unsigned)tkd[1] * hw32) & 7u) +
                 2 * r * W + 4 * tig;
      }
      // four chains; chain j + 1's operands load while chain j multiplies
      build<BPR, 0>(a0, xr0, xr1, tig, OW, m.nrows);
      multiply<0>(acc, a0, tile_s);
      build<BPR, 1>(a1, xr0, xr1, tig, OW, m.nrows);
      land(tot, acc);
      multiply<1>(acc, a1, tile_s);
      build<BPR, 2>(a0, xr0, xr1, tig, OW, m.nrows);
      land(tot, acc);
      multiply<2>(acc, a0, tile_s);
      build<BPR, 3>(a1, xr0, xr1, tig, OW, m.nrows);
      land(tot, acc);
      multiply<3>(acc, a1, tile_s);
      land(tot, acc);
      __syncwarp();
      if (lane == 0) {  // the tile and the stage's x are free
        mbar_arrive(bempty_s + 8 * bt);
        mbar_arrive(empty_s + 8 * st);
      }
    }

    // accumulator (row gid / gid + 8, columns 8 n + 2 tig, + 1)
    float* out = part + (long long)blockIdx.x * TAPS * CO;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = wg * 64 + wq * 16 + h * 8 + gid;
      if (tap < TAPS) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(&out[tap * CO + 8 * n + 2 * tig]) =
              make_float2(tot[4 * n + 2 * h], tot[4 * n + 2 * h + 1]);
      }
    }
  }
}

// dW[e] = sum over partials in block order (fixed order: deterministic).
__global__ void stem_dw_bf16_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ dw,
                                           int nparts) {
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

// the last element of an x plane slot the A loads of an item of NR rows
// reach (padded columns included; those past the row are masked): tap (kd,
// 4, 4) at offset 0..7, the last row, lane tig 3, step offset 2 c0 + 18
int x_reach(int NR, int bpr, int W) {
  return 4 * W + 4 + 7 + 2 * (NR - 1) * W + 12 + 32 * (4 * bpr - 1) + 18 + 1;
}

template <int BPR>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(stem_dw_bf16_partial_kernel<BPR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !p)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace

// Number of partial blocks the launch uses on the current device: one
// persistent block per SM (the wrapper allocates part[nparts, 125, 64]).
NIDT_EXPORT int stem_dw_bf16_num_parts(int* nparts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = set_smem<1>();
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_dw_bf16_partial_kernel<1>, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *nparts = sms;
  return (int)cudaGetLastError();
}

// x, g bf16; part holds nparts float partials [125, 64]; dw [125, 64]
// float; NR output rows an item (the wrapper's plan); 2 launches. Returns
// a cudaError_t, or TMAP_ERR + the CUresult where g's map is refused.
NIDT_EXPORT int stem_dw_bf16_launch(const void* x, const void* g, float* part,
                                    float* dw, int nparts, int B, int D,
                                    int H, int W, int OD, int OH, int OW,
                                    int NR, void* stream) {
  const unsigned long long odhw = (unsigned long long)OD * OH * OW;
  const unsigned long long gn = (unsigned long long)B * CO * odhw;
  // rows each map addresses: every row a box of channels r..r + 56 reads
  // lies inside g (g's size and 56 odhw are multiples of 8, so the map of
  // 16-byte rows reaches g's last element)
  const unsigned long long rows_a = (gn - 56 * odhw) / GEA;
  const unsigned long long rows_b = (gn - 56 * odhw) / GEB;
  const int bpr = (OW + BOX - 1) / BOX;  // boxes an output row takes
  if (bpr < 1 || bpr > NBOX || NR < 1 || NR * bpr > NBOX ||
      (2 * NR + 3) * W + 7 > XPL || x_reach(NR, bpr, W) > XPL ||
      rows_b >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bpr == 1   ? set_smem<1>()
                    : bpr == 2 ? set_smem<2>()
                    : bpr == 3 ? set_smem<3>()
                               : set_smem<4>();
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode = nullptr;
  err = encode_fn(&encode);
  if (err != cudaSuccess) return (int)err;
  // a run of NR OW positions from 0..GE-1 elements into its first row
  const int gra = (GEA - 1 + NR * OW + GEA - 1) / GEA;
  const int grb = (GEB - 1 + NR * OW + GEB - 1) / GEB;
  CUtensorMap gmap[2];
  const int ges[2] = {GEA, GEB}, grs[2] = {gra, grb};
  const unsigned long long rows[2] = {rows_a, rows_b};
  for (int m = 0; m < 2; ++m) {
    // (a map of no rows is refused: a shape that small reads only map b)
    const cuuint64_t dims[3] = {(cuuint64_t)ges[m], rows[m] ? rows[m] : 1,
                                8};
    const cuuint64_t strides[2] = {(cuuint64_t)ges[m] * 2,
                                   8 * odhw * 2};  // bytes
    const cuuint32_t box[3] = {(cuuint32_t)ges[m], (cuuint32_t)grs[m], 8};
    const cuuint32_t estride[3] = {1, 1, 1};
    const CUresult res = encode(
        &gmap[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(g),
        dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return TMAP_ERR + (int)res;
  }
  const bf16_t* xb = static_cast<const bf16_t*>(x);
  if (bpr == 1)
    stem_dw_bf16_partial_kernel<1><<<nparts, THREADS, SMEM_BYTES, s>>>(
        gmap[0], gmap[1], xb, part, B, D, H, W, OD, OH, OW, NR, gra, grb,
        (long long)rows_a);
  else if (bpr == 2)
    stem_dw_bf16_partial_kernel<2><<<nparts, THREADS, SMEM_BYTES, s>>>(
        gmap[0], gmap[1], xb, part, B, D, H, W, OD, OH, OW, NR, gra, grb,
        (long long)rows_a);
  else if (bpr == 3)
    stem_dw_bf16_partial_kernel<3><<<nparts, THREADS, SMEM_BYTES, s>>>(
        gmap[0], gmap[1], xb, part, B, D, H, W, OD, OH, OW, NR, gra, grb,
        (long long)rows_a);
  else
    stem_dw_bf16_partial_kernel<4><<<nparts, THREADS, SMEM_BYTES, s>>>(
        gmap[0], gmap[1], xb, part, B, D, H, W, OD, OH, OW, NR, gra, grb,
        (long long)rows_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_dw_bf16_reduce_kernel<<<(TAPS * CO + 255) / 256, 256, 0, s>>>(
      part, dw, nparts);
  return (int)cudaGetLastError();
}
