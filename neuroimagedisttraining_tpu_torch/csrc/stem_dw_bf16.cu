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
// (its _bwd). As the float32 kernel (stem_dw.cu), dW is a skinny GEMM
//   dW[128 taps (125 + 3 computed, never stored), 64 channels]
//     = sum over K = R output positions of A[tap, p] * G[p, c],
// split over K across one resident wave of blocks; nothing is
// materialized. A bf16 x bf16 product is exact in f32 and the uint8 voxels
// are exact in bf16, so one product on the tensor cores is the whole sum:
// no hi/lo split.
//
// Route: mma.sync.m16n8k16 .bf16 with f32 accumulate, the warp-level
// tensor-core product. A is a stride-2 gather from the x tile, A[tap, p] =
// x[off(tap) + 2p]: a fragment register packs two bf16 that are not
// adjacent in memory, so each is read from shared memory alone and the pair
// packed in a register. B's pairs (two neighbouring positions of one
// channel) are packed the same way, since a g run may start on an odd
// element. Positions past OW are zeroed in the B fragments. The tensor
// cores' f32 accumulate does not round to nearest, so a chain is one row of
// one item (at most 4 products) and rows are summed on the CUDA cores.
//
// Work items: one (b, od, block of NR = 4 output rows oh, tile of 64 ow).
// One x tile of 5 x (2 NR + 3) rows serves all NR rows. Items are staged
// with cp.async 16-byte copies into a ring of two stages (one commit group
// an item): item i+1 lands while item i is multiplied. A run of bf16 sits
// 0..7 elements into the 16-byte chunk that holds its first element (OW =
// 59 and W = 121 elements are 118 and 242 bytes), so every row is its own
// slot: the chunks that cover it are copied, and the products read the run
// from its offset 0..7, recomputed from the element index. Copies stop at
// the end of the tensor (zero-filled past it). Values past the end of a row
// are the next row's: finite, and only multiplied by zeroed g.
//
// 8 warps, each a 32-tap x 32-channel tile (2 x 4 m16n8 tiles: 8 mma per
// k16 step against 32 shared-memory loads). Each block writes one partial
// [125, 64]; a second kernel sums the partials in block order. No float
// atomics: the result is the same bits on every run on a card.
//
// Layouts (checked by the Python wrapper): x [B, D, H, W] contiguous bf16,
// g [B, 64, OD, OH, OW] contiguous bf16 (NCDHW, as the convolution's
// backward hands it over), dW [125, 64] f32 (DHWIO), both inputs 16-byte
// aligned.
//
// Bound at the flagship shape (B 16, 121x145x121; NVIDIA H100 SXM
// data-sheet peaks at its 700 W limit): x 67.9 MB + g 506.2 MB = 574.1 MB
// of compulsory traffic take 0.171 ms at 3.35 TB/s; the 63.27 GFLOP take
// 0.064 ms at 989 TFLOP/s dense bf16. Bytes bound it. The design reads each
// g element once and x about 2.75 times (the 11 x rows of a 4-row item; the
// re-reads are served by L2), with the copies under the products.
#include "common.cuh"

namespace {

constexpr int KS = 5;               // kernel size per spatial dim
constexpr int TAPS = KS * KS * KS;  // 125
constexpr int CO = 64;              // output channels
constexpr int NR = 4;               // output rows oh per work item
constexpr int TW = 64;              // output positions along W per item
constexpr int CH = 8;               // bf16 elements in a 16-byte chunk
constexpr int GSLOT = TW + CH;      // a g row slot: 64 positions + 0..7
constexpr int GCHUNKS = GSLOT / CH;  // 9
constexpr int GST = NR * GSLOT + 8;  // channel stride: 148 words, 20 mod
                                     // 32 (no bank conflicts across gid)
constexpr int XHR = 2 * NR + 3;      // x rows along H per kd
constexpr int XROWS = KS * XHR;      // (kd, h) rows of the x tile
constexpr int XSLOT = 144;           // 131 columns read + 0..7, in chunks
constexpr int XCHUNKS = XSLOT / CH;  // 18
constexpr int XST = XSLOT + 8;       // x row stride
constexpr int GSZ = CO * GST;        // elements of one stage's g tile
constexpr int STAGE = GSZ + XROWS * XST;
constexpr int STAGES = 2;
constexpr int SMEM_BYTES = STAGES * STAGE * 2;
constexpr int GCOPIES = CO * NR * GCHUNKS;       // chunks of an item's g
constexpr int COPIES = GCOPIES + XROWS * XCHUNKS;  // and of its x
constexpr int THREADS = 256;  // 8 warps: 4 along taps x 2 along channels
static_assert(GST % CH == 0 && XST % CH == 0 && GSZ % CH == 0 &&
                  STAGE % CH == 0,
              "16-byte slots");
static_assert(XSLOT >= 2 * TW + 3 + 7, "x slot holds a row's columns");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

typedef unsigned short bf16_t;  // raw bits

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src (16-byte aligned) to dst, of which the first `bytes`
// are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(bf16_t* dst, const bf16_t* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every commit group but the newest has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// bytes of the 16-byte chunk at element q that lie inside [0, total)
__device__ __forceinline__ int chunk_bytes(long long q, long long total) {
  return q >= total ? 0 : (int)min(16ll, (total - q) * 2);
}

__device__ __forceinline__ unsigned pack(bf16_t lo, bf16_t hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// d += a * b for one m16n8k16 bf16 tile (f32 accumulate)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

// Start the copies of one item into one stage: the chunks that cover each
// g row (c, r) and each x row (kd, hr) the item reads, spread over the
// block's threads. The caller commits them as one group.
__device__ __forceinline__ void issue_item(bf16_t* st, const Item& m,
                                           const bf16_t* __restrict__ x,
                                           const bf16_t* __restrict__ g,
                                           int B, int D, int H, int W,
                                           int OD, int OH, int OW, int tid) {
  const long long gtotal = (long long)B * CO * OD * OH * OW;
  const long long xtotal = (long long)B * D * H * W;
  for (int j = tid; j < COPIES; j += THREADS) {
    if (j < GCOPIES) {
      const int slot = j / GCHUNKS, k = j - slot * GCHUNKS;
      const int c = slot / NR, r = slot - c * NR;
      if (r >= m.nrows) continue;
      const long long start =
          (((long long)m.b * CO + c) * OD + m.od) * OH * OW +
          (long long)(m.oh0 + r) * OW + m.ow0;
      const long long q = (start & ~7ll) + k * CH;
      const int n = chunk_bytes(q, gtotal);
      cp_async16(st + c * GST + r * GSLOT + k * CH, g + (n ? q : 0), n);
    } else {
      const int jj = j - GCOPIES;
      const int slot = jj / XCHUNKS, k = jj - slot * XCHUNKS;
      const int kd = slot / XHR, hr = slot - kd * XHR;
      if (hr >= 2 * m.nrows + 3) continue;
      const long long start =
          (((long long)m.b * D + 2 * m.od + kd) * H + 2 * m.oh0 + hr) * W +
          2 * m.ow0;
      const long long q = (start & ~7ll) + k * CH;
      const int n = chunk_bytes(q, xtotal);
      cp_async16(st + GSZ + slot * XST + k * CH, x + (n ? q : 0), n);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
stem_dw_bf16_partial_kernel(const bf16_t* __restrict__ x,
                            const bf16_t* __restrict__ g,
                            float* __restrict__ part, int B, int D, int H,
                            int W, int OD, int OH, int OW) {
  extern __shared__ float4 smem4[];
  bf16_t* smem = reinterpret_cast<bf16_t*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3;   // taps wm*32 .. wm*32+31
  const int wn = warp >> 2;  // channels wn*32 .. wn*32+31

  // Of this lane's fragment rows (taps [m tile][row half]): the x-tile
  // slot of its (kd, kh) for output row 0 and its kw; and in x, mod 2^32,
  // the element offset of that row from the item's first x row.
  int xslot0[2][2], xkw[2][2];
  unsigned xg0[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = wm * 32 + mt * 16 + hf * 8 + gid;
      const int t = tap < TAPS ? tap : 0;  // taps 125..127: never stored
      const int kd = t / (KS * KS), kh = (t / KS) % KS, kw = t % KS;
      xslot0[mt][hf] = kd * XHR + kh;
      xkw[mt][hf] = kw;
      xg0[mt][hf] = ((unsigned)kd * H + kh) * W;
    }
  // this lane's fragment column (channel) of each n tile
  int gch[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) gch[nt] = wn * 32 + nt * 8 + gid;

  float tot[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[mt][nt][q] = 0.f;

  // Slots no copy reaches read as the zeros written here, or as values of
  // an earlier item: finite, and only ever multiplied by zeroed g.
  for (int e = tid; e < STAGES * STAGE / 8; e += THREADS)
    smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const long long items = (long long)B * OD * ((OH + NR - 1) / NR) *
                          ((OW + TW - 1) / TW);
  for (int k = 0; k < STAGES; ++k) {
    const long long it = blockIdx.x + (long long)k * gridDim.x;
    if (it < items)
      issue_item(smem + k * STAGE, decode(it, OD, OH, OW), x, g, B, D, H, W,
                 OD, OH, OW, tid);
    cp_async_commit();
  }
  long long it = blockIdx.x;
  for (int i = 0; it < items; ++i, it += gridDim.x) {
    const int st = i % STAGES;
    cp_async_wait_older();  // this thread's copies of item i landed
    __syncthreads();        // and every other thread's
    const Item m = decode(it, OD, OH, OW);
    const bf16_t* gs = smem + st * STAGE;
    const bf16_t* xs = gs + GSZ;
    // the item's first x row and the first g row of channel 0, mod 2^32
    const unsigned xg = (((unsigned)m.b * D + 2 * m.od) * H + 2 * m.oh0) * W +
                        2 * m.ow0;
    const unsigned gg = ((unsigned)m.b * CO * OD + m.od) * OH * OW +
                        (unsigned)m.oh0 * OW + m.ow0;
    const int nk = (m.np + 15) / 16;  // k16 steps holding a valid position
    for (int r = 0; r < m.nrows; ++r) {
      // where this lane's taps and channels start in the stage
      int xa[2][2], ga[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          xa[mt][hf] = (xslot0[mt][hf] + 2 * r) * XST + xkw[mt][hf] +
                       (int)((xg + xg0[mt][hf] + 2u * r * W) & 7u);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ga[nt] = gch[nt] * GST + r * GSLOT +
                 (int)((gg + (unsigned)gch[nt] * OD * OH * OW +
                        (unsigned)r * OW) & 7u);
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
      for (int kq = 0; kq < nk; ++kq) {
        const int p0 = kq * 16 + 2 * tig;  // positions p0, p0+1, p0+8, p0+9
        unsigned a[2][4], bfr[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16_t* gp = gs + ga[nt];
          bf16_t v[4] = {gp[p0], gp[p0 + 1], gp[p0 + 8], gp[p0 + 9]};
          if (p0 + 9 >= m.np) {  // the row's ragged end: the next row's g
            v[0] = p0 < m.np ? v[0] : 0;
            v[1] = p0 + 1 < m.np ? v[1] : 0;
            v[2] = p0 + 8 < m.np ? v[2] : 0;
            v[3] = p0 + 9 < m.np ? v[3] : 0;
          }
          bfr[nt][0] = pack(v[0], v[1]);
          bfr[nt][1] = pack(v[2], v[3]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bf16_t* x0 = xs + xa[mt][0] + 2 * p0;  // row gid
          const bf16_t* x1 = xs + xa[mt][1] + 2 * p0;  // row gid + 8
          a[mt][0] = pack(x0[0], x0[2]);
          a[mt][1] = pack(x1[0], x1[2]);
          a[mt][2] = pack(x0[16], x0[18]);
          a[mt][3] = pack(x1[16], x1[18]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bfr[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[mt][nt][q] += acc[mt][nt][q];
    }
    __syncthreads();  // every read of this stage is done: refill it
    const long long nxt = it + (long long)STAGES * gridDim.x;
    if (nxt < items)
      issue_item(smem + st * STAGE, decode(nxt, OD, OH, OW), x, g, B, D, H,
                 W, OD, OH, OW, tid);
    cp_async_commit();
  }

  // fragment (row gid / gid + 8, columns 2 tig, 2 tig + 1) of each tile
  float* out = part + (long long)blockIdx.x * TAPS * CO;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tap = wm * 32 + mt * 16 + hf * 8 + gid;
      if (tap < TAPS) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(&out[tap * CO + gch[nt] - gid +
                                          2 * tig]) =
              make_float2(tot[mt][nt][2 * hf], tot[mt][nt][2 * hf + 1]);
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

cudaError_t set_smem() {
  return cudaFuncSetAttribute(stem_dw_bf16_partial_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

}  // namespace

// Number of partial blocks the launch uses on the current device (one
// resident wave at the kernel's dynamic shared memory); the wrapper
// allocates part[nparts, 125, 64].
NIDT_EXPORT int stem_dw_bf16_num_parts(int* nparts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stem_dw_bf16_partial_kernel, THREADS, SMEM_BYTES);
  *nparts = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaGetLastError();
}

// x, g bf16; part holds nparts float partials [125, 64]; dw [125, 64]
// float; 2 launches.
NIDT_EXPORT int stem_dw_bf16_launch(const void* x, const void* g, float* part,
                                    float* dw, int nparts, int B, int D,
                                    int H, int W, int OD, int OH, int OW,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  stem_dw_bf16_partial_kernel<<<nparts, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(g), part, B,
      D, H, W, OD, OH, OW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_dw_bf16_reduce_kernel<<<(TAPS * CO + 255) / 256, 256, 0, s>>>(
      part, dw, nparts);
  return (int)cudaGetLastError();
}
