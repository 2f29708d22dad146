// Weight gradient of the stem convolution of AlexNet3D:
//   y = conv3d(x, W, stride 2, VALID), C_in = 1, kernel 5^3, C_out = 64
//   dW[kd,kh,kw,c] = sum_{b,od,oh,ow} x[b, 2od+kd, 2oh+kh, 2ow+kw] * g[b,od,oh,ow,c]
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/stemconv.py
// (_dw_pallas -> _dw_kernel), which first materialized a [128, R] tap-by-row
// patch matrix in HBM (about 2 GB at the flagship shape) and then ran a
// split-K MXU product over it. Here nothing is materialized: each work item
// is one (b, od, oh) row of up to 64 output positions; a block stages the
// 5x5x131 x sub-volume and the 64x64 g tile it needs in shared memory (the
// g tile transposed on the way in, so that the 64 channels of a position
// are one row) and accumulates the [125, 64] product in registers, 8 taps x
// 4 channels per thread. Blocks stride over work items, so each block ends
// with one partial [125, 64]; a second kernel sums the partials in block
// order. No float atomics: the result is the same on every run on a card.
//
// Layouts (checked by the Python wrapper): x [B, D, H, W] contiguous (the
// single input channel), g [B, 64, OD, OH, OW] contiguous (NCDHW, as the
// convolution's backward hands it over: one channel's OW positions are one
// row), dW [125, 64] = DHWIO.
//
// Bound at the flagship shape (B 16, 121x145x121, R = 3,954,416 positions):
// 63.3 GFLOP fp32 on CUDA cores (0.94 ms at 67 TFLOP/s) against 1.15 GB of
// compulsory traffic (0.34 ms at 3.35 TB/s): operations bound it.
#include "common.cuh"

namespace {

constexpr int KS = 5;              // kernel size per spatial dim
constexpr int TAPS = KS * KS * KS; // 125
constexpr int CO = 64;             // output channels
constexpr int TW = 64;             // output positions along W per work item
constexpr int XW = 2 * TW + 3;     // x columns one work item reads (131)
constexpr int XROWS = KS * KS;     // (kd, kh) rows of the x tile
constexpr int GS = CO + 4;         // g tile row stride: 16-byte rows, and
                                   // the transposing writes spread on banks
constexpr int THREADS = 256;
constexpr int TPT = 8;             // taps per thread (16 groups cover 128)
constexpr int CPT = 4;             // channels per thread (16 groups cover 64)

__global__ void __launch_bounds__(THREADS)
stem_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ part, int B, int D, int H, int W,
                       int OD, int OH, int OW) {
  __shared__ float xs[XROWS * XW];
  __shared__ __align__(16) float gs[TW * GS];
  const int tid = threadIdx.x;
  const int cg = tid & 15;   // channels cg*4 .. cg*4+3
  const int tg = tid >> 4;   // taps tg*8 .. tg*8+7
  int off[TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int tap = tg * TPT + i;
    const int t = tap < TAPS ? tap : 0;  // taps 125..127 compute, never stored
    off[i] = ((t / (KS * KS)) * KS + (t / KS) % KS) * XW + t % KS;
  }
  float acc[TPT][CPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int nwt = (OW + TW - 1) / TW;
  const long long items = (long long)B * OD * OH * nwt;
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int wt = (int)(it % nwt);
    long long r = it / nwt;
    const int oh = (int)(r % OH);
    r /= OH;
    const int od = (int)(r % OD);
    const int b = (int)(r / OD);
    const int ow0 = wt * TW;
    const int np = min(TW, OW - ow0);
    const int xw0 = 2 * ow0;
    const int ncol = min(XW, W - xw0);
    __syncthreads();  // the previous item's reads of xs/gs are done
    for (int e = tid; e < XROWS * XW; e += THREADS) {
      const int row = e / XW;
      const int col = e - row * XW;
      float v = 0.f;
      if (col < ncol) {
        const int d = 2 * od + row / KS;
        const int h = 2 * oh + row % KS;
        v = __ldg(&x[(((long long)b * D + d) * H + h) * W + xw0 + col]);
      }
      xs[e] = v;
    }
    // channel c's row of this item starts at gp + c * cstride
    const float* gp = g + (((long long)b * CO * OD + od) * OH + oh) * OW + ow0;
    const long long cstride = (long long)OD * OH * OW;
    for (int c = tid >> 5; c < CO; c += THREADS / 32)  // a warp per row
      for (int p = tid & 31; p < np; p += 32)
        gs[p * GS + c] = __ldg(&gp[c * cstride + p]);
    __syncthreads();
    for (int p = 0; p < np; ++p) {
      const float4 gv = gs4[p * (GS / 4) + cg];
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const float xv = xs[off[i] + 2 * p];
        acc[i][0] = fmaf(xv, gv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, gv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, gv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, gv.w, acc[i][3]);
      }
    }
  }
  float* out = part + (long long)blockIdx.x * TAPS * CO;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    const int tap = tg * TPT + i;
    if (tap < TAPS)
      *reinterpret_cast<float4*>(&out[tap * CO + cg * CPT]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

}  // namespace

// Number of partial blocks the launch uses on the current device (one
// resident wave); the wrapper allocates part[nparts, 125, 64].
NIDT_EXPORT int stem_dw_num_parts(int* nparts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_dw_partial_kernel,
                                                THREADS, 0);
  *nparts = sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaGetLastError();
}

NIDT_EXPORT int stem_dw_launch(const float* x, const float* g, float* part,
                               float* dw, int nparts, int B, int D, int H,
                               int W, int OD, int OH, int OW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stem_dw_partial_kernel<<<nparts, THREADS, 0, s>>>(x, g, part, B, D, H, W,
                                                    OD, OH, OW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_dw_reduce_kernel<<<(TAPS * CO + 255) / 256, 256, 0, s>>>(part, dw,
                                                                nparts);
  return (int)cudaGetLastError();
}
