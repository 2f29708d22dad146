// Fused masked-SGD tail for one parameter leaf, updated in place:
//   g' = clip ? (ok ? g : (g / gnorm) * clip) : g
//   g' = g' + wd * p                 (if wd > 0)
//   t  = g' + momentum * t; g' = t   (if momentum > 0)
//   p  = p + (-lr) * g'
//   p  = p * mask                    (if masked)
//
// Replaces the TPU kernel neuroimagedisttraining_tpu/ops/fused_update.py
// (_leaf_pallas -> _make_kernel): one elementwise pass reading p, g, t and
// mask and writing p and t, in the reference's operation order. Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn,
// no contraction into FMA), so the kernel is bit-equal to the plain PyTorch
// chain, which rounds each operation separately too. clip, wd and momentum
// come by value; [ok, gnorm, lr] stay on the device: the per-round lr and
// the per-step global norm never cross to the host.
//
// Bound: memory. At the flagship AlexNet3D (2.57 M parameters over 24
// leaves) one step moves 4 reads + 2 writes of 4 bytes per parameter,
// about 62 MB: about 18 us at 3.35 TB/s.
#include "common.cuh"

namespace {

__global__ void fused_sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                                 float* __restrict__ t, const float* __restrict__ m,
                                 const float* __restrict__ scal, long long n,
                                 float clip, float wd, float mom, int has_clip,
                                 int has_wd, int has_trace, int has_mask) {
  const bool ok = scal[0] > 0.5f;
  const float gnorm = scal[1];
  const float neg_lr = -scal[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    float gi = g[i];
    if (has_clip && !ok) gi = __fmul_rn(__fdiv_rn(gi, gnorm), clip);
    if (has_wd) gi = __fadd_rn(gi, __fmul_rn(wd, pi));
    if (has_trace) {
      gi = __fadd_rn(gi, __fmul_rn(mom, t[i]));
      t[i] = gi;
    }
    float pn = __fadd_rn(pi, __fmul_rn(neg_lr, gi));
    if (has_mask) pn = __fmul_rn(pn, m[i]);
    p[i] = pn;
  }
}

}  // namespace

NIDT_EXPORT int fused_sgd_launch(float* p, const float* g, float* t,
                                 const float* m, const float* scal, long long n,
                                 float clip, float wd, float momentum,
                                 int has_clip, int has_wd, int has_trace,
                                 int has_mask, int max_blocks, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  fused_sgd_kernel<<<(int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, t, m, scal, n, clip, wd, momentum, has_clip, has_wd, has_trace,
      has_mask);
  return (int)cudaGetLastError();
}
