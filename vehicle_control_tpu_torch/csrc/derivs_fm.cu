// Kernel 4: per-stage derivatives of the cascaded family (tail="none" or
// tail="pm").
//
// Replaces the Pallas TPU kernel build_derivs_kernel_fm
// (vehicle_control_tpu/solvers/derivs_kernel_fm.py).  For every (stage,
// scenario): the AL-cost gradient g (NW), the unsymmetrized Hessian Hw
// (NW x NW, Hw[r][c] = d2L/dw_r dw_c) and the dynamics Jacobian J (NZ x NW)
// over w = (z, u), from stage_derivs in singletrack.cuh (the function kernel
// 2 calls at every stage of its backward sweep), specialised for the kind
// of the thread's stage.  Plain version: derivs_plain.
//
// What bounds it on an H100: stages are independent, so H x B threads run
// at once.  Each writes (12 + 144 + 120) floats: B*H*276*4 bytes, 135.7 MB
// at B=4096, H=30, or 40.5 us at 3.35 TB/s.  Each computes the three jets of
// stage_derivs (the 12-input gradient, the 8-column RK4 Jacobian, the 5x5
// second-order block): roughly 4e4 f32 operations, 4.9 GFLOP at B=4096,
// H=30, or 73 us at 67 TFLOP/s.  The operations are the larger side there,
// and the jets' working set spills to local memory (L1), as in kernel 2.  On
// the cascade (H=60, two thirds of it point-mass stages with a fraction of
// the operations) the bytes are.
// Design: one thread per (stage, scenario) on a grid (ceil(B/128), H), the
// outputs in the struct-of-arrays layout (stage, field, scenario) so a warp
// writes 32 consecutive floats; the wrapper permutes them to (B, H, ...).
// The lane body is plain C++ (VCT_HD), so a host compiler builds it for
// rehearsal; the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

// kernel 4 at (stage n, scenario b).  Inputs x (H, NZ, B), u (H, NU, B),
// lam (H, NC, B), mu (B), curv and ds (H, B); outputs g (H, NW, B),
// hw (H, NW, NW, B) and jm (H, NZ, NW, B)
VCT_HD void derivs_lane(int n, int b, int B, int H, const STParams& p, const float* x,
                        const float* u, const float* lam, const float* mu, const float* curv,
                        const float* ds, float* g_out, float* hw_out, float* jm_out) {
  float wf[NW], lamv[NC], g[NW], Hw[NW][NW], Jm[NZ][NW];
  for (int i = 0; i < NZ; ++i) wf[i] = x[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) wf[NZ + j] = u[at2(n, j, NU, b, B)];
  for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
  with_kind(stage_kind(n, H, p), [&](auto kc) {
    stage_derivs<decltype(kc)::value>(n, H, wf, lamv, mu[b], curv[n * B + b], ds[n * B + b],
                                      ds[(n > 0 ? n - 1 : 0) * B + b],
                                      ds[seam_stage(p) * B + b], p, g, Hw, Jm);
  });
  for (int r = 0; r < NW; ++r) g_out[at2(n, r, NW, b, B)] = g[r];
  for (int r = 0; r < NW; ++r)
    for (int c = 0; c < NW; ++c) hw_out[((size_t)(n * NW + r) * NW + c) * B + b] = Hw[r][c];
  for (int r = 0; r < NZ; ++r)
    for (int c = 0; c < NW; ++c) jm_out[((size_t)(n * NZ + r) * NW + c) * B + b] = Jm[r][c];
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) derivs_fm_kernel(
    STParams p, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ lam, const float* __restrict__ mu, const float* __restrict__ curv,
    const float* __restrict__ ds, float* __restrict__ g, float* __restrict__ hw,
    float* __restrict__ jm, int B, int H) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  derivs_lane(blockIdx.y, b, B, H, p, x, u, lam, mu, curv, ds, g, hw, jm);
}

extern "C" int vct_derivs_fm(const float* params, const float* x, const float* u,
                             const float* lam, const float* mu, const float* curv,
                             const float* ds, float* g, float* hw, float* jm, int B, int H,
                             void* stream) {
  if (B < 1 || H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  dim3 grid((B + 127) / 128, H);
  derivs_fm_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(p, x, u, lam, mu, curv, ds, g, hw, jm,
                                                           B, H);
  return (int)cudaGetLastError();
}

#endif
