// Kernel 2: fused backward pass (stage derivatives + Riccati) of the
// cascaded family (tail="none" or tail="pm").
//
// Replaces the Pallas TPU kernel build_backward_kernel_fm
// (vehicle_control_tpu/solvers/backward_kernel_fm.py).  For each scenario it
// sweeps the horizon backward: at every stage the hand-derived AL-cost
// gradient, Hessian and RK4 Jacobian (stage_derivs in singletrack.cuh, the
// transcription of fm_family.stage_derivs: forward-mode jets in place of
// JAX's in-kernel autodiff), then the Riccati step with the closed-form 2x2
// solve of Quu + rho*I; a lane whose Quu is not positive definite is
// flagged.  Outputs kff, Kfb, dV1, dV2 and the flag.  Plain version:
// backward_plain.
//
// What bounds it on an H100: a serial chain of H stages per scenario, each
// ~40k dependent f32 FMAs on a single-track stage (the 12-input gradient
// jet, the 8-column RK4 Jacobian jet, the 5x5 second-order jet and the 10x10
// Riccati products; a point-mass stage needs only the gradient jet, a
// 5-column Euler jet and the Riccati products),
// with the value function (Vx: 10, Vxx: 100 floats) and the per-stage A,
// Qxx and Qux far beyond 255 registers: it is latency-bound and spills to
// local memory (L1-resident).
// Design, correctness first: one thread per scenario, blocks of 128, the
// stage loop inside the thread, struct-of-arrays inputs (the wrapper
// permutes (B, H, F) with .contiguous()), the derivative tensors never
// leave the thread.  The known sparsity of the Jacobian (columns s, t and
// the stash are trivial) is not exploited yet.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) backward_fm_kernel(
    STParams p, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ lam, const float* __restrict__ mu, const float* __restrict__ rho,
    const float* __restrict__ curv, const float* __restrict__ ds, float* __restrict__ kff,
    float* __restrict__ kfb, float* __restrict__ dv, float* __restrict__ fail, int B, int H) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  backward_lane(b, B, H, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, p);
}

// outputs kff (H, 2, B), kfb (H, 2, NZ, B), dv (2, B), fail (B) as 0/1
extern "C" int vct_backward_fm(const float* params, const float* x, const float* u,
                               const float* lam, const float* mu, const float* rho,
                               const float* curv, const float* ds, float* kff, float* kfb,
                               float* dv, float* fail, int B, int H, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  backward_fm_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      p, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, B, H);
  return (int)cudaGetLastError();
}

#endif
