// Kernel 2: fused backward pass (stage derivatives + Riccati) of the
// cascaded family (tail="none" or tail="pm"), by a team of TEAM threads
// per scenario.
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
// What bounds it on an H100: latency and instruction issue, not bytes.  A
// single-track stage's derivatives are ~40k dependent f32 operations (the
// 12-input gradient jet, the 8-column RK4 Jacobian jet, the 5x5
// second-order jet), a point-mass stage's far fewer; only the Riccati step
// (~3k FMAs) is a recursion.  The inputs and gains are ~5 MB.
//
// Design: the same team sweep as kernel 3 (backward_sweep in team.cuh).
// TEAM = 4 threads per scenario, blocks of 128 threads (135,808 bytes of
// shared memory, one block of 4 warps an SM at 255 registers): B x 4
// threads, at B = 4096 128 blocks on 128 SMs.  The members compute a chunk
// of up to 4 stages' derivatives at once into shared memory (the compact
// slot of team.cuh: 680 bytes a stage), then split each Riccati step of the
// chunk element by element, with the value function in shared memory; the
// gains go straight to device memory.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "team.cuh"

using namespace vct;

#if defined(__CUDACC__)

__global__ void __launch_bounds__(TEAM_BLOCK) backward_fm_kernel(
    STParams p, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ lam, const float* __restrict__ mu, const float* __restrict__ rho,
    const float* __restrict__ curv, const float* __restrict__ ds, float* __restrict__ kff,
    float* __restrict__ kfb, float* __restrict__ dv, float* __restrict__ fail, int B, int H) {
  extern __shared__ float smem[];
  const int b = (blockIdx.x * TEAM_BLOCK + threadIdx.x) / TEAM;
  if (b >= B) return;  // the whole team
  backward_lane(make_team(smem), b, B, H, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, p);
}

// outputs kff (H, 2, B), kfb (H, 2, NZ, B), dv (2, B), fail (B) as 0/1
extern "C" int vct_backward_fm(const float* params, const float* x, const float* u,
                               const float* lam, const float* mu, const float* rho,
                               const float* curv, const float* ds, float* kff, float* kfb,
                               float* dv, float* fail, int B, int H, void* stream) {
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  cudaError_t rc = team_smem_setup(backward_fm_kernel);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (int)(((long long)B * TEAM + TEAM_BLOCK - 1) / TEAM_BLOCK);
  backward_fm_kernel<<<blocks, TEAM_BLOCK, TEAM_SMEM_BYTES, (cudaStream_t)stream>>>(
      p, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, B, H);
  return (int)cudaGetLastError();
}

// the launch shape at B scenarios (team.cuh: team_launch_info)
extern "C" int vct_backward_fm_info(int B, int* out) {
  return team_launch_info(backward_fm_kernel, B, out);
}

#endif
