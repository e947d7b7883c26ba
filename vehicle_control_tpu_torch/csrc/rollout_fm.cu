// Kernel 1: line-search costs of the cascaded family (tail="none" or
// tail="pm").
//
// Replaces the Pallas TPU kernel build_linesearch_kernel_fm
// (vehicle_control_tpu/solvers/rollout_kernel_fm.py).  For each of A step
// sizes and each scenario it rolls out u = clip(Uref + alpha*kff +
// Kfb (z - Xref), u_box) over the horizon, summing the AL stage cost and
// stepping the dynamics of each stage's kind (the single-track RK4 step,
// the seam, the point-mass Euler step); a next state that is non-finite or
// reaches |z| >= 1e7 makes the cost +inf.  Plain version:
// linesearch_costs_plain.
//
// What bounds it on an H100: A x B independent rollouts, each a serial chain
// of H stages of ~1.5k dependent f32 operations (cost, constraints and four
// RK4 substages with their transcendentals); the inputs are read once per
// stage, so it is bound by latency and instruction throughput, not memory.
// Design: one thread per (alpha, scenario) on a 2-D grid (A, ceil(B/128)),
// the stage loop inside the thread, every per-scenario array in the
// struct-of-arrays layout (stage, field, scenario) so a warp reads 32
// consecutive floats; the wrapper permutes (B, H, F) inputs into that
// layout with .contiguous().  Step sizes, car parameters, weights and boxes
// are kernel arguments, not literals.  The ragged last block is masked.
// The lane body is plain C++ (VCT_HD), so a host compiler builds it for
// rehearsal; the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

#if defined(__CUDACC__)

struct Alphas {
  float v[MAX_ALPHA];
};

__global__ void __launch_bounds__(128) linesearch_fm_kernel(
    STParams p, Alphas alphas, const float* __restrict__ xref, const float* __restrict__ uref,
    const float* __restrict__ kff, const float* __restrict__ kfb, const float* __restrict__ lam,
    const float* __restrict__ mu, const float* __restrict__ curv, const float* __restrict__ ds,
    const float* __restrict__ z0, float* __restrict__ costs, int B, int H) {
  int a = blockIdx.x;
  int b = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  linesearch_lane(b, B, H, alphas.v[a], xref, uref, kff, kfb, lam, mu, curv, ds, z0,
                  costs + (size_t)a * B, p);
}

extern "C" int vct_param_count() { return (int)(sizeof(STParams) / sizeof(float)); }

extern "C" const char* vct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// costs (A, B); every other pointer is a device array in the SoA layout
extern "C" int vct_linesearch_fm(const float* params, const float* alphas, int A,
                                 const float* xref, const float* uref, const float* kff,
                                 const float* kfb, const float* lam, const float* mu,
                                 const float* curv, const float* ds, const float* z0,
                                 float* costs, int B, int H, void* stream) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  Alphas al;
  for (int i = 0; i < MAX_ALPHA; ++i) al.v[i] = i < A ? alphas[i] : 0.f;
  dim3 grid(A, (B + 127) / 128);
  linesearch_fm_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      p, al, xref, uref, kff, kfb, lam, mu, curv, ds, z0, costs, B, H);
  return (int)cudaGetLastError();
}

#endif
