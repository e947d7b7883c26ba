// Kernel 5: line-search costs of the cascaded family from the field-last
// (array-of-structs) layout.
//
// Replaces the Pallas TPU kernel build_linesearch_kernel
// (vehicle_control_tpu/solvers/rollout_kernel.py), the JAX package's layout
// ablation, which sits on no route of the solver.  It computes what kernel
// 1 (rollout_fm.cu) computes - for each of A step sizes and each scenario
// the AL cost of the closed-loop rollout u = clip(Uref + alpha*kff +
// Kfb (z - Xref), u_box of the stage), +inf once a next state is
// non-finite or reaches |z| >= 1e7 - with the same device functions
// (candidate_stage, one static segment at a time); only the loads differ.
// Plain version: kernel 1's linesearch_costs_plain on the same numbers.
//
// Layout: the solver's own (B, H, F) tensors, read in place.  A thread reads
// its scenario's contiguous records, so the 32 threads of a warp read 32
// addresses H*F*4 bytes apart (1200 bytes for X at H=30) and each load
// instruction touches 32 sectors where kernel 1's struct-of-arrays touches
// 4.  What bounds it on an H100 is what bounds kernel 1 (latency and
// instruction issue of the serial stage chain), plus those scattered loads;
// the comparison of the two is the point of this kernel.  Grid (A,
// ceil(B/128)), one thread per (alpha, scenario), the ragged block masked.
// The lane body is plain C++ (VCT_HD), so a host compiler builds it for
// rehearsal; the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

// one stage of scenario b from the (B, H, F) layout
VCT_HD void load_stage_aos(int n, int b, int H, const float* X, const float* U, const float* kff,
                           const float* kfb, const float* lam, const float* curv,
                           const float* ds, const STParams& p, Stage& s) {
  size_t bn = (size_t)b * H + n, b0 = (size_t)b * H;
  for (int i = 0; i < NZ; ++i) s.xref[i] = X[bn * NZ + i];
  for (int j = 0; j < NU; ++j) {
    s.uref[j] = U[bn * NU + j];
    s.kff[j] = kff[bn * NU + j];
    for (int i = 0; i < NZ; ++i) s.kfb[j][i] = kfb[(bn * NU + j) * NZ + i];
  }
  for (int j = 0; j < NC; ++j) s.lam[j] = lam[bn * NC + j];
  s.kv = curv[bn];
  s.dsn = ds[bn];
  s.dsp = ds[b0 + (n > 0 ? n - 1 : 0)];
  s.dss = ds[b0 + seam_stage(p)];
  stage_box(n, p, s.lo, s.hi);
}

// kernel 5: the line-search cost of step size alpha for scenario b
VCT_HD void linesearch_aos_lane(int b, int H, float alpha, const float* xref, const float* uref,
                                const float* kff, const float* kfb, const float* lam,
                                const float* mu, const float* curv, const float* ds,
                                const float* z0, float* cost_out, const STParams& p) {
  float z[NZ];
  for (int i = 0; i < NZ; ++i) z[i] = z0[(size_t)b * NZ + i];
  float m = mu[b], acc = 0.f;
  for_each_stage(H, p, [&](int n, auto kc) {
    Stage s;
    load_stage_aos(n, b, H, xref, uref, kff, kfb, lam, curv, ds, p, s);
    candidate_stage<decltype(kc)::value>(n, H, alpha, m, s, p, z, acc);
  });
  cost_out[b] = vct::finite(acc) ? acc : INFINITY;
}

#if defined(__CUDACC__)

struct AlphasAoS {
  float v[MAX_ALPHA];
};

__global__ void __launch_bounds__(128) linesearch_aos_kernel(
    STParams p, AlphasAoS alphas, const float* __restrict__ xref, const float* __restrict__ uref,
    const float* __restrict__ kff, const float* __restrict__ kfb, const float* __restrict__ lam,
    const float* __restrict__ mu, const float* __restrict__ curv, const float* __restrict__ ds,
    const float* __restrict__ z0, float* __restrict__ costs, int B, int H) {
  int a = blockIdx.x;
  int b = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  linesearch_aos_lane(b, H, alphas.v[a], xref, uref, kff, kfb, lam, mu, curv, ds, z0,
                      costs + (size_t)a * B, p);
}

// costs (A, B); every other pointer is a device array in the (B, H, F) layout
extern "C" int vct_linesearch_aos(const float* params, const float* alphas, int A,
                                  const float* xref, const float* uref, const float* kff,
                                  const float* kfb, const float* lam, const float* mu,
                                  const float* curv, const float* ds, const float* z0,
                                  float* costs, int B, int H, void* stream) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1 || (B + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  STParams p;
  memcpy(&p, params, sizeof(STParams));
  AlphasAoS al;
  for (int i = 0; i < MAX_ALPHA; ++i) al.v[i] = i < A ? alphas[i] : 0.f;
  dim3 grid(A, (B + 127) / 128);
  linesearch_aos_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(p, al, xref, uref, kff, kfb, lam,
                                                                 mu, curv, ds, z0, costs, B, H);
  return (int)cudaGetLastError();
}

#endif
