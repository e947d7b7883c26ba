// Kernel 4: per-stage derivatives, one instantiation for the cascaded
// family (tail="none" or tail="pm": vct_derivs_fm), one for the kinematic
// family (vct_derivs_fm_kin) and one for the kc cascade (vct_derivs_fm_kc).
//
// Replaces the Pallas TPU kernel build_derivs_kernel_fm
// (vehicle_control_tpu/solvers/derivs_kernel_fm.py).  For every (stage,
// scenario): the AL-cost gradient g (NW), the Hessian Hw (NW x NW, Hw[r][c]
// = d2L/dw_r dw_c, symmetric) and the dynamics Jacobian J (NZ x NW) over w =
// (z, u), from stage_derivs in singletrack.cuh (the function kernels 2 and 3
// call at every stage of their backward sweep), specialised for the kind of
// the thread's stage.  Plain version: derivs_plain.
//
// What bounds it on an H100: stages are independent, so H x B threads run
// at once.  Each writes (12 + 144 + 120) floats: B*H*276*4 bytes, 135.7 MB
// at B=4096, H=30, or 40.5 us at 3.35 TB/s.  This code does about 12k f32
// operations a single-track stage (counted by its host build with
// csrc/op_count.h; the plain version's jets about 36k), 1.5 GFLOP at
// B=4096, H=30, or 22 us at 67 TFLOP/s: the bytes bind, on the cascade
// (H=60, two thirds of it point-mass stages) too.
// Design: one thread per (stage, scenario) on a grid (ceil(B/128), H), the
// outputs in the struct-of-arrays layout (stage, field, scenario) so a warp
// writes 32 consecutive floats; the wrapper permutes them to (B, H, ...).
// stage_derivs does far fewer operations than the plain version's jets: the
// RK4 Jacobian by its sparse analytic chain (rk4_jacobian), the Hessian's
// nonquadratic 5x5 block by one symmetric second-order jet pass that also
// gives those entries of the gradient, the rest of g and Hw in closed form
// (PERF.md).  Splitting a stage's derivatives over 2, 3 or 4 threads by jet
// direction was measured slower (PERF.md: each thread repeats the value
// chain, and a register-resident thread was no faster per operation).
// The lane body is plain C++ (VCT_HD), so a host compiler builds it for
// rehearsal (csrc/host_driver.cpp); the kernel and its launcher are CUDA
// only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "family.cuh"

using namespace vct;

// kernel 4 at (stage n, scenario b).  Inputs x (H, NZ, B), u (H, NU, B),
// lam (H, NC, B), mu (B), curv and ds (H, B); outputs g (H, NW, B),
// hw (H, NW, NW, B) (both triangles of the packed Hessian) and jm (H, NZ,
// NW, B)
template <class P>
VCT_HD void derivs_lane(int n, int b, int B, int H, const P& p, const float* x, const float* u,
                        const float* lam, const float* mu, const float* curv, const float* ds,
                        float* g_out, float* hw_out, float* jm_out) {
  constexpr int NZ = P::NZ, NU = P::NU, NC = P::NC, NW = P::NW;
  float wf[NW], lamv[NC], g[NW], Hs[P::NSYM], Jm[NZ][NW];
  for (int i = 0; i < NZ; ++i) wf[i] = x[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) wf[NZ + j] = u[at2(n, j, NU, b, B)];
  for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
  with_kind(stage_kind(n, H, p), p, [&](auto kc) {
    stage_derivs<decltype(kc)::value>(n, H, wf, lamv, mu[b], curv[n * B + b], ds[n * B + b],
                                      ds[(n > 0 ? n - 1 : 0) * B + b],
                                      ds[seam_stage(p) * B + b], p, g, Hs, Jm);
  });
  for (int r = 0; r < NW; ++r) g_out[at2(n, r, NW, b, B)] = g[r];
  for (int r = 0; r < NW; ++r)
    for (int c = 0; c < NW; ++c)
      hw_out[((size_t)(n * NW + r) * NW + c) * B + b] = Hs[sym_n<NW>(r, c)];
  for (int r = 0; r < NZ; ++r)
    for (int c = 0; c < NW; ++c) jm_out[((size_t)(n * NZ + r) * NW + c) * B + b] = Jm[r][c];
}

#if defined(__CUDACC__)

template <class P>
__global__ void __launch_bounds__(128) derivs_fm_kernel(
    P p, const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ lam, const float* __restrict__ mu, const float* __restrict__ curv,
    const float* __restrict__ ds, float* __restrict__ g, float* __restrict__ hw,
    float* __restrict__ jm, int B, int H) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  derivs_lane(blockIdx.y, b, B, H, p, x, u, lam, mu, curv, ds, g, hw, jm);
}

template <class P>
int derivs_launch(const float* params, const float* x, const float* u, const float* lam,
                  const float* mu, const float* curv, const float* ds, float* g, float* hw,
                  float* jm, int B, int H, void* stream) {
  if (B < 1 || H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  P p;
  memcpy(&p, params, sizeof(P));
  dim3 grid((B + 127) / 128, H);
  derivs_fm_kernel<P><<<grid, 128, 0, (cudaStream_t)stream>>>(p, x, u, lam, mu, curv, ds, g, hw,
                                                              jm, B, H);
  return (int)cudaGetLastError();
}

extern "C" int vct_derivs_fm(const float* params, const float* x, const float* u,
                             const float* lam, const float* mu, const float* curv,
                             const float* ds, float* g, float* hw, float* jm, int B, int H,
                             void* stream) {
  return derivs_launch<STParams>(params, x, u, lam, mu, curv, ds, g, hw, jm, B, H, stream);
}

extern "C" int vct_derivs_fm_kin(const float* params, const float* x, const float* u,
                                 const float* lam, const float* mu, const float* curv,
                                 const float* ds, float* g, float* hw, float* jm, int B, int H,
                                 void* stream) {
  return derivs_launch<KinParams>(params, x, u, lam, mu, curv, ds, g, hw, jm, B, H, stream);
}

extern "C" int vct_derivs_fm_kc(const float* params, const float* x, const float* u,
                                const float* lam, const float* mu, const float* curv,
                                const float* ds, float* g, float* hw, float* jm, int B, int H,
                                void* stream) {
  return derivs_launch<KcParams>(params, x, u, lam, mu, curv, ds, g, hw, jm, B, H, stream);
}

// the launch shape at B scenarios and H stages (family.cuh:
// kernel_launch_info; the lead number is the threads a (stage, scenario))
extern "C" int vct_derivs_fm_info(int B, int H, int* out) {
  return kernel_launch_info(derivs_fm_kernel<STParams>, 1, (long long)B * H, 128, 0, out);
}

extern "C" int vct_derivs_fm_kin_info(int B, int H, int* out) {
  return kernel_launch_info(derivs_fm_kernel<KinParams>, 1, (long long)B * H, 128, 0, out);
}

extern "C" int vct_derivs_fm_kc_info(int B, int H, int* out) {
  return kernel_launch_info(derivs_fm_kernel<KcParams>, 1, (long long)B * H, 128, 0, out);
}

#endif
