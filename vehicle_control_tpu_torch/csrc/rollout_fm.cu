// Kernel 1: line-search costs, one instantiation for the cascaded family
// (tail="none" or tail="pm": vct_linesearch_fm), one for the kinematic
// family (vct_linesearch_fm_kin) and one for the kc cascade
// (vct_linesearch_fm_kc).
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
// RK4 substages with their transcendentals) through non-inlined calls; the
// inputs are 48 floats a (stage, scenario), read by all A rollouts of the
// scenario.  It is bound by latency, not by bytes or operations: at B =
// 4096 and A = 6 one thread per rollout gives 5.8 warps an SM.
//
// Design: the block schedule of linesearch.cuh (a block of 32 scenarios,
// a rollout warp and a cost warp per step size, the stage records staged
// in shared memory by cp.async) with the struct-of-arrays record source
// (SoaRecords): the 32 scenarios of one (stage, field) are 128 contiguous
// bytes of device memory and one warp-wide copy.  (Measured against one
// warp a step size that also costs its rollout: PERF.md, kernel_ab.py.)
#include "linesearch.cuh"

using namespace vct;

#if defined(__CUDACC__)

// STParams' floats (cuda_lib.PARAM_FIELDS: the obstacle table's included)
extern "C" int vct_param_count() { return (int)(sizeof(STParams) / sizeof(float)); }

// KinParams' floats (cuda_lib.KIN_PARAM_FIELDS)
extern "C" int vct_kin_param_count() { return (int)(sizeof(KinParams) / sizeof(float)); }

// KcParams' floats (cuda_lib.KC_PARAM_FIELDS)
extern "C" int vct_kc_param_count() { return (int)(sizeof(KcParams) / sizeof(float)); }

extern "C" const char* vct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// costs (A, B); every other pointer is a device array in the SoA layout
extern "C" int vct_linesearch_fm(const float* params, const float* alphas, int A,
                                 const float* xref, const float* uref, const float* kff,
                                 const float* kfb, const float* lam, const float* mu,
                                 const float* curv, const float* ds, const float* z0,
                                 float* costs, int B, int H, void* stream) {
  return linesearch_launch<STParams, SoaRecords<STParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

extern "C" int vct_linesearch_fm_kin(const float* params, const float* alphas, int A,
                                     const float* xref, const float* uref, const float* kff,
                                     const float* kfb, const float* lam, const float* mu,
                                     const float* curv, const float* ds, const float* z0,
                                     float* costs, int B, int H, void* stream) {
  return linesearch_launch<KinParams, SoaRecords<KinParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

extern "C" int vct_linesearch_fm_kc(const float* params, const float* alphas, int A,
                                    const float* xref, const float* uref, const float* kff,
                                    const float* kfb, const float* lam, const float* mu,
                                    const float* curv, const float* ds, const float* z0,
                                    float* costs, int B, int H, void* stream) {
  return linesearch_launch<KcParams, SoaRecords<KcParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

// the launch shape at B scenarios and A step sizes
extern "C" int vct_linesearch_fm_info(int B, int A, int* out) {
  return linesearch_launch_info<STParams, SoaRecords<STParams>>(B, A, out);
}

extern "C" int vct_linesearch_fm_kin_info(int B, int A, int* out) {
  return linesearch_launch_info<KinParams, SoaRecords<KinParams>>(B, A, out);
}

extern "C" int vct_linesearch_fm_kc_info(int B, int A, int* out) {
  return linesearch_launch_info<KcParams, SoaRecords<KcParams>>(B, A, out);
}

#endif
