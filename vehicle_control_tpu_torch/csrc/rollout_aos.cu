// Kernel 5: line-search costs from the field-last (array-of-structs)
// layout, for the cascaded family and the kinematic family.
//
// Replaces the Pallas TPU kernel build_linesearch_kernel
// (vehicle_control_tpu/solvers/rollout_kernel.py), the JAX package's layout
// ablation, which sits on no route of the solver.  It computes what kernel
// 1 (rollout_fm.cu) computes - for each of A step sizes and each scenario
// the AL cost of the closed-loop rollout u = clip(Uref + alpha*kff +
// Kfb (z - Xref), u_box of the stage), +inf once a next state is
// non-finite or reaches |z| >= 1e7 - through the same block schedule
// (linesearch_block in linesearch.cuh), so its costs are kernel 1's bit
// for bit; only the record source differs.  Plain version: kernel 1's
// linesearch_costs_plain on the same numbers.
//
// Layout: the solver's own (B, H, F) tensors, read in place.  A scenario's
// records of C consecutive stages in one tensor are one contiguous run of
// C * F floats, so a warp stages a scenario at a time: its lanes copy
// consecutive floats of each run by cp.async (128 contiguous bytes a warp
// instruction, as kernel 1's lanes do across scenarios) into the same
// StageSlots kernel 1 fills; the arc steps of the previous and the seam
// stage, and the control box, a field a lane.  What bounds it on an H100 is
// what bounds kernel 1 (latency and instruction issue of the serial stage
// chain); the comparison of the two is the point of this kernel.
// The record source is plain C++ (VCT_HD), so the host build runs it
// through linesearch_block (csrc/host_driver.cpp); the launcher is CUDA
// only.
#include "linesearch.cuh"

using namespace vct;

// Kernel 5's record source for the family P: the inputs in the (B, H, F)
// layout, Xref (B, H, NZ), Uref and kff (B, H, NU), Kfb (B, H, NU, NZ), lam
// (B, H, NC), mu (B), curv and ds (B, H), z0 (B, NZ).  Warp w of W stages
// scenarios b0 + w, b0 + w + W, ...
template <class P>
struct AosRecords {
  LsInputs in;
  VCT_HD float mu(int b, int) const { return in.mu[b]; }
  VCT_HD float z0(int i, int b, int) const { return in.z0[(size_t)b * P::NZ + i]; }
  VCT_HD void stage(const P& p, int lo, int hi, int b0, int B, int H, StageSlot<P>* slots, int w,
                    int W, int l) const {
    constexpr int NZ = P::NZ, NU = P::NU, NC = P::NC, REC_COPIED = LsLayout<P>::REC_COPIED;
    const int C = hi - lo;
    for (int s = w; s < LS_SCEN && b0 + s < B; s += W) {
      const size_t row = (size_t)(b0 + s) * H;  // the scenario's stage 0
      StageSlot<P>* dst = slots + s;            // its slot of chunk stage k: dst[k * LS_SCEN]
      // the contiguous runs: fields [at, at + F) of each of the C records
      const float* runs[7] = {in.xref, in.uref, in.kff, in.kfb, in.lam, in.curv, in.ds};
      const int F[7] = {NZ, NU, NU, NU * NZ, NC, 1, 1};
      const int at[7] = {0, NZ, NZ + NU, NZ + 2 * NU, NZ + 2 * NU + NU * NZ,
                         NZ + 2 * NU + NU * NZ + NC, NZ + 2 * NU + NU * NZ + NC + 1};
      for (int t = 0; t < 7; ++t)
        for (int e = l; e < C * F[t]; e += 32)
          copy_async4(slot_field(&dst[e / F[t] * LS_SCEN], at[t] + e % F[t]),
                      runs[t] + (row + lo) * F[t] + e);
      // a field a lane: the previous and the seam stage's arc steps, the box
      for (int e = l; e < C * 6; e += 32) {
        const int k = e / 6, f = e % 6, n = lo + k;
        float* field = slot_field(&dst[k * LS_SCEN], REC_COPIED - 2 + f);
        if (f == 0)
          copy_async4(field, in.ds + row + (n > 0 ? n - 1 : 0));
        else if (f == 1)
          copy_async4(field, in.ds + row + seam_stage(p));
        else
          *field = record_box(REC_COPIED + f - 2, n, p);
      }
    }
  }
};

#if defined(__CUDACC__)

// costs (A, B); every other pointer is a device array in the (B, H, F)
// layout; one entry a family (vct_linesearch_aos: the cascaded family,
// _kin: the kinematic family, _kc: the kc cascade)
extern "C" int vct_linesearch_aos(const float* params, const float* alphas, int A,
                                  const float* xref, const float* uref, const float* kff,
                                  const float* kfb, const float* lam, const float* mu,
                                  const float* curv, const float* ds, const float* z0,
                                  float* costs, int B, int H, void* stream) {
  return linesearch_launch<STParams, AosRecords<STParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

extern "C" int vct_linesearch_aos_kin(const float* params, const float* alphas, int A,
                                      const float* xref, const float* uref, const float* kff,
                                      const float* kfb, const float* lam, const float* mu,
                                      const float* curv, const float* ds, const float* z0,
                                      float* costs, int B, int H, void* stream) {
  return linesearch_launch<KinParams, AosRecords<KinParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

extern "C" int vct_linesearch_aos_kc(const float* params, const float* alphas, int A,
                                     const float* xref, const float* uref, const float* kff,
                                     const float* kfb, const float* lam, const float* mu,
                                     const float* curv, const float* ds, const float* z0,
                                     float* costs, int B, int H, void* stream) {
  return linesearch_launch<KcParams, AosRecords<KcParams>>(
      params, alphas, A, LsInputs{xref, uref, kff, kfb, lam, mu, curv, ds, z0}, costs, B, H,
      stream);
}

// the launch shape at B scenarios and A step sizes
extern "C" int vct_linesearch_aos_info(int B, int A, int* out) {
  return linesearch_launch_info<STParams, AosRecords<STParams>>(B, A, out);
}

extern "C" int vct_linesearch_aos_kin_info(int B, int A, int* out) {
  return linesearch_launch_info<KinParams, AosRecords<KinParams>>(B, A, out);
}

extern "C" int vct_linesearch_aos_kc_info(int B, int A, int* out) {
  return linesearch_launch_info<KcParams, AosRecords<KcParams>>(B, A, out);
}

#endif
