// The per-lane pieces that every kernel runs, over a family: the stages in
// order, the closed-loop stage of a line-search candidate (kernels 1, 3 and
// 5) and its record.  The family is a compile-time parameter, the type P of
// its parameter block: STParams (the cascaded family, tail "none" or "pm",
// singletrack.cuh), KinParams (the kinematic family, kinematic.cuh) or
// KcParams (the kc cascade, kc_cascade.cuh).  P gives the widths
// (P::NZ, P::NU, P::NC, P::NW, P::NSYM, P::NX: the model's fields), and the
// family's functions are overloads on P: segments, stage_kind, with_kind,
// stage_box, seam_stage, stage_cost, stage_constraints, al_cost, dyn and
// stage_derivs.  team.cuh (the backward sweep of kernels 2 and 3) and
// linesearch.cuh (kernels 1 and 5) are templates over P too, so each kernel
// has one instantiation a family and no family carries another's widths.
//
// Layout: struct of arrays, (stage, field, scenario) with the scenario
// index fastest, so neighbouring threads read neighbouring addresses.
#pragma once

#include "kc_cascade.cuh"
#include "kinematic.cuh"
#include "singletrack.cuh"

namespace vct {

// SoA indexing helpers: (stage, field, scenario)
VCT_HD int at2(int n, int f, int F, int b, int B) { return (n * F + f) * B + b; }

// f(n, KindC<kind of n>{}) for every stage in order, one segment at a time
template <class P, class F>
VCT_HD void for_each_stage(int H, const P& p, F&& f) {
  Segments sg = segments(H, p);
  for (int s = 0; s < sg.count; ++s) {
    int lo = sg.lo[s], hi = sg.hi[s];
    with_kind(sg.kind[s], p, [&](auto kc) {
      for (int n = lo; n < hi; ++n) f(n, kc);
    });
  }
}

// one stage of one lane as the closed-loop rollouts read it: the reference
// state and control, the gains, the multipliers, the arc parameters (dss:
// the arc step of seam_stage, which the switching cost reads) and the
// control box
template <class P>
struct Stage {
  float xref[P::NZ], uref[P::NU], kff[P::NU], kfb[P::NU][P::NZ], lam[P::NC];
  float kv, dsn, dsp, dss;
  float lo[P::NU], hi[P::NU];
};

template <class P>
VCT_HD void load_stage(int n, int b, int B, const float* X, const float* U, const float* kff,
                       const float* kfb, const float* lam, const float* curv, const float* ds,
                       const P& p, Stage<P>& s) {
  constexpr int NZ = P::NZ, NU = P::NU, NC = P::NC;
  for (int i = 0; i < NZ; ++i) s.xref[i] = X[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) {
    s.uref[j] = U[at2(n, j, NU, b, B)];
    s.kff[j] = kff[at2(n, j, NU, b, B)];
    for (int i = 0; i < NZ; ++i) s.kfb[j][i] = kfb[((size_t)(n * NU + j) * NZ + i) * B + b];
  }
  for (int j = 0; j < NC; ++j) s.lam[j] = lam[at2(n, j, NC, b, B)];
  s.kv = curv[n * B + b];
  s.dsn = ds[n * B + b];
  s.dsp = ds[(n > 0 ? n - 1 : 0) * B + b];
  s.dss = ds[seam_stage(p) * B + b];
  stage_box(n, p, s.lo, s.hi);
}

// the closed-loop law u = clip(uref + alpha*kff + Kfb (z - xref), u_box).
// Not inlined, so the line search and the re-roll of its choice run the
// same instructions and agree to the bit.
template <class P>
VCT_HD_NOINLINE void feedback_u(float alpha, const float z[P::NZ], const Stage<P>& s,
                                float u[P::NU]) {
  constexpr int NZ = P::NZ, NU = P::NU;
  float dz[NZ];
  for (int i = 0; i < NZ; ++i) dz[i] = z[i] - s.xref[i];
  for (int j = 0; j < NU; ++j) {
    float fb = dz[0] * s.kfb[j][0];
    for (int i = 1; i < NZ; ++i) fb = fb + dz[i] * s.kfb[j][i];
    float uj = s.uref[j] + alpha * s.kff[j] + fb;
    u[j] = vmin(vmax(uj, s.lo[j]), s.hi[j]);
  }
}

// one stage of kind K of a line-search candidate: adds the AL stage cost to
// acc and steps z; a next state that is non-finite or reaches |z| >= 1e7
// makes acc +inf for good
template <int K, class P>
VCT_HD void candidate_stage(int n, int H, float alpha, float mu, const Stage<P>& s, const P& p,
                            float z[P::NZ], float& acc) {
  constexpr int NZ = P::NZ, NW = P::NW;
  float wf[NW], nxt[NZ];
  feedback_u(alpha, z, s, wf + NZ);
  for (int i = 0; i < NZ; ++i) wf[i] = z[i];
  float cost = al_cost<K>(n, H, wf, s.lam, mu, s.dsn, s.dsp, s.dss, p);
  dyn<K>(wf, s.kv, s.dsn, p, nxt);
  bool ok = true;
  for (int i = 0; i < NZ; ++i) {
    ok = ok && finite(nxt[i]) && fabsf(nxt[i]) < 1e7f;
    z[i] = nxt[i];
  }
  acc = ok ? acc + cost : INFINITY;
}

#if defined(__CUDACC__)

// the launch shape of a kernel and what the card makes of it: out = {lead
// (the kernel's own first number), threads per launch, block, registers,
// local (stack) bytes per thread, static shared bytes, dynamic shared bytes
// per block, resident blocks per SM, resident warps per SM}
template <class Kernel>
int kernel_launch_info(Kernel* kernel, int lead, long long threads, int block, int smem,
                       int* out) {
  cudaFuncAttributes fa;
  cudaError_t rc = cudaFuncGetAttributes(&fa, kernel);
  int blocks = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int vals[9] = {lead, (int)threads, block, fa.numRegs, (int)fa.localSizeBytes,
                       (int)fa.sharedSizeBytes, smem, blocks, blocks * block / 32};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

#endif

}  // namespace vct
