// A team of TEAM threads per scenario, and the backward pass it runs
// (kernels 2 and 3).
//
// A team is TEAM consecutive lanes of one warp (32 / TEAM scenarios to a
// warp).  Its code comes in two kinds:
// - phases: phase(tm, f) runs f(t) on every member t, then the team's
//   barrier (__syncwarp of its lanes).  A member writes only what its own
//   t selects; what it writes is read by the others after the barrier.
// - uniform code, between phases: every member runs it on the same
//   values and gets the same result (the 2x2 solve, Armijo, the solver's
//   bookkeeping).  It reads the team's shared area but writes neither the
//   area nor device memory.
// On the host (no __CUDA_ARCH__) the barriers compile to nothing, uniform
// code runs once and a phase loops over the members, so the same source
// builds with g++ for rehearsal (csrc/host_driver.cpp).
//
// The team's shared area holds
// - a chunk: the derivatives of up to TEAM stages, one slot each: g (NW),
//   the symmetrized Hessian's upper triangle (NW(NW+1)/2) and the
//   Jacobian's live block, rows 0-7 x columns 0-7 and the two controls
//   (8 x 10).  Rows 8 and 9 (stash_next = u) and columns 8 and 9 (the
//   stash, which no dynamics reads) are constants, rebuilt by jm().  170
//   floats, 680 bytes a stage (the full g, Hw and Jm would be 276).  Kernel
//   3's per-stage costs of the ordered sums reuse the chunk;
// - the Riccati step's scratch: Vx, Vxx (upper triangle: it is symmetric
//   by construction), Vxx [A B], Qx and Qu, Qxx, Qux, Quu, K and Quu K:
//   361 floats;
// - kernel 3's candidate costs (MAX_ALPHA) and the members' partial maxima
//   (TEAM).
// TEAM = 4: 1,061 floats, 4,244 bytes a team; a block of 128 threads (32
// teams) takes 135,808 bytes, one block an SM.
#pragma once

#include "singletrack.cuh"

// The team's width: 4 is the build the wrappers load; the host test and
// kernel_ab.py also build 8 (-DVCT_TEAM=8).
#ifndef VCT_TEAM
#define VCT_TEAM 4  // threads per scenario
#endif

namespace vct {

constexpr int TEAM = VCT_TEAM;
static_assert(TEAM >= 1 && TEAM <= 32 && 32 % TEAM == 0, "a team divides a warp");
constexpr int TEAM_BLOCK = 128;  // threads per block of kernels 2 and 3

// the chunk's slots
constexpr int NSYM = NW * (NW + 1) / 2;  // 78
constexpr int JCOLS = 10;                // live Jacobian columns: 0-7, u_Fx, u1
constexpr int SLOT_G = 0, SLOT_H = NW, SLOT_J = NW + NSYM;
constexpr int SLOT = SLOT_J + 8 * JCOLS;  // 170
constexpr int CHUNK = TEAM * SLOT;
// the Riccati scratch, after the chunk
constexpr int VSYM = NZ * (NZ + 1) / 2;  // 55
constexpr int R_VX = CHUNK, R_VXX = R_VX + NZ, R_VA = R_VXX + VSYM, R_Q = R_VA + NZ * NW,
              R_QXX = R_Q + NW, R_QUX = R_QXX + NZ * NZ, R_QUU = R_QUX + NU * NZ,
              R_K = R_QUU + NU * NU, R_QK = R_K + NU * NZ, R_END = R_QK + NU * NZ;
// kernel 3's candidate costs and partial maxima
constexpr int S_COST = R_END, S_PART = S_COST + MAX_ALPHA;
constexpr int TEAM_FLOATS = S_PART + TEAM;
constexpr int TEAM_SMEM_BYTES = TEAM_BLOCK / TEAM * TEAM_FLOATS * (int)sizeof(float);

struct Team {
  float* sh;      // the team's shared area, TEAM_FLOATS floats
  unsigned mask;  // its lanes in the warp
  int t;          // the member (on the card; the host loops over members)
};

#if !defined(__CUDA_ARCH__)
// the host's member order: 1 runs the members last to first, so a test can
// show that no member reads what another writes in the same phase
inline int host_member_order = 0;
#endif

VCT_HD void team_sync(const Team& tm) {
#if defined(__CUDA_ARCH__)
  __syncwarp(tm.mask);
#endif
}

// f(t) on every member t, then the team's barrier
template <class F>
VCT_HD void phase(const Team& tm, F&& f) {
#if defined(__CUDA_ARCH__)
  f(tm.t);
  __syncwarp(tm.mask);
#else
  for (int i = 0; i < TEAM; ++i) f(host_member_order ? TEAM - 1 - i : i);
#endif
}

// member t's share of count independent elements of a Riccati product
template <class F>
VCT_HD void riccati_elements(int t, int count, F&& f) {
  for (int e = t; e < count; e += TEAM) f(e);
}

// f(n, KindC<kind>{}) on member t's stages: each segment in chunks of
// TEAM consecutive stages, member t taking the t-th, so the members of a
// team are in one segment at a time
template <class F>
VCT_HD void for_member_stages(int t, int H, const STParams& p, F&& f) {
  Segments sg = segments(H, p);
  for (int s = 0; s < sg.count; ++s) {
    int lo = sg.lo[s], hi = sg.hi[s];
    with_kind(sg.kind[s], [&](auto kc) {
      for (int n = lo + t; n < hi; n += TEAM) f(n, kc);
    });
  }
}

// packed upper-triangle indices of a symmetric matrix of order NW or NZ
VCT_HD int sym_w(int r, int c) {
  if (r > c) { int x = r; r = c; c = x; }
  return r * (2 * NW - r + 1) / 2 + c - r;
}
VCT_HD int sym_z(int r, int c) {
  if (r > c) { int x = r; r = c; c = x; }
  return r * (2 * NZ - r + 1) / 2 + c - r;
}
VCT_HD void unpack_z(int i, int& r, int& c) {
  r = 0;
  while (i >= NZ - r) { i -= NZ - r; ++r; }
  c = r + i;
}

// Jm[k][c] of the stage in slot; rows 8 and 9 and columns 8 and 9 are
// the constants stage_derivs sets for every kind
VCT_HD float jm(const float* slot, int k, int c) {
  if (k >= 8) return c == NZ + (k - 8) ? 1.f : 0.f;
  if (c == 8 || c == 9) return 0.f;
  return slot[SLOT_J + k * JCOLS + (c < 8 ? c : c - 2)];
}

// stage n's derivatives (stage_derivs, unchanged) into its slot: g, the
// Hessian symmetrized as the Riccati step reads it, the Jacobian's live block
template <int K>
VCT_HD void derivs_to_slot(int n, int b, int B, int H, const float* X, const float* U,
                           const float* lam, float mu, const float* curv, const float* ds,
                           float dss, const STParams& p, float* slot) {
  float wf[NW], lamv[NC], g[NW], Hw[NW][NW], Jm[NZ][NW];
  for (int i = 0; i < NZ; ++i) wf[i] = X[at2(n, i, NZ, b, B)];
  for (int j = 0; j < NU; ++j) wf[NZ + j] = U[at2(n, j, NU, b, B)];
  for (int j = 0; j < NC; ++j) lamv[j] = lam[at2(n, j, NC, b, B)];
  const float dsp = ds[(n > 0 ? n - 1 : 0) * B + b];
  stage_derivs<K>(n, H, wf, lamv, mu, curv[n * B + b], ds[n * B + b], dsp, dss, p, g, Hw, Jm);
  for (int i = 0; i < NW; ++i) slot[SLOT_G + i] = g[i];
  for (int r = 0; r < NW; ++r)
    for (int c = r; c < NW; ++c) slot[SLOT_H + sym_w(r, c)] = 0.5f * (Hw[r][c] + Hw[c][r]);
  for (int k = 0; k < 8; ++k)
    for (int c = 0; c < NW; ++c)
      if (c != 8 && c != 9) slot[SLOT_J + k * JCOLS + (c < 8 ? c : c - 2)] = Jm[k][c];
}

// One Riccati step of stage n from its slot, with the value function (Vx,
// Vxx) in the shared area: the Q terms (A = Jm[:, :NZ], B = Jm[:, NZ:]),
// the closed-form solve of Quu + rho I (not PD when a <= 0 or det <= 0),
// the gains into kff and kfb, the value function update.  Each element of
// each product is computed by one member, its sum in the order of a
// one-thread loop, so how the elements are split changes no bit.
VCT_HD void riccati_step(const Team& tm, const float* slot, int n, int b, int B, float rho,
                         float* kff, float* kfb, float& dV1, float& dV2, bool& fail) {
  float* sh = tm.sh;
  float *Vx = sh + R_VX, *Vxx = sh + R_VXX, *VA = sh + R_VA, *Q = sh + R_Q;
  float *Qxx = sh + R_QXX, *Qux = sh + R_QUX, *Quu = sh + R_QUU, *Kg = sh + R_K, *QK = sh + R_QK;
  phase(tm, [&](int t) {  // Vxx [A B], then Qx and Qu
    riccati_elements(t, NZ * NW + NW, [&](int e) {
      if (e < NZ * NW) {
        int r = e / NW, c = e % NW;
        float s = 0.f;
        for (int k = 0; k < NZ; ++k) s += Vxx[sym_z(r, k)] * jm(slot, k, c);
        VA[e] = s;
      } else {
        int i = e - NZ * NW;
        float s = slot[SLOT_G + i];
        for (int k = 0; k < NZ; ++k) s += jm(slot, k, i) * Vx[k];
        Q[i] = s;
      }
    });
  });
  phase(tm, [&](int t) {  // Qxx, Qux, Quu
    riccati_elements(t, NZ * NZ + NU * NZ + NU * NU, [&](int e) {
      int r, c;
      float* out;
      if (e < NZ * NZ) {
        r = e / NZ, c = e % NZ, out = Qxx + e;
      } else if (e < NZ * NZ + NU * NZ) {
        int i = e - NZ * NZ;
        r = NZ + i / NZ, c = i % NZ, out = Qux + i;
      } else {
        int i = e - NZ * NZ - NU * NZ;
        r = NZ + i / NU, c = NZ + i % NU, out = Quu + i;
      }
      float s = slot[SLOT_H + sym_w(r, c)];
      for (int k = 0; k < NZ; ++k) s += jm(slot, k, r) * VA[k * NW + c];
      *out = s;
    });
  });
  // the 2x2 solve, on every member alike
  const float* Qu = Q + NZ;
  const float a = 0.5f * (Quu[0] + Quu[0]) + rho;
  const float bb = 0.5f * (Quu[1] + Quu[2]);
  const float d = 0.5f * (Quu[3] + Quu[3]) + rho;
  const float det = a * d - bb * bb;
  const bool bad = (a <= 0.f) || (det <= 0.f);
  const float inv_det = bad ? 1.f : 1.f / det;
  const float k0 = -((d * Qu[0] - bb * Qu[1]) * inv_det);
  const float k1 = -((a * Qu[1] - bb * Qu[0]) * inv_det);
  const float Quuk0 = a * k0 + bb * k1, Quuk1 = bb * k0 + d * k1;
  dV1 += k0 * Qu[0] + k1 * Qu[1];
  dV2 += 0.5f * (k0 * Quuk0 + k1 * Quuk1);
  fail = fail || bad;
  phase(tm, [&](int t) {  // the gains K and Quu K; kff and kfb out
    riccati_elements(t, NZ + 1, [&](int c) {
      if (c == NZ) {
        kff[at2(n, 0, NU, b, B)] = k0;
        kff[at2(n, 1, NU, b, B)] = k1;
        return;
      }
      float K0 = -((d * Qux[c] - bb * Qux[NZ + c]) * inv_det);
      float K1 = -((a * Qux[NZ + c] - bb * Qux[c]) * inv_det);
      Kg[c] = K0;
      Kg[NZ + c] = K1;
      QK[c] = a * K0 + bb * K1;
      QK[NZ + c] = bb * K0 + d * K1;
      kfb[((size_t)(n * NU) * NZ + c) * B + b] = K0;
      kfb[((size_t)(n * NU + 1) * NZ + c) * B + b] = K1;
    });
  });
  phase(tm, [&](int t) {  // the value function, with the regularized Quu
    riccati_elements(t, NZ + VSYM, [&](int e) {
      if (e < NZ) {
        int c = e;
        Vx[c] = Q[c] + Kg[c] * (Quuk0 + Qu[0]) + Kg[NZ + c] * (Quuk1 + Qu[1]) + Qux[c] * k0 +
                Qux[NZ + c] * k1;
        return;
      }
      int r, c;
      unpack_z(e - NZ, r, c);
      auto q = [&](int i, int j) {  // Qxx + K'Quu K + K'Qux + Qux'K at (i, j)
        return Qxx[i * NZ + j] + (Kg[i] * QK[j] + Kg[NZ + i] * QK[NZ + j] + Kg[i] * Qux[j] +
                                  Kg[NZ + i] * Qux[NZ + j] + Qux[i] * Kg[j] +
                                  Qux[NZ + i] * Kg[NZ + j]);
      };
      Vxx[e - NZ] = 0.5f * (q(r, c) + q(c, r));
    });
  });
}

// The fused backward pass (derivatives + Riccati) of scenario b by its
// team: writes the gains kff (H, NU, B) and kfb (H, NU, NZ, B); returns the
// expected-decrease terms and whether some stage's regularized Quu was not
// positive definite, on every member alike.  The horizon is walked
// backward one segment at a time, in chunks of up to TEAM stages: the
// members compute the chunk's stage derivatives at once, one stage each,
// then the chunk's Riccati steps run in order, last stage first.
VCT_HD void backward_sweep(const Team& tm, int b, int B, int H, const float* X, const float* U,
                           const float* lam, float mu, float rho, const float* curv,
                           const float* ds, float* kff, float* kfb, float& dV1_out,
                           float& dV2_out, bool& fail_out, const STParams& p) {
  float* sh = tm.sh;
  phase(tm, [&](int t) {  // Vx = 0, Vxx = 0
    for (int i = t; i < NZ + VSYM; i += TEAM) sh[R_VX + i] = 0.f;
  });
  float dV1 = 0.f, dV2 = 0.f;
  bool fail = false;
  const float dss = ds[seam_stage(p) * B + b];
  Segments sg = segments(H, p);
  for (int seg = sg.count - 1; seg >= 0; --seg) {
    const int kind = sg.kind[seg];
    for (int hi = sg.hi[seg]; hi > sg.lo[seg]; hi -= TEAM) {
      const int lo = hi - TEAM > sg.lo[seg] ? hi - TEAM : sg.lo[seg];
      phase(tm, [&](int t) {
        int n = lo + t;
        if (n < hi)
          with_kind(kind, [&](auto kc) {
            derivs_to_slot<decltype(kc)::value>(n, b, B, H, X, U, lam, mu, curv, ds, dss, p,
                                                tm.sh + t * SLOT);
          });
      });
      for (int n = hi - 1; n >= lo; --n)
        riccati_step(tm, tm.sh + (n - lo) * SLOT, n, b, B, rho, kff, kfb, dV1, dV2, fail);
    }
  }
  dV1_out = dV1;
  dV2_out = dV2;
  fail_out = fail;
}

// kernel 2: the backward pass of scenario b; dv (2, B), fail_out (B) as 0/1
VCT_HD void backward_lane(const Team& tm, int b, int B, int H, const float* X, const float* U,
                          const float* lam, const float* mu, const float* rho,
                          const float* curv, const float* ds, float* kff, float* kfb,
                          float* dv, float* fail_out, const STParams& p) {
  float dV1, dV2;
  bool fail;
  backward_sweep(tm, b, B, H, X, U, lam, mu[b], rho[b], curv, ds, kff, kfb, dV1, dV2, fail, p);
  phase(tm, [&](int t) {
    if (t == 0) {
      dv[b] = dV1;
      dv[B + b] = dV2;
      fail_out[b] = fail ? 1.f : 0.f;
    }
  });
}

#if defined(__CUDACC__)

// the calling thread's team: member t of scenario (global thread) / TEAM
__device__ __forceinline__ Team make_team(float* smem) {
  const int t = threadIdx.x % TEAM, lane = threadIdx.x & 31;
  const unsigned mask = TEAM == 32 ? 0xffffffffu : ((1u << (TEAM % 32)) - 1u) << (lane - t);
  return Team{smem + (threadIdx.x / TEAM) * TEAM_FLOATS, mask, t};
}

// a team kernel may take TEAM_SMEM_BYTES of dynamic shared memory
template <class Kernel>
cudaError_t team_smem_setup(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TEAM_SMEM_BYTES);
}

// the launch shape of a team kernel at B scenarios (kernel_launch_info;
// the lead number is TEAM)
template <class Kernel>
int team_launch_info(Kernel* kernel, int B, int* out) {
  cudaError_t rc = team_smem_setup(kernel);
  if (rc != cudaSuccess) return (int)rc;
  return kernel_launch_info(kernel, TEAM, (long long)B * TEAM, TEAM_BLOCK, TEAM_SMEM_BYTES, out);
}

#endif

}  // namespace vct
