// The line search's block schedule, shared by kernel 1 (rollout_fm.cu: the
// struct-of-arrays layout) and kernel 5 (rollout_aos.cu: the (B, H, F)
// layout); only the record source differs.
//
// A block serves LS_SCEN = 32 consecutive scenarios, one a lane, with W =
// min(A, LS_MAX_WARPS) rollout warps and W cost warps.  Rollout warp w
// takes step sizes w, w + W, ...: at each stage it computes the control
// (feedback_u), steps the dynamics (dyn) and leaves (z, u) and the guard of
// the next state in a ring in shared memory (roll_stage).  Cost warp W + w
// takes the same step sizes one chunk behind and sums their AL stage costs
// (al_cost) from the ring, in stage order.  So the cost is off the dynamics
// chain and the block runs twice the warps; the functions are the same, not
// inlined, so each cost is the one-thread rollout's (candidate_stage) bit
// for bit.
// The stage records (Stage: the reference, the gains, the multipliers, the
// arc parameters, the control box) of the block's scenarios are staged in
// shared memory once per chunk of C stages by asynchronous copies
// (cp.async, 4 bytes a field) by the record source, in three buffers: the
// chunk rolled out, the chunk costed, the chunk in flight.  So each record
// is read from device memory once per scenario instead of once per step
// size, and no warp waits on a load.  A record sits at a stride of 53
// floats (StageSlot; 47 for the kinematic family), a ring entry at 13 (11):
// all odd, so the 32 lanes reading one field hit 32 banks.  The schedule is
// a template over the family's parameter block P (family.cuh).  Block barriers on either side of a chunk.  C = 4
// stages (2 where A > 11, for the ring to fit): at A = 6, 161,280 bytes of
// shared memory a block; at B = 4096, 128 blocks of 12 warps, one a
// streaming multiprocessor.  The ragged last block masks its lanes past B
// (they still meet the barriers).
// The schedule (linesearch_block) is plain C++ (VCT_HD) over a thread's view
// of the block, so a host compiler builds the same source for rehearsal
// (csrc/host_driver.cpp runs every thread of a block phase by phase); the
// kernel and its launcher are CUDA only.
#pragma once

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "family.cuh"

namespace vct {

constexpr int LS_SCEN = 32;      // scenarios a block: one warp's lanes
constexpr int LS_MAX_WARPS = 8;  // rollout warps a block (as many cost warps)
constexpr int LS_TURNS = (MAX_ALPHA + LS_MAX_WARPS - 1) / LS_MAX_WARPS;  // step sizes a warp
constexpr int LS_BUFS = 3;        // record buffers: rolled, costed, in flight
constexpr int LS_MAX_SMEM = 232448;  // shared memory a block may take on an H100

// a record in shared memory (Stage<P>), padded to an odd stride
template <class P>
struct StageSlot {
  Stage<P> s;
  float pad;
};

// the records and the ring of the family P: the fields of a record read
// from device memory (then its control box), a ring entry (z, u) and the
// guard of the next state
template <class P>
struct LsLayout {
  static constexpr int NZ = P::NZ, NU = P::NU, NC = P::NC;
  static constexpr int REC_COPIED = NZ + 2 * NU + NU * NZ + NC + 4;  // 48 cascaded, 42 kinematic
  static constexpr int REC_FIELDS = (int)(sizeof(Stage<P>) / sizeof(float));
  static constexpr int RING = P::NW + 1;
  static_assert(REC_FIELDS == REC_COPIED + 2 * NU, "a record: its copied fields, then its box");
  static_assert(sizeof(StageSlot<P>) % (2 * sizeof(float)) == sizeof(float) && RING % 2 == 1,
                "odd strides");
};
static_assert(sizeof(StageSlot<STParams>) == 53 * sizeof(float) &&
                  sizeof(StageSlot<KinParams>) == 47 * sizeof(float) &&
                  sizeof(StageSlot<KcParams>) == 53 * sizeof(float),
              "a slot is 53 floats (cascaded, kc), 47 (kinematic)");

// rollout warps a block (as many cost warps), shared memory for chunks of
// C stages, and the chunk for A step sizes
VCT_HD int ls_warps(int A) { return A < LS_MAX_WARPS ? A : LS_MAX_WARPS; }
template <class P>
VCT_HD int ls_smem(int A, int C) {
  return C * LS_SCEN *
         (LS_BUFS * (int)sizeof(StageSlot<P>) + 2 * A * LsLayout<P>::RING * (int)sizeof(float));
}
template <class P>
VCT_HD int ls_chunk(int A) { return ls_smem<P>(A, 4) <= LS_MAX_SMEM ? 4 : 2; }

// the line search's inputs: the reference, the gains, the multipliers, mu,
// the arc parameters and the start state, in the record source's layout
struct LsInputs {
  const float *xref, *uref, *kff, *kfb, *lam, *mu, *curv, *ds, *z0;
};

// field r < REC_COPIED of scenario b's record of stage n in device memory
// (Stage's fields in order: xref, uref, kff, kfb, lam, kv, dsn, dsp, dss)
template <class P>
VCT_HD const float* record_src(const LsInputs& in, int r, int n, int b, int B, const P& p) {
  constexpr int NZ = P::NZ, NU = P::NU, NC = P::NC;
  constexpr int U0 = NZ, K0 = U0 + NU, F0 = K0 + NU, L0 = F0 + NU * NZ, C0 = L0 + NC;
  if (r < U0) return in.xref + at2(n, r, NZ, b, B);
  if (r < K0) return in.uref + at2(n, r - U0, NU, b, B);
  if (r < F0) return in.kff + at2(n, r - K0, NU, b, B);
  if (r < L0) return in.kfb + (size_t)(n * NU * NZ + r - F0) * B + b;
  if (r < C0) return in.lam + at2(n, r - L0, NC, b, B);
  if (r == C0) return in.curv + n * B + b;
  if (r == C0 + 1) return in.ds + n * B + b;
  if (r == C0 + 2) return in.ds + (n > 0 ? n - 1 : 0) * B + b;
  return in.ds + seam_stage(p) * B + b;
}

// one field from device to shared memory: cp.async on the card
VCT_HD void copy_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = *src;
#endif
}

// field r >= REC_COPIED of a stage-n record: the control box lo[0], lo[1],
// hi[0], hi[1]
template <class P>
VCT_HD float record_box(int r, int n, const P& p) {
  constexpr int NU = P::NU, REC_COPIED = LsLayout<P>::REC_COPIED;
  float bl[NU], bh[NU];
  stage_box(n, p, bl, bh);
  return r - REC_COPIED < NU ? bl[r - REC_COPIED] : bh[r - REC_COPIED - NU];
}

// field r of the record in slot
template <class P>
VCT_HD float* slot_field(StageSlot<P>* slot, int r) {
  return reinterpret_cast<float*>(&slot->s) + r;
}

// Kernel 1's record source for the family P: the inputs in the
// struct-of-arrays layout (stage, field, scenario).  A record source gives a scenario's mu and
// start state, and stages the records of stages [lo, hi) of the block's
// scenarios b0.. into slots (stage-major, slot k * LS_SCEN + scenario),
// thread (warp w of W, lane l) its share of them.
template <class P>
struct SoaRecords {
  LsInputs in;
  VCT_HD float mu(int b, int) const { return in.mu[b]; }
  VCT_HD float z0(int i, int b, int B) const { return in.z0[i * B + b]; }
  // warp w takes the chunk's (stage, field) rows w, w + W, ..., lane l
  // scenario b0 + l: the 32 lanes' copies are 128 contiguous bytes
  VCT_HD void stage(const P& p, int lo, int hi, int b0, int B, int, StageSlot<P>* slots, int w,
                    int W, int l) const {
    constexpr int REC_FIELDS = LsLayout<P>::REC_FIELDS, REC_COPIED = LsLayout<P>::REC_COPIED;
    const int b = b0 + l;
    if (b >= B) return;
    for (int q = w; q < (hi - lo) * REC_FIELDS; q += W) {
      const int k = q / REC_FIELDS, r = q % REC_FIELDS, n = lo + k;
      float* dst = slot_field(&slots[k * LS_SCEN + l], r);
      if (r < REC_COPIED)
        copy_async4(dst, record_src(in, r, n, b, B, p));
      else
        *dst = record_box(r, n, p);
    }
  }
};

// one stage of kind K of a rollout warp's candidate: steps z and leaves
// (z, u) and the guard of the next state in its ring entry
// (candidate_stage less the cost)
template <int K, class P>
VCT_HD void roll_stage(float alpha, const Stage<P>& s, const P& p, float z[P::NZ], float* entry) {
  constexpr int NZ = P::NZ, NW = P::NW;
  float wf[NW], nxt[NZ];
  feedback_u(alpha, z, s, wf + NZ);
  for (int i = 0; i < NZ; ++i) wf[i] = z[i];
  dyn<K>(wf, s.kv, s.dsn, p, nxt);
  bool ok = true;
  for (int i = 0; i < NZ; ++i) {
    ok = ok && finite(nxt[i]) && fabsf(nxt[i]) < 1e7f;
    z[i] = nxt[i];
  }
  for (int i = 0; i < NW; ++i) entry[i] = wf[i];
  entry[NW] = ok ? 1.f : 0.f;
}

// phase 2, lane l, one candidate over stages [lo, hi) from the staged
// records rec and its ring: a rollout warp steps z into the ring, a cost
// warp adds the stage costs from it to acc (+inf for good after a bad state)
template <class P>
VCT_HD void candidate_chunk(bool roller, int lo, int hi, int H, float alpha, float mu,
                            const StageSlot<P>* rec, float* ring, int l, const P& p,
                            float z[P::NZ], float& acc) {
  constexpr int NW = P::NW;
  for (int n = lo; n < hi; ++n) {
    const Stage<P>& s = rec[(n - lo) * LS_SCEN + l].s;
    float* entry = ring + ((n - lo) * LS_SCEN + l) * LsLayout<P>::RING;
    with_kind(stage_kind(n, H, p), p, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      if (roller) {
        roll_stage<K>(alpha, s, p, z, entry);
      } else {
        float cost = al_cost<K>(n, H, entry, s.lam, mu, s.dsn, s.dsp, s.dss, p);
        acc = entry[NW] != 0.f ? acc + cost : INFINITY;
      }
    });
  }
}

// the block's shared memory: LS_BUFS record buffers of C stages, then the
// ring, two chunks of C stages for each of A step sizes
template <class P>
VCT_HD StageSlot<P>* ls_records(float* smem, int C, int chunk) {
  return reinterpret_cast<StageSlot<P>*>(smem) + (chunk % LS_BUFS) * C * LS_SCEN;
}
template <class P>
VCT_HD float* ls_ring(float* smem, int C, int A, int chunk, int a) {
  float* ring = smem + LS_BUFS * C * LS_SCEN * (int)(sizeof(StageSlot<P>) / sizeof(float));
  return ring + (size_t)((chunk & 1) * A + a) * C * LS_SCEN * LsLayout<P>::RING;
}

struct Alphas {
  float v[MAX_ALPHA];
};

// a thread's own state: its step sizes' states and cost sums, and its
// scenario's mu
template <class P>
struct LsThread {
  float z[LS_TURNS][P::NZ], acc[LS_TURNS], mu;
};

// The block's schedule, the one source of the kernel and its host
// rehearsal.  blk.each(f) runs f(warp, lane, the thread's LsThread) on the
// calling thread on the card, on every thread of the block in turn on the
// host; blk.commit() and blk.wait_prior() are the cp.async groups (commit,
// wait for all but the newest), blk.sync() the block barrier: nothing on
// the host.  Between two barriers no thread reads what another writes.
template <class P, class Block, class Records>
VCT_HD void linesearch_block(Block& blk, const P& p, const Alphas& alphas, int A, int C,
                             const Records& src, float* smem, float* costs, int b0, int B,
                             int H) {
  constexpr int NZ = P::NZ;
  const int W = ls_warps(A), chunks = (H + C - 1) / C;
  blk.each([&](int warp, int l, LsThread<P>& t) {
    const int b = b0 + l;
    const bool live = b < B;
    t.mu = live ? src.mu(b, B) : 0.f;
    for (int j = 0; j < LS_TURNS; ++j) {
      t.acc[j] = 0.f;
      for (int i = 0; i < NZ; ++i) t.z[j][i] = live ? src.z0(i, b, B) : 0.f;
    }
    src.stage(p, 0, C < H ? C : H, b0, B, H, ls_records<P>(smem, C, 0), warp, 2 * W, l);
  });
  blk.commit();
  for (int c = 0; c <= chunks; ++c) {  // rollouts of chunk c, costs of chunk c - 1
    if (c + 1 < chunks) {
      const int lo = (c + 1) * C, hi = lo + C < H ? lo + C : H;
      blk.each([&](int warp, int l, LsThread<P>&) {
        src.stage(p, lo, hi, b0, B, H, ls_records<P>(smem, C, c + 1), warp, 2 * W, l);
      });
    }
    blk.commit();
    blk.wait_prior();  // this thread's copies of chunk c
    blk.sync();        // and every thread's
    blk.each([&](int warp, int l, LsThread<P>& t) {
      const bool roller = warp < W;
      const int w = roller ? warp : warp - W, cc = roller ? c : c - 1;
      if (b0 + l >= B || cc < 0 || cc >= chunks) return;
      const int lo = cc * C, hi = lo + C < H ? lo + C : H;
      for (int j = 0; j < LS_TURNS; ++j) {
        const int a = w + j * W;
        if (a < A)
          candidate_chunk(roller, lo, hi, H, alphas.v[a], t.mu, ls_records<P>(smem, C, cc),
                          ls_ring<P>(smem, C, A, cc, a), l, p, t.z[j], t.acc[j]);
      }
    });
    blk.sync();  // chunk c - 1's records and ring are free again
  }
  blk.each([&](int warp, int l, LsThread<P>& t) {
    const int b = b0 + l;
    if (b >= B || warp < W) return;
    for (int j = 0; j < LS_TURNS; ++j) {
      const int a = warp - W + j * W;
      if (a < A) costs[(size_t)a * B + b] = vct::finite(t.acc[j]) ? t.acc[j] : INFINITY;
    }
  });
}

#if defined(__CUDACC__)

// one thread of the block, for linesearch_block
template <class P>
struct DeviceBlock {
  int warp, l;
  LsThread<P> t;
  template <class F>
  VCT_HD void each(F&& f) { f(warp, l, t); }
  VCT_HD void commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::);
#endif
  }
  VCT_HD void wait_prior() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group 1;\n" ::);
#endif
  }
  VCT_HD void sync() {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
};

// the kernel of a record source's block for the family P: block x serves
// scenarios x * LS_SCEN..
template <class P, class Records>
__global__ void __launch_bounds__(2 * LS_MAX_WARPS * 32)
    linesearch_kernel(P p, Alphas alphas, int A, int C, Records src, float* __restrict__ costs,
                      int B, int H) {
  extern __shared__ float smem[];
  DeviceBlock<P> blk;
  blk.warp = threadIdx.x >> 5;
  blk.l = threadIdx.x & 31;
  linesearch_block(blk, p, alphas, A, C, src, smem, costs, (int)blockIdx.x * LS_SCEN, B, H);
}

template <class P, class Records>
cudaError_t linesearch_smem_setup(int A) {
  return cudaFuncSetAttribute(linesearch_kernel<P, Records>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ls_smem<P>(A, ls_chunk<P>(A)));
}

// costs (A, B) of the step sizes alphas from the inputs in the record
// source's layout
template <class P, class Records>
int linesearch_launch(const float* params, const float* alphas, int A, const LsInputs& in,
                      float* costs, int B, int H, void* stream) {
  if (A < 1 || A > MAX_ALPHA || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  P p;
  memcpy(&p, params, sizeof(P));
  Alphas al;
  for (int i = 0; i < MAX_ALPHA; ++i) al.v[i] = i < A ? alphas[i] : 0.f;
  cudaError_t rc = linesearch_smem_setup<P, Records>(A);
  if (rc != cudaSuccess) return (int)rc;
  const int C = ls_chunk<P>(A);
  linesearch_kernel<P, Records><<<(B + LS_SCEN - 1) / LS_SCEN, 2 * ls_warps(A) * 32,
                                  ls_smem<P>(A, C), (cudaStream_t)stream>>>(
      p, al, A, C, Records{in}, costs, B, H);
  return (int)cudaGetLastError();
}

// the launch shape at B scenarios and A step sizes (family.cuh:
// kernel_launch_info; the lead number is the scenarios a block)
template <class P, class Records>
int linesearch_launch_info(int B, int A, int* out) {
  if (A < 1 || A > MAX_ALPHA || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t rc = linesearch_smem_setup<P, Records>(A);
  if (rc != cudaSuccess) return (int)rc;
  const int block = 2 * ls_warps(A) * 32;
  return kernel_launch_info(linesearch_kernel<P, Records>, LS_SCEN,
                            (long long)(B + LS_SCEN - 1) / LS_SCEN * block, block,
                            ls_smem<P>(A, ls_chunk<P>(A)), out);
}

#endif

}  // namespace vct
