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
// RK4 substages with their transcendentals) through non-inlined calls; the
// inputs are 48 floats a (stage, scenario), read by all A rollouts of the
// scenario.  It is bound by latency, not by bytes or operations: at B =
// 4096 and A = 6 one thread per rollout gives 5.8 warps an SM.
//
// Design: a block serves LS_SCEN = 32 consecutive scenarios, one a lane,
// with W = min(A, LS_MAX_WARPS) rollout warps and W cost warps.  Rollout
// warp w takes step sizes w, w + W, ...: at each stage it computes the
// control (feedback_u), steps the dynamics (dyn) and leaves (z, u) and the
// guard of the next state in a ring in shared memory (roll_stage).  Cost
// warp W + w takes the same step sizes one chunk behind and sums their AL
// stage costs (al_cost) from the ring, in stage order.  So the cost is off
// the dynamics chain and the block runs twice the warps; the functions are
// the same, not inlined, so each cost is the one-thread rollout's
// (candidate_stage) bit for bit.
// The stage records (Stage: the reference, the gains, the multipliers, the
// arc parameters, the control box) of the block's scenarios are staged in
// shared memory once per chunk of C stages by asynchronous copies (cp.async,
// 4 bytes a field: the 32 scenarios of one (stage, field) are 128
// contiguous bytes of device memory and one warp-wide copy), in three
// buffers: the chunk rolled out, the chunk costed, the chunk in flight.  So
// each record is read from device memory once per scenario instead of once
// per step size, and no warp waits on a load.  A record sits at a stride of
// 53 floats (StageSlot), a ring entry at 13: both odd, so the 32 lanes
// reading one field hit 32 banks.  Block barriers on either side of a
// chunk.  C = 4 stages (2 where A > 11, for the ring to fit): at A = 6,
// 161,280 bytes of shared memory a block; at B = 4096, 128 blocks of 12
// warps, one a streaming multiprocessor.  The ragged last block masks its
// lanes past B (they still meet the barriers).  (Measured against one
// warp a step size that also costs its rollout: PERF.md, kernel_ab.py.)
// The block's schedule (linesearch_block) is plain C++ (VCT_HD) over a
// thread's view of the block, so a host compiler builds the same source for
// rehearsal (csrc/host_driver.cpp runs every thread of a block phase by
// phase); the kernel and its launcher are CUDA only.
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <string.h>

#include "singletrack.cuh"

using namespace vct;

constexpr int LS_SCEN = 32;      // scenarios a block: one warp's lanes
constexpr int LS_MAX_WARPS = 8;  // rollout warps a block (as many cost warps)
constexpr int LS_TURNS = (MAX_ALPHA + LS_MAX_WARPS - 1) / LS_MAX_WARPS;  // step sizes a warp
constexpr int LS_BUFS = 3;        // record buffers: rolled, costed, in flight
constexpr int REC_COPIED = 48;    // fields of a record read from device memory
constexpr int REC_FIELDS = (int)(sizeof(Stage) / sizeof(float));  // 52: then the control box
constexpr int RING = NW + 1;      // a ring entry: (z, u) and the guard, an odd stride
constexpr int LS_MAX_SMEM = 232448;  // shared memory a block may take on an H100

// a record in shared memory, padded to an odd stride of 53 floats
struct StageSlot {
  Stage s;
  float pad;
};
static_assert(sizeof(Stage) == 52 * sizeof(float) && sizeof(StageSlot) == 53 * sizeof(float),
              "a record is 52 floats, a slot 53");

// rollout warps a block (as many cost warps), shared memory for chunks of
// C stages, and the chunk for A step sizes
VCT_HD int ls_warps(int A) { return A < LS_MAX_WARPS ? A : LS_MAX_WARPS; }
VCT_HD int ls_smem(int A, int C) {
  return C * LS_SCEN * (LS_BUFS * (int)sizeof(StageSlot) + 2 * A * RING * (int)sizeof(float));
}
VCT_HD int ls_chunk(int A) { return ls_smem(A, 4) <= LS_MAX_SMEM ? 4 : 2; }

// kernel 1's inputs in the struct-of-arrays layout (stage, field, scenario)
struct LsInputs {
  const float *xref, *uref, *kff, *kfb, *lam, *mu, *curv, *ds, *z0;
};

// field r < REC_COPIED of scenario b's record of stage n in device memory
// (Stage's fields in order: xref, uref, kff, kfb, lam, kv, dsn, dsp, dss)
VCT_HD const float* record_src(const LsInputs& in, int r, int n, int b, int B,
                               const STParams& p) {
  if (r < 10) return in.xref + at2(n, r, NZ, b, B);
  if (r < 12) return in.uref + at2(n, r - 10, NU, b, B);
  if (r < 14) return in.kff + at2(n, r - 12, NU, b, B);
  if (r < 34) return in.kfb + (size_t)(n * NU * NZ + r - 14) * B + b;
  if (r < 44) return in.lam + at2(n, r - 34, NC, b, B);
  if (r == 44) return in.curv + n * B + b;
  if (r == 45) return in.ds + n * B + b;
  if (r == 46) return in.ds + (n > 0 ? n - 1 : 0) * B + b;
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

// phase 1, warp w of W, lane l: its share of the records of stages [lo, hi)
// of scenarios b0.. into slots (stage-major): warp w takes the chunk's
// (stage, field) rows w, w + W, ..., lane l scenario b0 + l
VCT_HD void stage_records(const LsInputs& in, const STParams& p, int lo, int hi, int b0, int B,
                          StageSlot* slots, int w, int W, int l) {
  const int b = b0 + l;
  if (b >= B) return;
  for (int q = w; q < (hi - lo) * REC_FIELDS; q += W) {
    const int k = q / REC_FIELDS, r = q % REC_FIELDS, n = lo + k;
    float* dst = reinterpret_cast<float*>(&slots[k * LS_SCEN + l].s) + r;
    if (r < REC_COPIED) {
      copy_async4(dst, record_src(in, r, n, b, B, p));
    } else {  // the control box: lo[0], lo[1], hi[0], hi[1]
      float bl[NU], bh[NU];
      stage_box(n, p, bl, bh);
      *dst = r - REC_COPIED < NU ? bl[r - REC_COPIED] : bh[r - REC_COPIED - NU];
    }
  }
}

// one stage of kind K of a rollout warp's candidate: steps z and leaves
// (z, u) and the guard of the next state in its ring entry
// (candidate_stage less the cost)
template <int K>
VCT_HD void roll_stage(float alpha, const Stage& s, const STParams& p, float z[NZ], float* entry) {
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
VCT_HD void candidate_chunk(bool roller, int lo, int hi, int H, float alpha, float mu,
                            const StageSlot* rec, float* ring, int l, const STParams& p,
                            float z[NZ], float& acc) {
  for (int n = lo; n < hi; ++n) {
    const Stage& s = rec[(n - lo) * LS_SCEN + l].s;
    float* entry = ring + ((n - lo) * LS_SCEN + l) * RING;
    with_kind(stage_kind(n, H, p), [&](auto kc) {
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
VCT_HD StageSlot* ls_records(float* smem, int C, int chunk) {
  return reinterpret_cast<StageSlot*>(smem) + (chunk % LS_BUFS) * C * LS_SCEN;
}
VCT_HD float* ls_ring(float* smem, int C, int A, int chunk, int a) {
  float* ring = smem + LS_BUFS * C * LS_SCEN * (int)(sizeof(StageSlot) / sizeof(float));
  return ring + (size_t)((chunk & 1) * A + a) * C * LS_SCEN * RING;
}

struct Alphas {
  float v[MAX_ALPHA];
};

// a thread's own state: its step sizes' states and cost sums, and its
// scenario's mu
struct LsThread {
  float z[LS_TURNS][NZ], acc[LS_TURNS], mu;
};

// The block's schedule, the one source of the kernel and its host
// rehearsal.  blk.each(f) runs f(warp, lane, the thread's LsThread) on the
// calling thread on the card, on every thread of the block in turn on the
// host; blk.commit() and blk.wait_prior() are the cp.async groups (commit,
// wait for all but the newest), blk.sync() the block barrier: nothing on
// the host.  Between two barriers no thread reads what another writes.
template <class Block>
VCT_HD void linesearch_block(Block& blk, const STParams& p, const Alphas& alphas, int A, int C,
                             const LsInputs& in, float* smem, float* costs, int b0, int B, int H) {
  const int W = ls_warps(A), chunks = (H + C - 1) / C;
  blk.each([&](int warp, int l, LsThread& t) {
    const int b = b0 + l;
    const bool live = b < B;
    t.mu = live ? in.mu[b] : 0.f;
    for (int j = 0; j < LS_TURNS; ++j) {
      t.acc[j] = 0.f;
      for (int i = 0; i < NZ; ++i) t.z[j][i] = live ? in.z0[i * B + b] : 0.f;
    }
    stage_records(in, p, 0, C < H ? C : H, b0, B, ls_records(smem, C, 0), warp, 2 * W, l);
  });
  blk.commit();
  for (int c = 0; c <= chunks; ++c) {  // rollouts of chunk c, costs of chunk c - 1
    if (c + 1 < chunks) {
      const int lo = (c + 1) * C, hi = lo + C < H ? lo + C : H;
      blk.each([&](int warp, int l, LsThread&) {
        stage_records(in, p, lo, hi, b0, B, ls_records(smem, C, c + 1), warp, 2 * W, l);
      });
    }
    blk.commit();
    blk.wait_prior();  // this thread's copies of chunk c
    blk.sync();        // and every thread's
    blk.each([&](int warp, int l, LsThread& t) {
      const bool roller = warp < W;
      const int w = roller ? warp : warp - W, cc = roller ? c : c - 1;
      if (b0 + l >= B || cc < 0 || cc >= chunks) return;
      const int lo = cc * C, hi = lo + C < H ? lo + C : H;
      for (int j = 0; j < LS_TURNS; ++j) {
        const int a = w + j * W;
        if (a < A)
          candidate_chunk(roller, lo, hi, H, alphas.v[a], t.mu, ls_records(smem, C, cc),
                          ls_ring(smem, C, A, cc, a), l, p, t.z[j], t.acc[j]);
      }
    });
    blk.sync();  // chunk c - 1's records and ring are free again
  }
  blk.each([&](int warp, int l, LsThread& t) {
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
struct DeviceBlock {
  int warp, l;
  LsThread t;
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

__global__ void __launch_bounds__(2 * LS_MAX_WARPS * 32) linesearch_fm_kernel(
    STParams p, Alphas alphas, int A, int C, LsInputs in, float* __restrict__ costs, int B,
    int H) {
  extern __shared__ float smem[];
  DeviceBlock blk;
  blk.warp = threadIdx.x >> 5;
  blk.l = threadIdx.x & 31;
  linesearch_block(blk, p, alphas, A, C, in, smem, costs, (int)blockIdx.x * LS_SCEN, B, H);
}

extern "C" int vct_param_count() { return (int)(sizeof(STParams) / sizeof(float)); }

extern "C" const char* vct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

static cudaError_t linesearch_smem_setup(int A) {
  return cudaFuncSetAttribute(linesearch_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ls_smem(A, ls_chunk(A)));
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
  const LsInputs in{xref, uref, kff, kfb, lam, mu, curv, ds, z0};
  cudaError_t rc = linesearch_smem_setup(A);
  if (rc != cudaSuccess) return (int)rc;
  const int C = ls_chunk(A);
  linesearch_fm_kernel<<<(B + LS_SCEN - 1) / LS_SCEN, 2 * ls_warps(A) * 32, ls_smem(A, C),
                         (cudaStream_t)stream>>>(p, al, A, C, in, costs, B, H);
  return (int)cudaGetLastError();
}

// the launch shape at B scenarios and A step sizes (singletrack.cuh:
// kernel_launch_info; the lead number is the scenarios a block)
extern "C" int vct_linesearch_fm_info(int B, int A, int* out) {
  if (A < 1 || A > MAX_ALPHA || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t rc = linesearch_smem_setup(A);
  if (rc != cudaSuccess) return (int)rc;
  const int block = 2 * ls_warps(A) * 32;
  return kernel_launch_info(linesearch_fm_kernel, LS_SCEN,
                            (long long)(B + LS_SCEN - 1) / LS_SCEN * block, block,
                            ls_smem(A, ls_chunk(A)), out);
}

#endif
