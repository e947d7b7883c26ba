"""Smoke run of the torch port on one NVIDIA GPU.

Builds the five CUDA kernels from ``vehicle_control_tpu_torch/csrc`` with
nvcc (one process per source, all at once) and prints each kernel's
registers and stack, and for kernels 1-4 their launch shape (threads per
launch, shared memory per block, resident warps per SM).  Then it runs five
families at the bench's protocol (B=4096, f32, K=10 steps per chunk, states
from ``initial_states`` seed 0 with their aligned carries):

* the single-track family (``singletrack.yaml``, N=30, budget 2 outer x 5
  inner + 3 polish iterations, 6 line-search steps, mu0=300);
* the paper's cascade (``cascaded.yaml``, ``tail="pm"``: N=20 single-track
  and M=40 point-mass stages, H=60, budget 2 x 6 + 3 polish, 6 steps,
  mu0=300);
* the cascade with obstacles (bench.py's ``cascaded_obstacles``: the same
  cascade with ippodromo's seven discs as a barrier cost, budget 3 x 10 + 6
  polish, 8 steps, mu0=300, mu_scale=100, recovery above a violation of
  0.5; its drops clear of the discs, bench.py's ``avoid_obstacles``);
* the pure kinematic family (bench.py's ``kinematic``: ``kinematic.yaml``
  as shipped, N=50 running stages and the terminal stage, obstacles on,
  budget 2 x 3, 6 steps, mu0=10; the kinematic car's drops, v in [2, 8],
  clear of the discs), on the kernels' instantiation for its own parameter
  block (``_kin`` entries);
* the kc cascade (bench.py's ``cascaded_kinematic``:
  ``cascaded_kinematic.yaml``, ``tail="kc"``: N=20 single-track and 20
  kinematic-bicycle stages, H=40, obstacles off, budget 3 x 8 + 6 polish,
  6 steps, mu0=300), on its own instantiation (``_kc`` entries).

For each family it holds kernels 1 (line search), 2 (backward pass), 4
(stage derivatives), 5 (the line search in the array-of-structs layout,
also held to kernel 1's costs bit for bit) and 3 (the whole solve)
against their plain PyTorch versions on the inputs
of the solve after one closed-loop step whose solve is the plain whole
solve (so no kernel computed them; kernel 3 at the full budget on that
step's own cold first solve, both f32 versions against the plain version
in f64, which runs on the CPU in six processes beside the card's phases),
drives the main path (the whole solve
in one launch, kernel 3), 1 warm and 3 timed chunks, with exactly one
kernel-3 launch per step and nothing else, profiles one main-path step,
counts each kernel's work and times each kernel against its plain version
(kernels 1, 4 and 5 as the launch alone and with their wrappers; kernel
3's plain version, the plain whole solve, alone on the card for the
families of SOLVE_PLAIN_ALONE, and for every family as the checks' step
ran it, beside the other families' processes: ``sv_plain_shared_ms``).
For the single-track and the kinematic family it also drives the per-phase route
(kernels 1 + 2) and the derivatives route (kernel 4, the torch Riccati
sweep, kernel 1), 1 warm and 1 timed chunk of 1 step each, with their
launch counts.  Kernel 5 sits
on no route (as in the JAX package): it is launched only to be checked and
timed beside kernel 1.

Then the simulator, the system's entry point: ``RacingSimulator`` from
``configs/simconfig.yaml`` (cascaded, ippodromo; f32, kernel 3 at the
controller YAML's budget, B=1) laps to completion in chunks of 25 steps,
exactly one kernel-3 launch a step, no host sync inside a chunk; its lap
time is held to the JAX f64 lap, its artifacts are saved under
``build/simulator/`` and reloaded bit for bit; kernel 3 at B=1 on the
inputs of lap steps 0, 100 and 200 is held against the plain whole solve
in f32 and f64 (run on the CPU, in parallel processes).  Then the same
simulator with ``obstacles`` set to true laps ippodromo past its seven
discs: the lap completes, its lap time is within 10% of the JAX f64
obstacle lap's (``experiments/data/verify_obs_ippodromo``), the car keeps
farther than each disc's radius from its centre, and the side it passed
each disc on is printed beside the JAX lap's (the choice is multi-modal,
so it is not gated); its violations stay at most 1e-2, or else the lap is
replayed to the step of its largest violation and kernel 3 there is held
against the plain whole solve in f32 and f64, that violation included.
Then the kinematic lap:
``KinematicRacingSimulator`` from the simconfig with the ``kinematic``
controller (f32, kernel 3 at B=1 and the YAML's budget) laps ippodromo,
its lap time within 0.25 s of the JAX f64 kinematic lap, its violations at
most 1e-2, one kernel-3 launch a step, and kernel 3 on the inputs of its
steps 0, 100 and 200 against the plain whole solve in f32 and f64.  Last,
the kc lap: ``RacingSimulator`` from the simconfig with the
``cascaded_kinematic`` controller (f32, kernel 3 at B=1 and the YAML's
active budget, 4 x 12): the JAX f64 lap of this controller leaves the road
past s = 200 m and completes no lap (tests/cascaded_kinematic_lap_study.py),
so the port's run is held to its split time at s = 200 m within 0.25 s and
its violations up to there at most 1e-2, one kernel-3 launch a step, and
kernel 3 on the inputs of its steps 0, 100 and 200 against the plain whole
solve in f32 and f64.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of the kernels, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed
phase raises and the script exits non-zero; without CUDA it exits 1 and
prints no result.  Writes nothing outside ``build/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, K, TIMED_CHUNKS, DT = 4096, 10, 3, 0.05
SIDE_K, SIDE_TIMED_CHUNKS = 1, 1  # the two earlier routes, cut in depth
FAMILIES = {  # controller config, tail, its overrides, budget (bench.py's family table)
    "singletrack": ("singletrack.yaml", "none", dict(horizon=30),
                    dict(n_outer=2, n_inner=5, n_polish=3, n_alpha=6, mu0=300.0)),
    "cascaded": ("cascaded.yaml", "pm", dict(horizon=20, horizon_pm=40),
                 dict(n_outer=2, n_inner=6, n_polish=3, n_alpha=6, mu0=300.0)),
    "cascaded_obstacles": ("cascaded.yaml", "pm", dict(horizon=20, horizon_pm=40, obstacles=True),
                           dict(n_outer=3, n_inner=10, n_polish=6, n_alpha=8, mu0=300.0,
                                mu_scale=100.0, recover_viol=0.5)),
    "kinematic": ("kinematic.yaml", "kinematic", dict(obstacles=True),
                  dict(n_outer=2, n_inner=3, n_alpha=6, mu0=10.0)),
    "cascaded_kinematic": ("cascaded_kinematic.yaml", "kc", dict(horizon=20, horizon_kc=20),
                           dict(n_outer=3, n_inner=8, n_polish=6, n_alpha=6, mu0=300.0)),
}
# the simulator's laps (``simulator_lap``, ``simulator_obstacles_lap``)
LAPS = ("cascaded", "obstacles", "kinematic", "cascaded_kinematic")
# the families that also drive the two earlier routes (kernels 1 + 2, and
# kernel 4 with kernel 1), cut in depth
SIDE_ROUTES = ("singletrack", "kinematic")
# Kernel vs plain, at a real warm-started state, twice.  With the Riccati
# regularization rho = RHO_WELL both computations are well conditioned (the
# plain version in f32 stays within ~1e-5 of f64), so the kernel is held to
# direct tolerances: costs to LS_RTOL relative, gains to BW_TOL of each
# lane's largest magnitude, +inf lanes and PD-failure flags identical.
# With the solver's rho0 = 1e-6 both are ill conditioned in f32: the
# closed-loop rollouts under the Riccati gains amplify rounding (a few are
# chaotic) and the Riccati step cancels terms of order mu and the Fx-slew
# weight x FORCE_SCALE^2 (1e6), so two f32 versions that round differently
# differ by O(1) on some lanes though both are right.  There both f32
# versions are held against the plain version in f64 on the same f32
# inputs, lane by lane: at each gated quantile of the lane errors the
# kernel's is at most QUANT_FACTOR x the plain's plus a floor of f32
# rounding over H stages (the worst lanes, q0.999 and max, are chaotic in
# both and are printed, not gated); +inf lanes and flags stay identical.
# Kernel 5 runs kernel 1's block schedule from the (B, H, F) layout: it is
# held to kernel 1's gates and to kernel 1's costs bit for bit.
# Knife-edge lanes: a rollout that crosses the 1e7 state guard, or a solve
# lane that runs to V ~ 0, may fall on either side of a gate in two f32
# versions that round differently.  Where the kernel misses a lane-by-lane
# gate against the plain f32 version (kernels 1 and 5: +inf on a rollout in
# one of them; kernel 3 check (i): a lane beyond SOLVE_TOL), the plain
# version run in f64 on the same f32 inputs decides: the lane passes only if
# it sides with the kernel (the kernel's +inf verdict on those inputs, or,
# where the f32 verdict turns on the inputs' last bits, +inf verdicts that
# miss f64's on the inputs and ULP_COPIES copies of them one ulp apart at
# most the largest QUANT_FACTOR x as often as the plain f32 version's; an
# error against f64 at most the largest QUANT_FACTOR x the plain f32
# version's plus a floor: ``lane_witness``), and at most
# WITNESS_SHARE of a gate's lanes (or rollouts) may be decided so
# (``witness``).  The decided lanes are printed with their numbers.
# (In f64, a host build of the same CUDA sources matches the plain
# versions to 1e-15 in costs and 5e-15 in the gains.)
RHO_WELL = 1.0
LS_RTOL = 1e-4
BW_TOL = 1e-3
QUANT_FACTOR = {0.5: 4.0, 0.9: 4.0, 0.99: 4.0}
LS_FLOOR = 1e-6  # relative, costs |a - b| / max(|b|, 1)
BW_FLOOR = 1e-5  # per lane, |a - b| / (1 + max |b| of the lane)
# Kernel 4 involves no rho: g, Hw and J are direct functions of the inputs,
# so every lane is held to DV_TOL of its largest magnitude.
DV_TOL = 1e-4
WITNESS_SHARE, WITNESS_ROWS = 1e-3, 24  # the share; the decided lanes printed
ULP_COPIES = 64  # copies of a disputed rollout's inputs, one f32 ulp apart
# The families with obstacles have lanes at knife edges that the other
# families' gates leave no room for: a rollout beside a disc's
# floor, whose barrier term w ds / (d - R) amplifies the rounding of the
# states by d / (d - R); a PHR row on its boundary with a zero multiplier,
# whose activity (and so the Hessian and the gains) turns on the last bit
# of lam + mu c; and at RHO_WELL the steps beside a disc, whose barrier
# Hessian (1e5-1e7) rho = 1 does not condition.  For it the direct gates of
# kernels 1 and 5 (LS_RTOL), 2 (flags, finiteness, BW_TOL) and 4 (DV_TOL)
# take the same f64 witness as check (i), lane by lane, on at most
# FAMILY_SHARES of the lanes (gate -> share; the other families keep their
# direct gates, share 0, and WITNESS_SHARE).  In check (i) a lane that f64
# on its inputs gives to the plain version passes only if the kernel is as
# accurate on its inputs and ULP_COPIES copies of them one ulp apart
# (``copies_side``), as the +inf verdicts above.  The shares are the
# measured counts' (PERF.md) with room to spare.
# The kinematic family's 51-stage horizons run into the same discs (PERF.md:
# 1 rollout of 24,576 beyond LS_RTOL, kernel 2 30 lanes at rho = 1 and 11
# at rho0, check (i) 213 of 4,096; kernel 4 none, it keeps its direct gate).
# The kc cascade's kinematic tail brings the kinematic bicycle's steering
# stop and box rows, and its acceleration, whose curvature is only the PHR
# rows' where the a-slew's mask is dead, leaves many Riccati steps not PD at
# rho0 (PERF.md: kernel 2 15 lanes at rho = 1 and 40 at rho0, check (i) 16
# of 4,096; kernels 1, 5 and 4 none, they keep their direct gates).
FAMILY_SHARES = {
    "cascaded_obstacles": dict(rtol=WITNESS_SHARE, kernel2=1e-2, kernel4=1e-2, solve=5e-2),
    "kinematic": dict(rtol=WITNESS_SHARE, kernel2=1e-2, solve=1e-1),
    "cascaded_kinematic": dict(rtol=WITNESS_SHARE, kernel2=2e-2, solve=1e-2),
}
# The gates of a family where a lane that f64 on its inputs gives to the
# plain version is decided on the inputs and ULP_COPIES copies of them one
# ulp apart (``copies_side``): check (i) ("solve") on the obstacle cascade;
# check (i) and kernel 2 on the kinematic family (PERF.md: 1 lane of check
# (i), 1 of kernel 2 at each regularization) and on the kc cascade (PERF.md:
# 4 lanes of check (i), 2 of kernel 2 at rho = 1).
FAMILY_COPIES = {"cascaded_obstacles": ("solve",), "kinematic": ("solve", "kernel2"),
                 "cascaded_kinematic": ("solve", "kernel2")}
# Kernel 3, (i) one outer x one inner iteration at rho0 = RHO_WELL: the
# chosen step is identical on >= STEP_SAME of the lanes, and on those X, U
# (per lane, of the lane's magnitude) and cost (relative) agree to SOLVE_TOL.
# (ii) the full budget at the solver's rho0 on the cold first solve of the
# checks' closed-loop step (the aligned carry, zero multipliers): the f32
# rounding of either version tips Armijo ties and chaotic lanes, so it is
# held to the gates of the JAX package's own kernel-vs-solver check
# (tests/test_solve_kernel_flow.py: _compare): converged fractions within
# CONV_GAP, converged-flag flips on fewer than FLIP_MAX of the lanes with
# the kernel's cost no worse on a majority of them, median relative cost
# difference on lanes converged in both below COST_MEDIAN, iterations
# within 2 on at least ITER_WITHIN2.  On the single track's cold solve two
# f32 versions part on about a fifth of the lanes (so do the JAX package's
# solver in f32 and in f64, PERF.md), so both f32 versions are held against
# the plain version in f64 and each gate is taken beyond the plain f32
# version's own number there (``solve_gates``).
# (iii) early exit and the alpha=1 fast path change no output bit.
SOLVE_TOL = 1e-4
STEP_SAME = 0.999
CONV_GAP, FLIP_MAX, COST_MEDIAN, ITER_WITHIN2 = 0.02, 0.02, 1e-4, 0.95
CONV_FLOOR = 0.90  # sanity gate on the converged fraction, not a target
# the kernels timed median of REPS; the plain versions once, without a
# warm-up (they ran on the same shapes in the checks)
REPS, PLAIN_REPS = 20, 1
# The plain whole solve (kernel 3's plain version) takes 8 s (kinematic) to
# 3.5 minutes (the obstacle cascade) at B=4096: each family's is timed as
# the checks' closed-loop step runs it (``start_warm``: five such processes
# and the checks share the card and the host), and only these families'
# again, alone on the card, for its ``plain_ms`` (the others' is null)
SOLVE_PLAIN_ALONE = ("kinematic", "cascaded_kinematic")
# the family whose numbers stand at the top of each kernel in the kernels
# line (the slice that added it; ``per_family`` has every family's)
TOP_FAMILY = "cascaded_kinematic"
# Check (ii)'s plain solve in f64 of the families named here runs on the CPU
# on their first 1024 lanes, in one pool of CPU_WORKERS processes shared by
# the families, beside the card's phases: the plain whole solve is
# launch-bound on the card at any B (~1.5-2 minutes for the single track and
# the cascade in each precision, ~3-5 for the obstacle cascade's 36 inner
# iterations), and six CPU processes take B=4096 lanes of the single track
# in about one.
CPU_F64_LANES = {"singletrack": 1024, "cascaded": 1024, "cascaded_obstacles": 1024,
                 "cascaded_kinematic": 1024}
CPU_WORKERS = 6
# the card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores and HBM bandwidth, for each kernel's bound
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
OP_COUNT_LANES = 64
DEVICE = "cuda"
# The simulator's lap: at most LAP_MAX_STEPS steps in chunks of LAP_CHUNK;
# its lap time within LAP_TOL_S of the JAX package's f64 lap in
# experiments/data/verify_r5final_ippodromo (417 steps of 0.05 s), its
# violations at most LAP_VIOL_MAX (the simulator log's threshold).  On the
# inputs of the steps SNAP_STEPS kernel 3's first action is within
# ACTION_TOL of the plain version's in f64, relative to the lap's RMS of
# that action, or no farther from it than the plain f32 version's plus
# ACTION_FLOOR.
LAP_MAX_STEPS, LAP_CHUNK, SYNC_CHECK_STEPS = 600, 25, 3
LAP_REF_S, LAP_TOL_S, LAP_VIOL_MAX = 20.85, 0.25, 1e-2
# The kinematic lap: the simconfig with the kinematic controller through
# KinematicRacingSimulator; its lap time within LAP_TOL_S of the JAX
# package's f64 kinematic lap (tests/kinematic_lap_study.py: 375 steps, no
# violation), its violations at most LAP_VIOL_MAX; the first actions on its
# SNAP_STEPS as the cascade lap's.
KIN_LAP_REF_S = 18.75
# The kc lap: the simconfig with the cascaded_kinematic controller through
# RacingSimulator, KC_LAP_MAX_STEPS steps (20 s of race: past the split and
# past where the JAX lap runs wide).  The JAX f64 lap of this
# controller (tests/cascaded_kinematic_lap_study.py: step 276 at t = 13.80
# s past s = 200 m, its violations up to there at most 1.09e-3) runs wide
# past s ~ 222 m (|ey| beyond the dynamics' 8 m clamp, KC_EY_WIDE, then up
# to 37 m) and completes no lap in 800 steps, so the port's run is held to
# the split time at KC_SPLIT_M (the t of the first state past it) within
# LAP_TOL_S of the JAX lap's KC_SPLIT_REF_S, and to violations at most
# LAP_VIOL_MAX up to there; past the split it is printed, not gated.
KC_SPLIT_M, KC_SPLIT_REF_S, KC_EY_WIDE, KC_LAP_MAX_STEPS = 200.0, 13.80, 8.0, 400
# The obstacle lap: the same simulator with obstacles on, at most
# OBS_LAP_MAX_STEPS steps; its lap time within OBS_LAP_TOL (relative) of the
# JAX package's f64 obstacle lap in OBS_REF_RUN (553 steps), every disc
# cleared (the least (s, ey) distance to its centre above its radius), its
# violations at most LAP_VIOL_MAX.  The JAX f64 lap itself exceeds that on
# a few steps (tests/obstacle_lap_study.py: 5, at most 0.1105), so where the
# port's lap does, the step of its largest violation is replayed and the
# plain whole solve in f32 and f64 runs on the same inputs (its first
# action printed beside kernel 3's, as on SNAP_STEPS): kernel 3's violation
# there is at most the largest QUANT_FACTOR x the larger of theirs plus
# LAP_VIOL_MAX (a state that the plain solve also leaves violated at this
# budget is no kernel fault; the JAX f64 lap's own spikes are near the same
# place, steps 178 and 181).
OBS_LAP_MAX_STEPS, OBS_LAP_TOL = 800, 0.10
OBS_REF_RUN = os.path.join("experiments", "data", "verify_obs_ippodromo")
SNAP_STEPS = (0, 100, 200)
ACTION_TOL, ACTION_FLOOR = 1e-3, 1e-5
# On the kinematic lap a step that misses that gate is decided by the f64
# witness (``lane_witness``: kernel 3's error against f64 at most the
# largest QUANT_FACTOR x the plain f32 version's plus ACTION_FLOOR), on at
# most LAP_SHARES of its SNAP_STEPS: the family can be multi-modal, and at
# its step 200 both f32 solves part from f64 by ~0.13 of the lap's RMS
# action (PERF.md).  The cascade lap keeps the gate.
LAP_SHARES = {"kinematic_vs_plain": 1 / len(SNAP_STEPS)}


_T0 = time.perf_counter()


def phase(label, **fields):
    """One phase's line, with the seconds since the script started (t_s)."""
    fields["t_s"] = f"{time.perf_counter() - _T0:.1f}"
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps=REPS, warm=True, runs=None):
    """Median milliseconds of fn() over reps runs, timed with CUDA events;
    each run's (host start, host end, ms) appended to ``runs`` if given."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if runs is not None:
            runs.append((t0, time.time(), times[-1]))
    return statistics.median(times)


def time_modes(times, gap=0.05):
    """The times split at their largest gap, where it exceeds ``gap`` x the
    median (else one mode): a list of lists, fastest first."""
    t = sorted(times)
    gaps = [b - a for a, b in zip(t, t[1:])]
    if not gaps or max(gaps) <= gap * statistics.median(t):
        return [t]
    i = gaps.index(max(gaps)) + 1
    return [t[:i], t[i:]]


# nvidia-smi's fields for the clock samples beside kernel 3's timed launches
SMI_CLOCKS = ("timestamp", "clocks.sm", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


@contextlib.contextmanager
def sampled_clocks(period_ms=20):
    """Sample SMI_CLOCKS with nvidia-smi every period_ms while the block
    runs; yields a list that holds (host time, sm MHz, watts, deg C,
    throttle reasons) afterwards, empty if nvidia-smi gave none."""
    samples = []
    proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={','.join(SMI_CLOCKS)}",
                             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    time.sleep(1.0)  # its first sample
    try:
        yield samples
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        for ln in out.splitlines():
            f = [x.strip() for x in ln.split(",")]
            try:
                at = datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                samples.append((at, float(f[1]), float(f[2]), float(f[3]), f[4]))
            except (ValueError, IndexError):
                continue


def clock_modes(runs, samples):
    """Each mode of the timed runs: its count, median ms, and the clock
    samples taken during its runs (SM MHz and watts min-max, throttle
    reasons seen)."""
    out = {}
    for i, mode in enumerate(time_modes([ms for _, _, ms in runs])):
        lo, hi = mode[0], mode[-1]
        inside = [s for t0, t1, ms in runs if lo <= ms <= hi for s in samples if t0 <= s[0] <= t1]
        row = f"{len(mode)}x{statistics.median(mode):.3f}ms({lo:.3f}-{hi:.3f})"
        if inside:
            mhz, watts = [s[1] for s in inside], [s[2] for s in inside]
            row += (f",samples:{len(inside)},sm_mhz:{min(mhz):.0f}-{max(mhz):.0f}"
                    f",watts:{min(watts):.0f}-{max(watts):.0f}"
                    f",deg_c:{max(s[3] for s in inside):.0f}"
                    f",throttle:{'|'.join(sorted({s[4] for s in inside}))}")
        else:
            row += ",clocks:not_measured"
        out[f"mode{i}"] = row
    return out


def lane_errors(a, b):
    """Per lane (batch axis 0): max |a - b| / (1 + max |b| of the lane)."""
    a, b = a.double(), b.double()
    scale = 1.0 + b.abs().reshape(b.shape[0], -1).amax(-1)
    return (a - b).abs().reshape(b.shape[0], -1).amax(-1) / scale


def worst_entry(a, b):
    """Where lane_errors(a, b) peaks: 'lane/stage/field:kernel/plain'."""
    err = lane_errors(a, b)
    lane = int(err.argmax())
    flat = int((a[lane].double() - b[lane].double()).abs().argmax())
    stage, field = divmod(flat, a.shape[-1])
    return f"{lane}/{stage}/{field}:{a[lane, stage, field].item():.6g}/{b[lane, stage, field].item():.6g}"


def well_config(budget):
    """Check (i)'s solver: one outer x one inner iteration at rho0 = RHO_WELL."""
    from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig

    return ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=budget["n_alpha"],
                        mu0=budget["mu0"], rho0=RHO_WELL)


def finite_lanes(ts):
    """(B,) bool: every entry of every tensor finite on the lane (batch axis 0)."""
    ok = torch.ones(ts[0].shape[0], dtype=torch.bool, device=ts[0].device)
    for t in ts:
        ok &= torch.isfinite(t.reshape(t.shape[0], -1)).all(-1)
    return ok


def cost_errors(a, b):
    """Per finite cost: |a - b| / max(|b|, 1)."""
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp_min(1.0)


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def accuracy(what, kern_err, plain_err, floor):
    """Whether the kernel's errors against f64 are, at each gated quantile,
    within QUANT_FACTOR of the plain f32 version's plus floor: (the
    quantiles kernel/plain as text, the first gate missed or None)."""
    out, missed = [], None
    for q in (*QUANT_FACTOR, 0.999, 1.0):
        k, p = (torch.quantile(e, q).item() for e in (kern_err, plain_err))
        out.append(f"q{q:g}:{k:.2e}/{p:.2e}")
        factor = QUANT_FACTOR.get(q)
        if missed is None and factor is not None and not k <= factor * p + floor:
            missed = (f"{what}: kernel vs f64 at quantile {q} is {k:.3e}, plain f32 vs f64 "
                      f"{p:.3e} (allowed {factor} x plain + {floor})")
    return ",".join(out), missed


def as_accurate(what, kern_err, plain_err, floor):
    """``accuracy``'s text; raise if a gate was missed."""
    text, missed = accuracy(what, kern_err, plain_err, floor)
    if missed:
        raise RuntimeError(missed)
    return text


def backward_gates(what, got, ref, ref64=None, decided=None):
    """Kernel 2's gates at one regularization.  ``got``: a build's (kff,
    Kfb, dV1, dV2, fail); ``ref``: the plain f32 version's on the same
    inputs; ``ref64``: the plain version's in f64 at the solver's rho0, None
    at rho = RHO_WELL; ``decided``: (B,) bool, lanes the f64 witness
    decided (``lane_witness``), left out.  The fail flags and the lanes
    with non-finite gains must be the same in both (a lane whose warm start
    diverged can overflow its gains; such lanes are not compared); at
    RHO_WELL each output's lane errors are held to BW_TOL, at rho0 their
    quantiles against f64 to the plain f32 version's (``accuracy``,
    BW_FLOOR).  Returns (the rows, the largest |got - ref| over the compared
    lanes, the first gate missed or None)."""
    missed = []
    keep = torch.ones_like(got[4]) if decided is None else ~decided
    if not torch.equal(got[4][keep], ref[4][keep]):
        missed.append(f"{what}: fail flags differ on {(got[4] != ref[4])[keep].sum().item()} lanes")
    ok_ref, ok_got = finite_lanes(ref[:4]), finite_lanes(got[:4])
    if not torch.equal(ok_got[keep], ok_ref[keep]):
        missed.append(f"{what}: the lanes with non-finite gains differ")
    ok = ok_ref & ok_got & keep
    ok64 = ok if ref64 is None else ok & finite_lanes(ref64[:4])
    rows, abs_err = {}, 0.0
    for i, key in enumerate(("kff", "Kfb", "dV1", "dV2")):
        a, b = got[i], ref[i]
        kp = lane_errors(a[ok], b[ok])
        abs_err = max(abs_err, (a[ok] - b[ok]).abs().max().item())
        rows[key] = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
        if ref64 is None:
            if not kp.max() <= BW_TOL:
                missed.append(f"{what}: {key} error {kp.max():.3e}")
            continue
        c = ref64[i][ok64]
        text, miss = accuracy(f"{what} {key}", lane_errors(a[ok64], c), lane_errors(b[ok64], c),
                              BW_FLOOR)
        rows[key] += ",vs_f64:" + text
        missed += [miss] if miss else []
    rows["fail_lanes"] = int(got[4].sum())
    rows["nonfinite_lanes"] = int((~ok_ref).sum())
    return rows, abs_err, (missed[0] if missed else None)


def solve_numbers(got, ref):
    """The JAX gates' numbers for solve outputs ``got`` against ``ref``
    (both with the trace)."""
    conv_g, conv_r = got[5].cpu().numpy(), ref[5].cpu().numpy()
    cost_g, cost_r = got[3].double().cpu().numpy(), ref[3].double().cpu().numpy()
    flip = conv_g != conv_r
    both = conv_g & conv_r
    dcost = np.abs(cost_g[both] - cost_r[both]) / (1.0 + np.abs(cost_r[both]))
    d_it = got[6].cpu().numpy().astype(int) - ref[6].cpu().numpy()
    return dict(
        conv_gap=abs(conv_g.mean() - conv_r.mean()), flips=flip.mean(),
        no_worse=((cost_g[flip] <= cost_r[flip] + 1e-3 * (1.0 + np.abs(cost_r[flip]))).mean()
                  if flip.any() else 1.0),
        both=both.mean(), cost_median=np.median(dcost) if both.any() else np.inf,
        within2=(np.abs(d_it) <= 2).mean(), iters_equal=(d_it == 0).mean())


def solve_gates(got, ref, ref64):
    """Check (ii): kernel 3's outputs ``got`` and the plain f32 version's
    ``ref`` against the plain version in f64 ``ref64`` (all with the
    trace).  The kernel passes the JAX gates against f64, each taken beyond
    the plain f32 version's own number: converged-fraction gap at most the
    plain's + CONV_GAP, flips below the plain's + FLIP_MAX, cost median
    below QUANT_FACTOR x the plain's + COST_MEDIAN (as ``as_accurate``), no
    worse on flips and iterations within 2 on at least the lesser of the
    plain's share and the JAX threshold.  Returns the rows (each number
    kernel/plain against f64, and the kernel against the plain f32 version)
    and whether it passed."""
    k, p, kp = solve_numbers(got, ref64), solve_numbers(ref, ref64), solve_numbers(got, ref)
    passed = (k["conv_gap"] <= p["conv_gap"] + CONV_GAP and k["flips"] < p["flips"] + FLIP_MAX
              and k["no_worse"] >= min(p["no_worse"], 0.5) and k["both"] > 0.5
              and k["cost_median"] < QUANT_FACTOR[0.5] * p["cost_median"] + COST_MEDIAN
              and k["within2"] >= min(p["within2"], ITER_WITHIN2))
    runs = got[7]["inner_runs"]
    rows = dict(conv=f"{got[5].float().mean().item():.4f}/{ref[5].float().mean().item():.4f}"
                     f"/{ref64[5].float().mean().item():.4f}",
                **{f"{key}_vs_f64": f"{k[key]:.4g}/{p[key]:.4g}" for key in k},
                **{f"{key}_vs_plain": f"{kp[key]:.4g}" for key in kp},
                runs_mean=f"{runs.float().mean().item():.2f}", runs_max=int(runs.max()))
    return rows, passed


def witness(what, disputed, kernel_side, numbers, total, share=WITNESS_SHARE):
    """The witness of a lane-by-lane gate (the plain version in f64:
    ``lane_witness``, ``inf_witness``).  ``disputed`` (bool): the
    lanes where the kernel missed the gate against the plain f32 version;
    ``kernel_side`` (bool, same shape): where the witness sides with the
    kernel; ``numbers``: name -> tensor of that shape, printed for
    each decided lane.  Raises if the witness sides with the plain version
    on a disputed lane, or if more than ``share`` of the ``total`` lanes are
    disputed; returns the count and the decided lanes as text."""
    idx = disputed.nonzero().tolist()
    row = lambda i: "/".join(map(str, i)) + ":" + ",".join(  # noqa: E731
        f"{k}={v[tuple(i)].item():.4g}" for k, v in numbers.items())
    lost = [i for i in idx if not kernel_side[tuple(i)]]
    if lost:
        raise RuntimeError(f"{what}: the witness sides with the plain version on {len(lost)} of "
                           f"{len(idx)} disputed lanes: {' '.join(map(row, lost))}")
    if len(idx) > share * total:
        raise RuntimeError(f"{what}: {len(idx)} of {total} lanes decided by the witness "
                           f"(at most {share}): {' '.join(map(row, idx))}")
    rows = [row(i) for i in idx[:WITNESS_ROWS]] + (["..."] if len(idx) > WITNESS_ROWS else [])
    return f"{len(idx)}" + "".join(f"|{r}" for r in rows)


def inf_witness(what, costs, costs_ref, costs64, copies=None):
    """Kernels 1 and 5's gate "+inf rollouts identical" (A, B): where the
    kernel and the plain f32 version disagree on +inf, the plain version in
    f64 decides.  It sides with the kernel where it gives the kernel's
    verdict on the same f32 inputs.  Where it does not, ``copies`` (the
    kernel's, the plain f32 version's and the f64 costs, each (copies, A,
    B), NaN where not computed; ``copy_costs``) on copies of the inputs one
    f32 ulp apart measure each f32 version's +inf verdicts against f64's
    (``kernel_wrong``, ``plain_wrong``: on the inputs and their copies;
    ``f64_inf``: the copies f64 puts beyond the guard): it
    sides with the kernel where the kernel misses f64's verdict at most the
    largest QUANT_FACTOR x as often as the plain f32 version does (as
    ``as_accurate`` holds the costs), so on a rollout whose +inf verdict in
    f32 turns on the inputs' last bits the kernel must be as accurate as
    the plain version."""
    inf_k, inf_p, inf_64 = (torch.isposinf(c) for c in (costs, costs_ref, costs64))
    wrong_k, wrong_p = (inf_k != inf_64).long(), (inf_p != inf_64).long()
    inf_copies = torch.zeros_like(wrong_k)
    side = inf_k == inf_64
    if copies is not None:
        kc, pc, dc = copies
        seen = ~torch.isnan(dc)
        inf_d = torch.isposinf(dc)
        wrong_k = wrong_k + ((torch.isposinf(kc) != inf_d) & seen).sum(0)
        wrong_p = wrong_p + ((torch.isposinf(pc) != inf_d) & seen).sum(0)
        inf_copies = inf_d.sum(0)
        side = side | (seen.any(0) & (wrong_k <= max(QUANT_FACTOR.values()) * wrong_p))
    return witness(what, inf_k != inf_p, side,
                   dict(kernel=costs, plain=costs_ref, f64=costs64, kernel_wrong=wrong_k,
                        plain_wrong=wrong_p, f64_inf=inf_copies), costs.numel())


def ulp_copies(args, lanes, copies=ULP_COPIES, exact=(), seed=0):
    """``copies`` copies of the lanes ``lanes`` (batch axis 0) of the f32
    inputs ``args``, copy-major, each entry moved one f32 ulp up or down at
    random.  The inputs at the indices ``exact`` (configuration values) are
    copied unchanged."""
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    out = []
    for i, t in enumerate(args):
        x = t[lanes].repeat(copies, *[1] * (t.dim() - 1))
        if i not in exact:
            up = torch.rand(x.shape, generator=g, device=x.device) < 0.5
            x = torch.nextafter(x, torch.where(up, torch.inf, -torch.inf).to(x.dtype))
        out.append(x.contiguous())
    return out


def copy_costs(costs_of, copies, lanes, shape):
    """(copies, A, B) costs of the copies (``ulp_copies`` of the lanes
    ``lanes``) by ``costs_of`` (inputs -> (A, copies x lanes) costs), NaN
    on every other lane."""
    n = copies[0].shape[0] // len(lanes)
    out = torch.full((n, *shape), torch.nan, dtype=torch.float64, device=copies[0].device)
    got = costs_of(*copies).double()
    out[:, :, lanes] = got.reshape(shape[0], n, len(lanes)).movedim(1, 0)
    return out


def backward_disputes(got, ref, well):
    """(B,) bool: the lanes where kernel 2's outputs ``got`` miss a
    lane-by-lane gate against the plain f32 version's ``ref``: the fail flag
    or the gains' finiteness differ, or (``well``: at RHO_WELL) an output is
    beyond BW_TOL."""
    ok_got, ok_ref = finite_lanes(got[:4]), finite_lanes(ref[:4])
    out = (got[4] != ref[4]) | (ok_got != ok_ref)
    both = ok_got & ok_ref
    if well and both.any():
        for a, b in zip(got[:4], ref[:4]):
            err = torch.zeros(out.shape, dtype=torch.float64, device=out.device)
            err[both] = lane_errors(a[both], b[both])
            out |= err > BW_TOL
    return out


def backward_lane_errors(out, ref64, well):
    """(B,): kernel 2's outputs ``out`` against the plain version's in f64
    ``ref64``, for ``lane_witness``: inf where the fail flag or the gains'
    finiteness differs from f64's, else (``well``: at RHO_WELL) the lane's
    worst error of kff, Kfb, dV1 and dV2 (0 at rho0, where only the flags
    and finiteness are lane-by-lane gates)."""
    ok, ok64 = finite_lanes(out[:4]), finite_lanes(ref64[:4])
    err = torch.zeros(ok.shape, dtype=torch.float64, device=ok.device)
    both = ok & ok64
    if well and both.any():
        for a, c in zip(out[:4], ref64[:4]):
            err[both] = torch.maximum(err[both], lane_errors(a[both], c[both]))
    err[(out[4] != ref64[4]) | (ok != ok64)] = torch.inf
    return err


def lane_witness(what, disputed, kern64, plain64, floor, share=WITNESS_SHARE, edge=None,
                 total=None, **numbers):
    """The plain version in f64 as the witness of a lane-by-lane gate.
    ``disputed`` (bool): the lanes (or rollouts) where the kernel missed
    the gate against the plain f32 version; ``kern64``, ``plain64`` (same
    shape): the kernel's and the plain f32 version's errors against f64 on
    the same f32 inputs.  It sides with the kernel where the kernel's error
    is at most the largest QUANT_FACTOR x the plain's plus ``floor``; where
    it does not, ``edge`` (1-D lanes only: the lanes -> (bool, name ->
    numbers) for them, ``copies_side``), if given, may still side with it.
    At most ``share`` of the ``total`` lanes (all by default; ``witness``)."""
    side = kern64 <= max(QUANT_FACTOR.values()) * plain64 + floor
    near = torch.zeros_like(disputed)
    numbers = dict(numbers, kernel_f64=kern64, plain_f64=plain64)
    lanes = (disputed & ~side).nonzero()[:, 0] if edge is not None else []
    if len(lanes):
        near[lanes], more = edge(lanes)
        for k, v in more.items():
            numbers[k] = torch.full(disputed.shape, torch.nan, dtype=torch.float64,
                                    device=disputed.device)
            numbers[k][lanes] = v.double()
    return witness(what, disputed, side | near, dict(numbers, copies=near.long()),
                   disputed.numel() if total is None else total, share)


def copies_side(lanes, kernel_fn, plain_fn, err_fn, args, floor, exact=()):
    """(the lanes' bool, their numbers) for ``lane_witness``: where a lane's
    error turns on its inputs' last bits, the kernel (``kernel_fn``) and the
    plain f32 version (``plain_fn``) run on the lanes' f32 inputs ``args``
    and on ULP_COPIES copies of them one ulp apart (``ulp_copies``), each
    against the plain version in f64 on the same copy (``err_fn``: outputs,
    f64 outputs -> (n,) errors); it sides with the kernel where the kernel's
    mean error is at most the largest QUANT_FACTOR x the plain f32
    version's plus ``floor``, as ``inf_witness`` counts the +inf verdicts
    of both on copies (``exact``: the indices of ``args`` not perturbed, as
    ``ulp_copies`` takes them)."""
    ins = [torch.cat([t[lanes], c]) for t, c in zip(args, ulp_copies(args, lanes, exact=exact))]
    ref64 = plain_fn(*(t.double() for t in ins))
    n = len(lanes)  # copy c of lane i sits at (c + 1) * n + i, the lane itself at i
    kern = err_fn(kernel_fn(*ins), ref64).reshape(-1, n).mean(0)
    plain = err_fn(plain_fn(*ins), ref64).reshape(-1, n).mean(0)
    return (kern <= max(QUANT_FACTOR.values()) * plain + floor,
            dict(kernel_copies=kern, plain_copies=plain))


def solve_errors(a, b):
    """(B,): each lane's worst error of X, U (``lane_errors``) and cost
    (``cost_errors``, where both are finite) of solve outputs ``a`` against
    ``b``."""
    e = torch.maximum(lane_errors(a[0], b[0]), lane_errors(a[1], b[1]))
    ok = torch.isfinite(a[3]) & torch.isfinite(b[3])
    e[ok] = torch.maximum(e[ok], cost_errors(a[3][ok], b[3][ok]))
    return e


# data movement and tensor creation: no arithmetic for the operation count
_NO_OPS = frozenset(
    "aten." + n for n in (
        "select slice view _unsafe_view reshape expand permute transpose t unsqueeze squeeze "
        "unbind split split_with_sizes stack cat clone copy_ _to_copy detach alias lift_fresh "
        "scalar_tensor empty zeros ones full full_like zeros_like ones_like empty_like new_zeros "
        "new_empty new_full new_ones fill_ zero_ index index_put_ gather index_select as_strided "
        "contiguous arange _local_scalar_dense lift_fresh_copy resize_ set_ expand_as movedim "
        "empty_strided"
    ).split()
)


def count_ops(fn):
    """Run fn() and count its arithmetic: one operation per output element of
    each elementwise op (transcendentals included as one), one per input
    element of a reduction, 2*M*N*K per matrix product."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket)
            if name in _NO_OPS:
                return out
            if name in ("aten.mm", "aten.bmm"):
                a, b = args[0], args[1]
                self.ops += 2 * a.numel() * b.shape[-1]
            elif name in ("aten.sum", "aten.amax", "aten.amin", "aten.any", "aten.all",
                          "aten.max", "aten.min", "aten.mean"):
                self.ops += args[0].numel()
            else:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.ops += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
            return out

    with Counter() as counter:
        fn()
    return counter.ops


def start_count_build():
    """Start g++ on the host build of the kernels' lane bodies whose floats
    count their arithmetic (``csrc/op_count.h``); returns (the library's
    path, the compiler's process or None where the build exists)."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    path, args = cuda_lib.host_library(("-DVCT_COUNT_OPS",))
    if os.path.exists(path):
        return path, None
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the bounds of kernels 2-4 count their code's "
                           "operations in a host build")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path, subprocess.Popen([cxx, *args, "-o", f"{path}.{os.getpid()}"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_count_build(path, proc):
    """The counting host build that ``start_count_build`` started, loaded."""
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{out[-4000:]}")
        os.replace(proc.args[-1], path)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in ("", "_kin", "_kc"):  # the cascaded family's, the kinematic, the kc
        getattr(lib, "vct_host_derivs" + suffix).argtypes = [P] * 10 + [I, I]
        getattr(lib, "vct_host_backward" + suffix).argtypes = [P] + [P] * 11 + [I, I]
    lib.vct_host_ops.restype = ctypes.c_double
    return lib


def code_op_counts(lib, fam, dv_args, bw_args):
    """Per lane: the f32 operations that the code of kernel 4 (the stage
    derivatives) and of kernel 2 (the derivatives and the team's Riccati
    sweep) does on these inputs, their lane bodies run by the counting host
    build ``lib`` on CPU copies (one per +, -, *, /, negation and math
    function; comparisons and selects free)."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    H, NZ, NU = fam.H, fam.NZ, fam.NU
    NW, L = NZ + NU, dv_args[0].shape[0]
    params = cuda_lib.family_params(fam)
    dv = [cuda_lib.soa(t.cpu()) for t in dv_args] + [
        torch.empty(s) for s in ((H, NW, L), (H, NW, NW, L), (H, NZ, NW, L))]
    bw = [cuda_lib.soa(t.cpu()) for t in bw_args] + [
        torch.empty(s) for s in ((H, NU, L), (H, NU, NZ, L), (2, L), (L,))]
    counts = []
    for fn, ts in ((getattr(lib, cuda_lib.entry(fam, "vct_host_derivs")), dv),
                   (getattr(lib, cuda_lib.entry(fam, "vct_host_backward")), bw)):
        lib.vct_host_ops()
        if fn(params.ctypes.data, *[t.data_ptr() for t in ts], L, H):
            raise RuntimeError("the counting host build refused its inputs")
        counts.append(lib.vct_host_ops() / L)
    return counts


def unlaunched(kernels):
    """The (kernel, family) pairs of the kernels line that were launched on
    no path: kernel 5 sits on no route; every other kernel must have run,
    in all (its top-level count), in each family that drives the earlier
    routes (SIDE_ROUTES), and kernel 3 in every family."""
    out = []
    for k in kernels:
        if k["name"] == "linesearch_aos":
            continue
        if k["launches"] < 1:
            out.append((k["name"], "all"))
        out += [(k["name"], label) for label, per in k["per_family"].items()
                if per["launches"] < 1 and (label in SIDE_ROUTES or k["name"] == "solve_fm")]
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(ms, what binds): the least time for these bytes and operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def drive(step, carry, states, wrappers, expected, k, chunks, label):
    """Chunks of k chained steps with the host fetch of the last step's
    converged flags as the barrier; every wrapper's count is set to 0 first
    and each chunk must launch ``expected`` (wrapper -> launches per step).
    Returns (carry, states, timed step seconds, converged fraction)."""
    for w in wrappers:
        w.launches = 0
    times, conv = [], None
    for chunk in range(chunks):
        before = [w.launches for w in wrappers]
        ok = torch.ones((), dtype=torch.bool, device=states.device)
        t0 = time.perf_counter()
        for _ in range(k):
            carry, states, action, info = step(carry, states)
            ok &= torch.isfinite(action).all() & torch.isfinite(states).all()
        conv = info.converged.cpu()
        elapsed = time.perf_counter() - t0
        if not bool(ok):
            raise RuntimeError(f"{label} chunk {chunk}: a non-finite action or state")
        counts = [w.launches - b for w, b in zip(wrappers, before)]
        want = [k * expected.get(w, 0) for w in wrappers]
        if counts != want:
            raise RuntimeError(f"{label} chunk {chunk}: launches {counts}, expected {want}")
        if chunk:
            times.append(elapsed / k)
    return carry, states, times, conv.float().mean().item()


def family_model(label, env):
    """(car config, plant transition, the plant state's s index, its fields)
    of a family: the kinematic car for the kinematic family, the dynamic car
    for the others."""
    if FAMILIES[label][1] == "kinematic":
        return env["kin_car"], env["kin_transition"], 2, 6
    return env["car"], env["transition"], 4, 8


def build_problem(label, car, track, dtype, device, root):
    """A family's problem on ``device`` in ``dtype``."""
    from vehicle_control_tpu_torch.controllers.mpc import problems

    ctrl, tail = family_ctrl(label, root)
    if tail == "kinematic":
        return problems.build_kinematic_problem(car, track, ctrl, dtype, device)
    return problems.build_cascaded_problem(car, track, ctrl, tail, dtype, device)


def family_problem(label, env):
    """(problem, budget, main-path config, main-path step, shape fields)."""
    from vehicle_control_tpu_torch.parallel.batch import make_batched_racing_step
    from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig

    car, transition, s_index, _ = family_model(label, env)
    budget = FAMILIES[label][3]
    problem = build_problem(label, car, env["track"], torch.float32, env["dev"], env["root"])
    fam = problem.family
    shape = (dict(B=B, N=fam.N, M=fam.H - fam.N) if fam.tail == "pm"
             else dict(B=B, N=fam.N, horizon_kc=fam.H - fam.N) if fam.tail == "kc"
             else dict(B=B, H=fam.H))
    if fam.obstacles:
        shape["discs"] = len(fam.obstacles)
    cfg = ALILQRConfig(**budget, use_solve_kernel=True)
    main_step = make_batched_racing_step(problem, cfg, transition, env["tdata"], DT, s_index)
    return problem, budget, cfg, main_step, shape


class PlainSolve:
    """The plain whole solve (``solve_plain``) where a step takes its solve
    kernel (``make_mpc_step``'s ``kernels``); keeps its last call's inputs,
    outputs with the trace, and milliseconds (CUDA events)."""

    def __init__(self, family, cfg):
        self.family, self.cfg = family, cfg

    def __call__(self, z0, U_init, lam_init, curv, ds):
        from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain

        self.inputs = tuple(t.contiguous() for t in (z0, U_init, lam_init, curv, ds))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.outputs = solve_plain(self.family, self.cfg, *self.inputs, trace=True)
        end.record()
        torch.cuda.synchronize()
        self.ms = start.elapsed_time(end)
        return self.outputs[:7]


def warm_inputs(label, problem, cfg, env):
    """The checks' inputs, computed by no kernel: the drops
    (``initial_states`` seed 0, clear of the discs where the family has
    obstacles) with their aligned carry, one closed-loop
    step from there whose solve is the plain whole solve at the main path's
    budget, and the next solve's inputs with its first backward pass's X: a
    dict of tensors on the card.  ``first``: that plain solve's inputs,
    outputs and milliseconds (check (ii))."""
    from vehicle_control_tpu_torch.parallel.batch import (
        aligned_carry,
        initial_states,
        make_batched_racing_step,
    )
    from vehicle_control_tpu_torch.solvers.al_ilqr import rollout

    dev, f32 = env["dev"], torch.float32
    _, transition, s_index, ns = family_model(label, env)
    plain = PlainSolve(problem.family, cfg)
    plain_step = make_batched_racing_step(problem, cfg, transition, env["tdata"], DT, s_index,
                                          kernels=dict(solve_kernel=plain))
    obstacles = env["track"].data.obstacles.numpy() if problem.family.obstacles else None
    states = torch.as_tensor(initial_states(env["track"].length, B, np.random.default_rng(0),
                                            obstacles, ns=ns), dtype=f32, device=dev)
    carry = aligned_carry(problem, states)
    carry1, states1, _, _ = plain_step(carry, states)
    params, z0 = problem.init_horizon(states1, carry1.X_pred, carry1.U_pred)
    U_init = carry1.U_pred.contiguous()
    U = torch.clamp(U_init, problem.u_lo, problem.u_hi).contiguous()
    X = torch.nan_to_num(rollout(problem.fns, params, z0, U)[0], nan=0.0, posinf=1e6,
                         neginf=-1e6).contiguous()
    return dict(carry1=carry1, states1=states1, z0=z0.contiguous(), U_init=U_init, U=U, X=X,
                lam=carry1.lam.contiguous(), mu=torch.full((B,), cfg.mu0, dtype=f32, device=dev),
                curv=params.curvature.contiguous(), ds=params.ds.contiguous(),
                first=(plain.inputs, plain.outputs, plain.ms))


def _walk(obj, leaf, fn):
    """``obj`` with every leaf of type ``leaf`` in its tuples, named tuples,
    lists and dicts replaced by fn(leaf)."""
    if isinstance(obj, leaf):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _walk(v, leaf, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(v, leaf, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_walk(v, leaf, fn) for v in obj)
    return obj


def warm_worker(label):
    """``warm_inputs`` of the family ``label`` on the card, in a process of
    its own (``start_warm``): its tensors as numpy arrays."""
    torch.set_num_threads(1)
    env = make_env(torch.device(DEVICE, 0))
    problem, _, cfg, _, _ = family_problem(label, env)
    w = warm_inputs(label, problem, cfg, env)
    torch.cuda.synchronize()
    return _walk(w, torch.Tensor, lambda t: t.cpu().numpy())


def start_warm(labels):
    """Start each family's ``warm_inputs`` in a process of its own, all at
    once, beside the build and the other families' checks: its closed-loop
    step of the plain whole solve is launch-bound torch, one host thread
    each, so the processes overlap on the card; each solve's time is taken
    there, shared (``sv_plain_shared_ms``).  Returns the pool and the futures for ``warm_of`` and ``warm_barrier``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(len(labels), mp_context=multiprocessing.get_context("spawn"))
    return pool, {label: pool.submit(warm_worker, label) for label in labels}


def warm_of(label, env):
    """The family's checks' inputs, from its ``start_warm`` process."""
    dev = env["dev"]
    return _walk(env["warm"][1][label].result(), np.ndarray,
                 lambda a: torch.from_numpy(a).to(dev))


def warm_barrier(env):
    """Wait for every ``start_warm`` process before a timed phase, so that
    no other process shares the card while it is timed; stop the pool."""
    pool, futures = env["warm"]
    if pool is None:
        return
    t0 = time.perf_counter()
    ms = {label: f.result()["first"][2] for label, f in futures.items()}
    pool.shutdown()
    env["warm"] = (None, futures)
    phase("warm_inputs", processes=len(futures), waited_s=f"{time.perf_counter() - t0:.1f}",
          **{f"{label}_plain_solve_shared_ms": f"{v:.0f}" for label, v in ms.items()})


def run_family(label, env):
    """Checks, main path, profile, timings and bounds of one family, in two
    parts: a generator whose first ``next`` runs the checks (which share the
    card with the other families' ``start_warm`` processes) and whose second
    runs the timed phases, alone on the card, and yields the family's
    numbers for the kernels line."""
    from vehicle_control_tpu_torch.parallel.batch import make_batched_racing_step
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import (
        BackwardKernelFM,
        backward_plain,
    )
    from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import DerivsKernelFM, derivs_plain
    from vehicle_control_tpu_torch.solvers.rollout_kernel import LinesearchKernelAoS
    from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import (
        LinesearchKernelFM,
        linesearch_costs_plain,
    )
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM, solve_plain

    dev, f32 = env["dev"], torch.float32
    problem, budget, cfg, main_step, shape = family_problem(label, env)
    # the witnesses' shares (direct gates: 0; FAMILY_SHARES) and the gates decided
    # on copies of the inputs (FAMILY_COPIES)
    shares = {"rtol": 0.0, "kernel2": 0.0, "kernel4": 0.0, "solve": WITNESS_SHARE,
              **FAMILY_SHARES.get(label, {})}
    copy_gates = FAMILY_COPIES.get(label, ())
    fam = problem.family
    H = fam.H
    _, transition, s_index, _ = family_model(label, env)
    (solve_kernel,) = main_step.kernels
    side = {}
    if label in SIDE_ROUTES:  # the two earlier routes
        side["per_phase_path"] = make_batched_racing_step(
            problem, ALILQRConfig(**budget), transition, env["tdata"], DT, s_index)
        side["derivs_path"] = make_batched_racing_step(
            problem, ALILQRConfig(**budget, use_derivs_kernel=True), transition,
            env["tdata"], DT, s_index)
        ls_kernel, bw_kernel = side["per_phase_path"].kernels
        ls_kernel_d, dv_kernel = side["derivs_path"].kernels
    else:  # no route of the cascade runs kernels 1, 2 and 4 on the card
        ls_kernel = ls_kernel_d = LinesearchKernelFM(fam, cfg.alphas())
        bw_kernel, dv_kernel = BackwardKernelFM(fam), DerivsKernelFM(fam)
    aos_kernel = LinesearchKernelAoS(fam, cfg.alphas())
    wrappers = (solve_kernel, ls_kernel, bw_kernel, ls_kernel_d, dv_kernel, aos_kernel)

    # kernel inputs from a real warm-started state that no kernel computed:
    # one closed-loop step of the plain whole solve, then the next solve's
    # inputs and its first backward pass and line search
    w = warm_of(label, env)
    if label in CPU_F64_LANES:  # check (ii)'s f64 solve, beside the card's phases
        f64_jobs = start_cpu_solves(env["cpu_pool"], env["root"], label, cfg, w["first"][0],
                                    CPU_F64_LANES[label])
    carry1, states1, z0, U_init, U, X, lam, mu, curv, ds = (
        w[k] for k in ("carry1", "states1", "z0", "U_init", "U", "X", "lam", "mu", "curv", "ds"))

    # kernels 1, 5 and 2 against their plain versions on the same inputs, at
    # two regularizations: rho = RHO_WELL (well conditioned: direct
    # tolerances) and the solver's rho0 (ill conditioned: both against f64)
    alphas = ls_kernel.alphas
    ls_rows, bw_rows, ls_abs, aos_abs, bw_abs = {}, {}, 0.0, 0.0, 0.0
    for cond, rho_v in (("well", RHO_WELL), ("rho0", cfg.rho0)):
        rho = torch.full((B,), rho_v, dtype=f32, device=dev)
        bw_args = (X, U, lam, mu, rho, curv, ds)
        ref = backward_plain(fam, *bw_args)
        got = bw_kernel(*bw_args)
        # kernels 1 and 5 roll out the plain backward pass's feedback law
        ls_args = (X, U, ref[0].contiguous(), ref[1].contiguous(), lam, mu, curv, ds, z0)
        costs_ref = linesearch_costs_plain(fam, alphas, *ls_args)
        costs64 = linesearch_costs_plain(fam, alphas, *(a.double() for a in ls_args))
        k1_costs = None
        for name, kern in (("kernel 1", ls_kernel), ("kernel 5", aos_kernel)):
            costs = kern(*ls_args)
            torch.cuda.synchronize()
            if k1_costs is None:
                k1_costs = costs
            elif not same_bits(costs, k1_costs):
                raise RuntimeError(f"kernel 5 ({cond}): not kernel 1's costs bit for bit on "
                                   f"{int((costs.view(torch.int32) != k1_costs.view(torch.int32)).sum())} "
                                   f"of {costs.numel()} rollouts")
            # the disputed rollouts' lanes on copies of their inputs one ulp apart
            lanes = (torch.isposinf(costs) != torch.isposinf(costs_ref)).any(0).nonzero()[:, 0]
            copies = None
            if len(lanes):
                cop = ulp_copies(ls_args, lanes, exact=(5,))  # mu: a config value
                copies = [copy_costs(fn, cop, lanes, tuple(costs.shape)) for fn in (
                    kern, lambda *a: linesearch_costs_plain(fam, alphas, *a),
                    lambda *a: linesearch_costs_plain(fam, alphas, *(t.double() for t in a)))]
            decided = inf_witness(f"{name} ({cond}) +inf rollouts", costs, costs_ref, costs64,
                                  copies)
            fin = torch.isfinite(costs_ref) & torch.isfinite(costs)
            kp = cost_errors(costs[fin], costs_ref[fin])
            row = (f"inf:{int(torch.isposinf(costs_ref).sum())},witness:{decided},"
                   f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}")
            if cond == "well":
                err = (costs[fin] - costs_ref[fin]).abs().max().item()
                ls_abs, aos_abs = (err, aos_abs) if kern is ls_kernel else (ls_abs, err)
                rel = torch.zeros(costs.shape, dtype=torch.float64, device=dev)
                rel[fin] = cost_errors(costs[fin], costs_ref[fin])
                row += ",rtol_witness:" + lane_witness(
                    f"{name} (rho={rho_v}) costs beyond {LS_RTOL}", fin & ~(rel <= LS_RTOL),
                    cost_errors(costs, costs64), cost_errors(costs_ref, costs64), LS_FLOOR,
                    shares["rtol"], err=rel)
            else:
                fin = fin & torch.isfinite(costs64)
                row += ",vs_f64:" + as_accurate(f"{name} (rho={rho_v})",
                                                cost_errors(costs[fin], costs64[fin]),
                                                cost_errors(costs_ref[fin], costs64[fin]),
                                                LS_FLOOR)
            if kern is aos_kernel:
                row += ",kernel1_bits:same"
            ls_rows[f"{'k1' if kern is ls_kernel else 'k5'}_{cond}"] = row
        well_c = cond == "well"
        ref64 = None if well_c else backward_plain(fam, *(t.double() for t in bw_args))
        # the lanes that miss a lane-by-lane gate: the f64 witness decides
        disputed, decided = backward_disputes(got, ref, well_c), "0"
        if disputed.any():
            w64 = ref64 if ref64 is not None else backward_plain(fam, *(t.double() for t in bw_args))
            edge = (lambda lanes, w=well_c, a=bw_args: copies_side(  # noqa: E731
                lanes, bw_kernel, lambda *x: backward_plain(fam, *x),
                lambda out, r64: backward_lane_errors(out, r64, w), a, BW_FLOOR, exact=(3, 4)))
            decided = lane_witness(f"kernel 2 (rho={rho_v})", disputed,
                                   backward_lane_errors(got, w64, well_c),
                                   backward_lane_errors(ref, w64, well_c), BW_FLOOR,
                                   shares["kernel2"], edge if "kernel2" in copy_gates else None)
        rows, err, missed = backward_gates(f"kernel 2 (rho={rho_v})", got, ref, ref64, disputed)
        rows["witness"] = decided
        if missed:
            raise RuntimeError(missed)
        bw_abs = err if cond == "well" else bw_abs
        bw_rows.update({f"{key}_{cond}": v for key, v in rows.items()})
    phase(f"{label}:kernel1_kernel5_vs_plain", **shape, A=len(alphas), rho_well=RHO_WELL,
          rho_solver=cfg.rho0, k1_max_abs_err_well=f"{ls_abs:.3e}",
          k5_max_abs_err_well=f"{aos_abs:.3e}", **ls_rows)
    phase(f"{label}:kernel2_vs_plain", **shape, rho_well=RHO_WELL, rho_solver=cfg.rho0,
          max_abs_err_well=f"{bw_abs:.3e}", **bw_rows)

    # the launch shapes of kernels 1, 5 and 4 at the family's shapes (and of
    # kernels 2 and 3, where the family has its own instantiation)
    lib = cuda_lib.load_library()
    info = lambda name, *shape: cuda_lib.launch_info(  # noqa: E731
        getattr(lib, cuda_lib.entry(fam, name)), *shape)
    launch_shapes = dict(ls=info("vct_linesearch_fm_info", B, len(alphas)),
                         aos=info("vct_linesearch_aos_info", B, len(alphas)),
                         dv=info("vct_derivs_fm_info", B, H))
    if cuda_lib.entry_suffix(fam):  # the family's own instantiation of kernels 2 and 3
        launch_shapes.update(bw=info("vct_backward_fm_info", B), sv=info("vct_solve_fm_info", B))
    for key, name, lead in (("ls", "linesearch_fm", dict(A=len(alphas))),
                            ("aos", "linesearch_aos", dict(A=len(alphas))),
                            ("dv", "derivs_fm", dict(H=H)), ("bw", "backward_fm", {}),
                            ("sv", "solve_fm", {})):
        if key in launch_shapes:
            phase(f"{label}:launch:{name}", B=B, **lead, **launch_shapes[key])

    # kernel 4 against its plain version (no rho: a direct check)
    dv_args = (X, U, lam, mu, curv, ds)
    got, ref = dv_kernel(*dv_args), derivs_plain(fam, *dv_args)
    torch.cuda.synchronize()
    dv_rows, dv_abs = {}, 0.0
    ok = finite_lanes(ref)
    if not torch.equal(finite_lanes(got), ok):
        raise RuntimeError("kernel 4: the lanes with non-finite derivatives differ")
    dv_rows["nonfinite_lanes"] = int((~ok).sum())
    dv_err = torch.zeros(B, dtype=torch.float64, device=dev)
    for key, a, b in zip(("g", "Hw", "J"), got, ref):
        if a.shape != b.shape:
            raise RuntimeError(f"kernel 4: {key} has shape {tuple(a.shape)}")
        kp = lane_errors(a[ok], b[ok])
        dv_err[ok] = torch.maximum(dv_err[ok], kp)
        dv_abs = max(dv_abs, (a[ok] - b[ok]).abs().max().item())
        dv_rows[key] = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"

    # the lanes beyond DV_TOL: the f64 witness decides
    disputed, dv_rows["witness"] = ~(dv_err <= DV_TOL), "0"
    if disputed.any():
        ref64 = derivs_plain(fam, *(t.double() for t in dv_args))

        def dv_lane_errors(out):  # (B,): the worst of g, Hw and J against f64
            e = torch.zeros(B, dtype=torch.float64, device=dev)
            for a, c in zip(out, ref64):
                e = torch.maximum(e, lane_errors(a, c))
            return e

        dv_rows["witness"] = lane_witness("kernel 4", disputed, dv_lane_errors(got),
                                          dv_lane_errors(ref), BW_FLOOR, shares["kernel4"],
                                          err=dv_err)
    phase(f"{label}:kernel4_vs_plain", **shape, tol=DV_TOL, max_abs_err=f"{dv_abs:.3e}",
          **dv_rows)

    # kernel 3 against its plain version: (i) and (iii) on the next solve's
    # inputs, (ii) on the first solve's
    sv_args = (z0, U_init, lam, curv, ds)
    # (i) well conditioned: one outer x one inner iteration at rho0 = RHO_WELL,
    # with the plain version in f64 as the witness of lanes beyond SOLVE_TOL
    well = well_config(budget)
    got = SolveKernelFM(fam, well)(*sv_args, trace=True)
    ref = solve_plain(fam, well, *sv_args, trace=True)
    ref64 = solve_plain(fam, well, *(t.double() for t in sv_args), trace=True)
    torch.cuda.synchronize()
    same = got[7]["first_alpha"] == ref[7]["first_alpha"]
    x_err, u_err = lane_errors(got[0][same], ref[0][same]), lane_errors(got[1][same], ref[1][same])
    fin = same & torch.isfinite(ref[3])
    c_err = cost_errors(got[3][fin], ref[3][fin])
    sv_abs = max((got[0][same] - ref[0][same]).abs().max().item(),
                 (got[1][same] - ref[1][same]).abs().max().item())

    err = torch.zeros(B, dtype=torch.float64, device=dev)
    err[same] = torch.maximum(x_err, u_err)
    err[fin] = torch.maximum(err[fin], c_err)
    kern64, plain64 = solve_errors(got, ref64), solve_errors(ref, ref64)
    edge = (lambda lanes: copies_side(  # noqa: E731
        lanes, SolveKernelFM(fam, well), lambda *a: solve_plain(fam, well, *a), solve_errors,
        sv_args, LS_FLOOR))
    decided = lane_witness(f"{label} kernel 3 (well)", same & ~(err <= SOLVE_TOL), kern64,
                           plain64, LS_FLOOR, shares["solve"], edge if "solve" in copy_gates else None,
                           total=int(same.sum()), err=err)
    rows = dict(step_same=f"{same.float().mean().item():.4f}",
                accepted=f"{(ref[7]['first_alpha'] > 0).float().mean().item():.4f}",
                X=f"max:{x_err.max().item():.2e},median:{x_err.median().item():.2e}",
                U=f"max:{u_err.max().item():.2e},median:{u_err.median().item():.2e}",
                cost=f"max:{c_err.max().item():.2e},median:{c_err.median().item():.2e}",
                X_worst=worst_entry(got[0][same], ref[0][same]),
                U_worst=worst_entry(got[1][same], ref[1][same]),
                margin=f"{SOLVE_TOL / max(x_err.max(), u_err.max(), c_err.max()).item():.3g}",
                witness=decided)
    if same.float().mean().item() < STEP_SAME:
        raise RuntimeError(f"kernel 3 (well): the chosen step differs on "
                           f"{int((~same).sum())} lanes")
    if not torch.equal(torch.isfinite(got[3]), torch.isfinite(ref[3])):
        raise RuntimeError("kernel 3 (well): finite costs differ")
    phase(f"{label}:kernel3_vs_plain_well", **shape, rho0=RHO_WELL, tol=SOLVE_TOL,
          max_abs_err=f"{sv_abs:.3e}", **rows)
    # (ii) the main path's budget at the solver's rho0 on the cold first solve
    # of the checks' closed-loop step: kernel 3 and the plain f32 version
    # (the step's own solve, also the plain version's timed run) against the
    # plain version in f64 on the same inputs
    first_args, first_ref, sv_plain_shared_ms = w["first"]
    first_got = solve_kernel(*first_args, trace=True)

    def check_ii():
        lanes = CPU_F64_LANES.get(label)
        if lanes:
            got, ref, ref64 = (lanes_of(first_got, lanes), lanes_of(first_ref, lanes),
                               cpu_solves_result(f64_jobs, dev))
        else:
            got, ref = first_got, first_ref
            ref64 = solve_plain(fam, cfg, *(t.double() for t in first_args), trace=True)
        torch.cuda.synchronize()
        rows, passed = solve_gates(got, ref, ref64)
        phase(f"{label}:kernel3_vs_plain_rho0", **shape, rho0=cfg.rho0, inputs="cold_first_solve",
              **(dict(f64_lanes=f"first_{lanes}_on_the_cpu") if lanes else {}), **rows)
        if not passed:
            raise RuntimeError(f"{label} kernel 3 (rho0): the gates failed: {rows}")

    if label not in CPU_F64_LANES:
        check_ii()
    runs = first_got[7]["inner_runs"]
    # (iii) early exit and the alpha=1 fast path change no output bit
    base = solve_kernel(*sv_args)
    for early_exit, fast in ((False, False), (True, True), (False, True)):
        other = ALILQRConfig(**budget, early_exit=early_exit, ls_fast_path=fast)
        out = SolveKernelFM(fam, other)(*sv_args)
        if not all(same_bits(a, b) for a, b in zip(out, base)):
            raise RuntimeError(f"{label} kernel 3: early_exit={early_exit} "
                               f"ls_fast_path={fast} changed an output bit")
    phase(f"{label}:kernel3_exits_bitwise", configs="early_exit x ls_fast_path", identical=True)

    yield  # the checks are done; the timed phases follow, alone on the card
    # the main path: kernel 3 alone, K steps per chunk
    carry, states, times, conv_frac = drive(
        main_step, carry1, states1, wrappers, {solve_kernel: 1}, K, 1 + TIMED_CHUNKS,
        f"{label} main_path")
    step_s = statistics.median(times)
    phase(f"{label}:main_path", **shape, K=K, chunks=f"1+{TIMED_CHUNKS}",
          step_ms=f"{step_s * 1e3:.1f}", step_ms_chunks="/".join(f"{t * 1e3:.1f}" for t in times),
          solves_per_s=f"{B / step_s:.0f}", converged_frac=f"{conv_frac:.4f}",
          solve_launches=solve_kernel.launches,
          other_launches=sum(w.launches for w in wrappers[1:]))
    if conv_frac < CONV_FLOOR:
        raise RuntimeError(f"{label}: converged fraction {conv_frac:.4f} < {CONV_FLOOR}")
    launches = {solve_kernel: solve_kernel.launches}

    # one main-path step under the profiler: the device's busy share
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_step(carry, states)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    # the kernels' own events: one stream, so their times add up to busy time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:3]
    phase(f"{label}:profile", step_ms_profiled=f"{prof_s * 1e3:.1f}",
          device_busy_ms=f"{busy_ms:.3f}", busy_share_of_step=f"{busy_ms / (step_s * 1e3):.4f}",
          device_launches=sum(e.count for e in events),
          top="|".join(f"{e.key[:40]}:{e.device_time_total / 1e3:.3f}ms" for e in top))

    # the two earlier routes, cut in depth
    per_step = cfg.n_outer * cfg.n_inner + cfg.n_polish
    for route, step in side.items():
        expect = ({ls_kernel: per_step, bw_kernel: per_step} if route == "per_phase_path"
                  else {ls_kernel_d: per_step, dv_kernel: per_step})
        _, _, times, frac = drive(step, carry1, states1, wrappers, expect, SIDE_K,
                                  1 + SIDE_TIMED_CHUNKS, f"{label} {route}")
        t_s = statistics.median(times)
        phase(f"{label}:{route}", **shape, K=SIDE_K, chunks=f"1+{SIDE_TIMED_CHUNKS}",
              step_ms=f"{t_s * 1e3:.1f}", solves_per_s=f"{B / t_s:.0f}",
              converged_frac=f"{frac:.4f}", launches="/".join(f"{w.launches}" for w in expect))
        if frac < CONV_FLOOR:
            raise RuntimeError(f"{label} {route}: converged fraction {frac:.4f} < {CONV_FLOOR}")
        launches.update({w: w.launches for w in expect})

    # each kernel against its plain version at the main path's shapes, on
    # the inputs of the checks above (kernels 1, 2 and 5 at the solver's
    # rho0; kernel 3 on check (ii)'s, the plain version's run there); kernel
    # 5's plain version is kernel 1's, on the same numbers (kernels 1, 4 and
    # 5: the launch alone, on inputs already in their layout; their wrappers,
    # with the layout copies, beside)
    ls_laid = [cuda_lib.soa(t) for t in ls_args]
    ls_costs = torch.empty(len(alphas), B, dtype=f32, device=dev)
    dv_soas = [cuda_lib.soa(t) for t in dv_args]
    NW = fam.NZ + fam.NU
    dv_outs = (torch.empty(H, NW, B, dtype=f32, device=dev),
               torch.empty(H, NW, NW, B, dtype=f32, device=dev),
               torch.empty(H, fam.NZ, NW, B, dtype=f32, device=dev))
    ms = dict(
        ls=cuda_ms(lambda: ls_kernel.launch(ls_laid, ls_costs)),
        aos=cuda_ms(lambda: aos_kernel.launch(ls_args, ls_costs)),  # its layout: the inputs
        bw=cuda_ms(lambda: bw_kernel(*bw_args)),
        dv=cuda_ms(lambda: dv_kernel.launch(dv_soas, dv_outs)),
    )
    wrapper_ms = dict(ls=cuda_ms(lambda: ls_kernel(*ls_args)),
                      aos=cuda_ms(lambda: aos_kernel(*ls_args)),
                      dv=cuda_ms(lambda: dv_kernel(*dv_args)))
    # kernel 3's runs with the card's clocks beside them: its time has shown
    # two modes on the single track
    sv_runs = []
    with sampled_clocks() as clocks:
        ms["sv"] = cuda_ms(lambda: solve_kernel(*first_args), runs=sv_runs)
    phase(f"{label}:kernel3_modes", runs=len(sv_runs), clock_samples=len(clocks),
          **clock_modes(sv_runs, clocks))
    plain_ms = dict(
        ls=cuda_ms(lambda: linesearch_costs_plain(fam, alphas, *ls_args), PLAIN_REPS, warm=False),
        bw=cuda_ms(lambda: backward_plain(fam, *bw_args), PLAIN_REPS, warm=False),
        dv=cuda_ms(lambda: derivs_plain(fam, *dv_args), PLAIN_REPS, warm=False),
        sv=(cuda_ms(lambda: solve_plain(fam, cfg, *first_args), 1, warm=False)
            if label in SOLVE_PLAIN_ALONE else None),
    )
    plain_ms["aos"] = plain_ms["ls"]
    phase(f"{label}:timing", median_of=REPS, plain_median_of=PLAIN_REPS,
          **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
          **{f"{k}_wrapper_ms": f"{v:.3f}" for k, v in wrapper_ms.items()},
          **{f"{k}_plain_ms": "null" if v is None else f"{v:.3f}" for k, v in plain_ms.items()},
          sv_plain_shared_ms=f"{sv_plain_shared_ms:.3f}")

    # each kernel's bound: its bytes (inputs read once, outputs written
    # once) and its operations over OP_COUNT_LANES lanes, scaled to B:
    # kernel 1's (and 5's) on the plain version's arithmetic; kernels 4 and
    # 2's on their own code (``code_op_counts``: their stage derivatives do
    # about a third of the plain version's jet operations); kernel 3's from
    # those by the inner iterations each lane of the timed inputs ran.
    lanes = OP_COUNT_LANES
    sub = lambda ts: tuple(t[:lanes] for t in ts)  # noqa: E731
    ops_cand = count_ops(lambda: linesearch_costs_plain(fam, alphas[:1], *sub(ls_args))) / lanes
    ops_dv, ops_bw = code_op_counts(env["count_lib"], fam, sub(dv_args), sub(bw_args))
    A = len(alphas)
    # per lane: each inner iteration a backward pass, A candidates and a
    # re-roll (as one candidate); per solve a warm rollout, one AL cost sweep
    # per inner loop, one multiplier update per outer iteration and the
    # finalize sweep (one candidate each)
    sweeps = 1 + (cfg.n_outer + 1) + cfg.n_outer + 1
    f4, NZ, NU, NC = 4, fam.NZ, fam.NU, fam.NC  # bytes of an f32, the widths
    NW = NZ + NU

    # outputs: costs (A, B); kff, Kfb, dV (2, B), fail (B); g, Hw, J; X, U,
    # lam and the SOLVE_STATS rows
    ops_sv = runs.double().sum().item() * (ops_bw + (A + 1) * ops_cand) + B * sweeps * ops_cand
    bounds = {
        "ls": bound(nbytes(*ls_args) + A * B * f4, A * B * ops_cand),
        "bw": bound(nbytes(*bw_args) + B * f4 * (H * (NU + NU * NZ) + 3), B * ops_bw),
        "dv": bound(nbytes(*dv_args) + B * H * f4 * NW * (1 + NW + NZ), B * ops_dv),
        "sv": bound(nbytes(*first_args) + B * f4 * (H * (NZ + NU + NC) + cuda_lib.SOLVE_STATS),
                    ops_sv),
    }
    bounds["aos"] = bounds["ls"]
    phase(f"{label}:bounds", ops_per_candidate_lane=f"{ops_cand:.0f}",
          ops_per_backward_lane=f"{ops_bw:.0f}", ops_per_derivs_lane=f"{ops_dv:.0f}",
          solve_inner_runs=int(runs.sum()),
          **{f"{k}_bound_ms": f"{v[0]:.4f}({v[1]})" for k, v in bounds.items()})
    counts = dict(ls=sum(launches.get(k, 0) for k in {ls_kernel, ls_kernel_d}),
                  bw=launches.get(bw_kernel, 0), dv=launches.get(dv_kernel, 0),
                  sv=launches[solve_kernel], aos=0)
    errs = dict(ls=ls_abs, aos=aos_abs, bw=bw_abs, dv=dv_abs, sv=sv_abs)
    out = {k: dict(launches=counts[k], max_abs_err=errs[k], ms=ms[k], plain_ms=plain_ms[k],
                   bound_ms=bounds[k][0], bound_by=bounds[k][1]) for k in ms}
    for k, v in wrapper_ms.items():
        out[k]["wrapper_ms"] = v
    for k, v in launch_shapes.items():
        out[k]["launch"] = v
    out["sv"]["plain_shared_ms"] = sv_plain_shared_ms
    out["sv"]["lane_ops"] = dict(backward=ops_bw, candidate=ops_cand)
    if label in CPU_F64_LANES:
        check_ii()
    yield out


def family_ctrl(label, root):
    """(controller config, tail) of a family of FAMILIES."""
    from vehicle_control_tpu_torch.utils.config import load_config

    ctrl_yaml, tail, overrides, _ = FAMILIES[label]
    ctrl = load_config(f"{root}/configs/controllers/{ctrl_yaml}")
    ctrl.update({"obstacles": False, **overrides})
    return ctrl, tail


def plain_solve_cpu(root, label, cfg, dtype_name, inputs):
    """The plain whole solve (``solve_plain``, with its trace) of the
    family ``label`` on ippodromo on the CPU in ``dtype_name`` on
    ``inputs`` (numpy): its outputs as numpy arrays (the trace's first_alpha
    and inner_runs last).  Runs in a process of its own (``start_cpu_solves``)."""
    torch.set_num_threads(1)
    from vehicle_control_tpu_torch.environment.track import Track
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
    from vehicle_control_tpu_torch.utils.config import load_config

    dtype = getattr(torch, dtype_name)
    car = "kinematic_car" if FAMILIES[label][1] == "kinematic" else "dynamic_car"
    prob = build_problem(label, load_config(f"{root}/configs/models/{car}.yaml"),
                         Track(load_config(f"{root}/configs/environment/ippodromo.yaml")), dtype,
                         "cpu", root)
    out = solve_plain(prob.family, cfg, *(torch.as_tensor(a).to(dtype) for a in inputs), trace=True)
    return [o.numpy() for o in out[:7]] + [out[7][k].numpy() for k in ("first_alpha", "inner_runs")]


def start_cpu_solves(pool, root, label, cfg, inputs, lanes):
    """Submit to ``pool`` the plain whole solve in f64 of the first
    ``lanes`` lanes of ``inputs`` on the CPU, split in CPU_WORKERS parts;
    returns the futures for ``cpu_solves_result``."""
    lanes = min(lanes, inputs[0].shape[0])
    host = [t[:lanes].cpu().numpy() for t in inputs]
    cuts = np.linspace(0, lanes, CPU_WORKERS + 1).astype(int)
    return [pool.submit(plain_solve_cpu, root, label, cfg, "float64", [a[lo:hi] for a in host])
            for lo, hi in zip(cuts, cuts[1:])]


def cpu_solves_result(futures, dev):
    """The outputs of ``start_cpu_solves``'s solves, joined, on ``dev`` as
    ``solve_plain(trace=True)`` gives them."""
    parts = [f.result() for f in futures]
    out = [torch.as_tensor(np.concatenate(p)).to(dev) for p in zip(*parts)]
    return tuple(out[:7]) + (dict(first_alpha=out[7], inner_runs=out[8]),)


def lanes_of(out, lanes):
    """The first ``lanes`` lanes of a solve's outputs with their trace."""
    return tuple(t[:lanes] for t in out[:7]) + ({k: v[:lanes] for k, v in out[7].items()},)


def plain_first_action(car, track_cfg, ctrl, cfg, dtype_name, inputs):
    """The plain whole solve (``solve_plain``) of one scenario on the CPU in
    ``dtype_name``: (its first action in physical units, its violation,
    seconds).  The simulator's controller: the cascade (``horizon_pm`` in
    its config), the kc cascade (``horizon_kc``) or the kinematic family.
    Runs in a process of its own (``simulator_kernel3_vs_plain``)."""
    torch.set_num_threads(1)
    from vehicle_control_tpu_torch.controllers.mpc import problems
    from vehicle_control_tpu_torch.environment.track import Track
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
    from vehicle_control_tpu_torch.utils.config import ConfigDict

    dtype = getattr(torch, dtype_name)
    args = (ConfigDict(car), Track(ConfigDict(track_cfg)), ConfigDict(ctrl))
    tail = "pm" if "horizon_pm" in ctrl else "kc" if "horizon_kc" in ctrl else None
    prob = (problems.build_cascaded_problem(*args, tail, dtype, "cpu") if tail
            else problems.build_kinematic_problem(*args, dtype, "cpu"))
    t0 = time.perf_counter()
    out = solve_plain(prob.family, cfg, *(torch.as_tensor(a).to(dtype) for a in inputs))
    return ((out[1][0, 0] * prob.u_scale[0]).double().numpy(), float(out[4][0]),
            time.perf_counter() - t0)


def same_arrays(a, b):
    """Bit for bit: the same dtype, shape and bytes."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def simulator_lap(env, tag="cascaded"):
    """[simulator:cascaded_lap]: the simconfig's lap through RacingSimulator
    on the card; with ``tag`` "kinematic" [simulator:kinematic_lap]: the
    simconfig with the kinematic controller through KinematicRacingSimulator
    (the kinematic car); with "cascaded_kinematic"
    [simulator:cascaded_kinematic_lap]: the simconfig with that controller
    through RacingSimulator, held to its split at KC_SPLIT_M.  Returns the
    simulator, its controller's name, the snapshots (step -> (state,
    carry)) of SNAP_STEPS and the lap's numbers for the kernels line."""
    from vehicle_control_tpu_torch.controllers.mpc.controllers import MPCCarry
    from vehicle_control_tpu_torch.simulation import KinematicRacingSimulator, RacingSimulator
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM
    from vehicle_control_tpu_torch.utils.config import load_config
    from vehicle_control_tpu_torch.utils.profiling import StepTimer

    root = env["root"]
    kinematic, kc = tag == "kinematic", tag == "cascaded_kinematic"
    ref_s = dict(kinematic=KIN_LAP_REF_S, cascaded=LAP_REF_S).get(tag)
    simcfg = load_config(f"{root}/configs/simconfig.yaml")
    simcfg.update(save_data=False, logging=False,
                  output_dir=os.path.join(root, "build", "simulator"))
    if tag != "cascaded":
        simcfg["controller_names"] = [tag]
    track_cfg = load_config(f"{root}/configs/environment/{simcfg['track_name']}.yaml")
    sim = (KinematicRacingSimulator(simcfg, env["kin_car"], track_cfg) if kinematic
           else RacingSimulator(simcfg, env["car"], track_cfg))
    (name,) = sim.entries
    entry = sim.entries[name]
    kernels = entry.run_chunk.kernels
    if len(kernels) != 1 or not isinstance(kernels[0], SolveKernelFM):
        raise RuntimeError(f"the simulator's chunk runs {kernels}, not kernel 3 alone")
    (solve_kernel,) = kernels
    if sim.dtype != torch.float32 or entry.problem.u_scale.dtype != torch.float32:
        raise RuntimeError(f"the simulator built its problem in {sim.dtype} on the card")

    def snapshot():
        return entry.state.clone(), MPCCarry(*(a.clone() for a in entry.carry))

    # no host sync inside a chunk: a short chunk from the start under the
    # sync debug mode (its results are dropped; the lap starts afresh)
    torch.cuda.set_sync_debug_mode("error")
    try:
        entry.run_chunk(entry.state, entry.carry, SYNC_CHECK_STEPS)
    except RuntimeError as exc:
        raise RuntimeError(f"a host sync inside the simulator's chunk: {exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    snaps = {0: snapshot()}
    solve_kernel.launches = 0
    t0 = time.perf_counter()
    for stop in (*SNAP_STEPS[1:], KC_LAP_MAX_STEPS if kc else LAP_MAX_STEPS):
        sim.run(max_steps=stop, chunk=LAP_CHUNK)
        if stop in SNAP_STEPS:
            if entry.steps != stop:
                raise RuntimeError(f"the lap ended at step {entry.steps}, before {stop}")
            snaps[stop] = snapshot()
    lap_s = time.perf_counter() - t0
    launches = solve_kernel.launches

    # one more step from where the lap ended, under the profiler: the
    # device's busy share of a B=1 step and its launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        entry.run_chunk(entry.state, entry.carry, 1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    solve_ms = sum(e.device_time_total for e in events if "solve_fm" in e.key) / 1e3
    phase("simulator:profile" if tag == "cascaded" else f"simulator:{tag}_profile",
          step_ms_profiled=f"{prof_ms:.2f}", device_busy_ms=f"{busy_ms:.3f}",
          kernel3_ms=f"{solve_ms:.3f}", other_device_ms=f"{busy_ms - solve_ms:.3f}",
          device_launches=sum(e.count for e in events),
          busy_share=f"{busy_ms / prof_ms:.4f}")

    st, viol = sim.state_traj[name], sim.violation_traj[name]
    lap_time = float(st[-1, sim.t_index]) + sim.dt
    timer = StepTimer()
    timer.times = list(sim.elapsed[name])  # per-step chunk means
    steps_ms = timer.summary()
    path = sim.save(os.path.join(root, "build", "simulator", f"{tag}_lap"))
    saved = {k: getattr(sim, k)[name].copy() for k in ("state_traj", "action_traj", "elapsed")}
    preds = sim._global_preds(name)
    sim.load(path)
    reloaded = all(same_arrays(getattr(sim, k)[name], v) for k, v in saved.items()) and \
        same_arrays(np.load(os.path.join(path, f"{name}_preds.npy")), preds)
    split = {}
    if kc:  # the split at KC_SPLIT_M, where the JAX f64 lap is still on the road
        past = np.nonzero(st[:, sim.s_index] >= KC_SPLIT_M)[0]
        wide = np.nonzero(np.abs(st[:, sim.ey_index]) > KC_EY_WIDE)[0]
        split = dict(split_m=KC_SPLIT_M, split_step=int(past[0]) if len(past) else -1,
                     split_t_s=float(st[past[0], sim.t_index]) if len(past) else float("nan"),
                     ref_split_t_s=KC_SPLIT_REF_S,
                     max_violation_to_split=float(viol[:past[0] + 1].max()) if len(past) else
                     float("nan"),
                     first_wide_step=int(wide[0]) if len(wide) else -1,
                     s_at_first_wide=float(st[wide[0], sim.s_index]) if len(wide) else -1.0,
                     s_end=float(st[-1, sim.s_index]))
    phase(f"simulator:{tag}_lap", controller=name, track=sim.track.name,
          dtype=str(sim.dtype).removeprefix("torch."), chunk=LAP_CHUNK,
          lap_completed=entry.done, lap_time_s=f"{lap_time:.4f}", ref_lap_time_s=ref_s,
          **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in split.items()},
          lap_steps=len(st), steps_run=entry.steps, kernel3_launches=launches,
          median_step_ms=f"{steps_ms['p50_ms']:.2f}", p95_step_ms=f"{steps_ms['p95_ms']:.2f}",
          mean_step_ms=f"{steps_ms['mean_ms']:.2f}", lap_wall_s=f"{lap_s:.1f}",
          max_violation=f"{viol.max():.3e}", iterations_mean=f"{sim.iter_traj[name].mean():.2f}",
          preds_finite=bool(np.isfinite(preds).all()), reloaded_bitwise=reloaded,
          sync_check_steps=SYNC_CHECK_STEPS)
    if kc:
        if not abs(split["split_t_s"] - KC_SPLIT_REF_S) <= LAP_TOL_S:
            raise RuntimeError(f"{tag}: split time at {KC_SPLIT_M} m {split['split_t_s']:.4f} s, "
                               f"the JAX f64 lap's {KC_SPLIT_REF_S} s")
        if not split["max_violation_to_split"] <= LAP_VIOL_MAX:
            raise RuntimeError(f"{tag}: max violation to the split "
                               f"{split['max_violation_to_split']:.3e} > {LAP_VIOL_MAX}")
    else:
        if not entry.done:
            raise RuntimeError(f"the {tag} lap did not complete in {LAP_MAX_STEPS} steps")
        if not abs(lap_time - ref_s) <= LAP_TOL_S:
            raise RuntimeError(f"{tag} lap time {lap_time:.4f} s, the JAX f64 lap {ref_s} s")
        if not viol.max() <= LAP_VIOL_MAX:
            raise RuntimeError(f"{tag} lap: max violation {viol.max():.3e} > {LAP_VIOL_MAX}")
    if launches != entry.steps:
        raise RuntimeError(f"kernel 3 launched {launches} times in {entry.steps} steps")
    if not reloaded or not np.isfinite(preds).all():
        raise RuntimeError("the reloaded artifacts are not the saved ones, or preds not finite")
    return sim, name, snaps, dict(launches=launches, steps=entry.steps, lap_time_s=lap_time,
                                  lap_completed=bool(entry.done),
                                  median_step_ms=steps_ms["p50_ms"],
                                  p95_step_ms=steps_ms["p95_ms"], lap_wall_s=lap_s, **split)


def submit_vs_plain(pool, env, lap):
    """Submit to ``pool`` the plain whole solve in f32 and f64 on the CPU of
    each snapshot of ``lap`` (simulator, controller name, snapshots step ->
    (state, carry), ...); returns (the setup, the futures) for
    ``simulator_kernel3_vs_plain``."""
    from vehicle_control_tpu_torch.controllers.mpc.controllers import controller_solver_config

    sim, name, snaps = lap[:3]
    entry = sim.entries[name]
    prob, cfg = entry.problem, controller_solver_config(entry.config)
    track_cfg = load_track_config(env["root"], sim.track.name)
    inputs, jobs = {}, {}
    for k, (state, carry) in snaps.items():
        params, z0 = prob.init_horizon(state, carry.X_pred, carry.U_pred)
        inputs[k] = tuple(t.contiguous() for t in (z0, carry.U_pred, carry.lam,
                                                   params.curvature, params.ds))
        host = [t.cpu().numpy() for t in inputs[k]]
        for dtype in ("float32", "float64"):
            jobs[k, dtype] = pool.submit(plain_first_action, sim.car_config.to_dict(), track_cfg,
                                         entry.config.to_dict(), cfg, dtype, host)
    return (sim, name, prob, cfg, inputs), jobs


def simulator_kernel3_vs_plain(env, laps, submitted):
    """Kernel 3 at B=1 at the simulator's budget on the inputs of lap steps,
    beside the plain whole solve in f32 and f64 on the CPU (one process
    each, ``submit_vs_plain``'s, started once every lap had run:
    ``submitted``, label -> its setup and futures).  ``laps``: phase label -> (simulator, controller
    name, snapshots step -> (state, carry), the family's per-lane operation
    counts for the B=1 bound or None); [simulator:kernel3_vs_plain] (the
    obstacle-free lap's SNAP_STEPS), [simulator:kinematic_vs_plain] (the
    kinematic lap's) and [simulator:cascaded_kinematic_vs_plain] (the kc
    lap's), each with kernel 3's B=1 launch time (CUDA events)
    and bound, the first action held to ACTION_TOL; and
    [simulator:obstacles_worst_step] (the obstacle lap's step of its largest
    violation: the actions printed, the violations for
    ``obstacle_violation_gate``).  Returns each label's numbers for the
    kernels line (those with operation counts) and every label's rows."""
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM

    out = {}
    for label in laps:
        (sim, name, prob, cfg, inputs), jobs = submitted[label]
        kern = SolveKernelFM(prob.family, cfg)  # its own count: these launches compare only
        scale = np.maximum(np.sqrt((sim.action_traj[name].astype(np.float64) ** 2).mean(0)),
                           1e-12)
        rows, errs, kms, runs, viols, action_errs = {}, [], [], [], {}, []
        for k, ins in inputs.items():
            got = kern(*ins, trace=True)
            a_k = (got[1][0, 0] * prob.u_scale[0]).double().cpu().numpy()
            v_k = float(got[4][0])
            runs.append(int(got[7]["inner_runs"][0]))
            kms.append(cuda_ms(lambda: kern(*ins)))
            (a_p, v_p, s_p), (a_64, v_64, s_64) = (
                jobs[k, d].result() for d in ("float32", "float64"))
            e_k, e_p = (float((np.abs(a - a_64) / scale).max()) for a in (a_k, a_p))
            ok = e_k <= ACTION_TOL or e_k <= e_p + ACTION_FLOOR
            viols[k] = (v_k, v_p, v_64)
            errs.append(float(np.abs(a_k - a_p).max()))
            fmt = lambda a: "/".join(f"{v:.7g}" for v in a)  # noqa: E731
            rows[f"step{k}"] = (f"kernel:{fmt(a_k)},plain_f32:{fmt(a_p)},f64:{fmt(a_64)},"
                                f"err_kernel:{e_k:.3e},err_plain_f32:{e_p:.3e},"
                                f"violation:{v_k:.4g}/{v_p:.4g}/{v_64:.4g},"
                                f"inner_runs:{runs[-1]},kernel_ms:{kms[-1]:.3f},"
                                f"plain_cpu_s:{s_p:.1f}/{s_64:.1f},pass:{ok}")
            action_errs.append((e_k, e_p, ok))
            if not ok and laps[label][3] is not None and label not in LAP_SHARES:
                raise RuntimeError(f"{label} step {k}: kernel 3's first action {a_k} is "
                                   f"{e_k:.3e} from f64's {a_64} (plain f32 {a_p}: {e_p:.3e})")
        if label in LAP_SHARES:
            rows["witness"] = action_witness(label, action_errs)
        out[label] = dict(prob=prob, cfg=cfg, inputs=inputs, rows=rows, errs=errs, kms=kms,
                          runs=runs, viols=viols, scale=scale)
    # kernel 3's bound at B=1: the family's per-lane counts by the inner
    # iterations these lanes ran (``run_family``'s bounds)
    numbers = {}
    for label, (_, _, _, lane_ops) in laps.items():
        r = out[label]
        if lane_ops is None:
            phase(f"simulator:{label}", B=1, tol=ACTION_TOL, floor=ACTION_FLOOR,
                  viol_max=LAP_VIOL_MAX, **r["rows"])
            continue
        prob, cfg = r["prob"], r["cfg"]
        A, f4 = cfg.n_alpha, 4
        loops = cfg.n_outer + (1 if cfg.n_polish else 0)
        sweeps = 1 + loops + cfg.n_outer + 1
        fam = prob.family
        ops = statistics.median(r["runs"]) * (lane_ops["backward"]
                                              + (A + 1) * lane_ops["candidate"]) \
            + sweeps * lane_ops["candidate"]
        b_ms, b_by = bound(nbytes(*r["inputs"][0]) + f4 * (fam.H * (fam.NZ + fam.NU + fam.NC)
                                                           + cuda_lib.SOLVE_STATS), ops)
        ms = statistics.median(r["kms"])
        phase(f"simulator:{label}", B=1, A=A, budget=f"{cfg.n_outer}x{cfg.n_inner}",
              mu0=cfg.mu0, scale="/".join(f"{v:.6g}" for v in r["scale"]), tol=ACTION_TOL,
              floor=ACTION_FLOOR, kernel_ms_b1=f"{ms:.3f}", bound_ms_b1=f"{b_ms:.6f}({b_by})",
              **r["rows"])
        numbers[label] = dict(B=1, ms=ms, bound_ms=b_ms, bound_by=b_by,
                              max_abs_err=max(r["errs"]), inner_runs=r["runs"])
    return numbers, out


def action_witness(label, action_errs):
    """LAP_SHARES' rule for a lap's first actions: ``action_errs`` is each
    compared step's (kernel 3's error against f64, the plain f32 version's,
    whether it met ACTION_TOL or the plain's error plus ACTION_FLOOR); the
    steps that did not meet it go to ``lane_witness``.  Returns its text;
    raises as it does."""
    kern, plain, ok = (torch.tensor(v) for v in zip(*action_errs))
    return lane_witness(f"{label} first actions", ~ok, kern.double(), plain.double(),
                        ACTION_FLOOR, LAP_SHARES[label])


def disc_passes(states, discs):
    """For each disc (s, ey, r): the side the car passed it on ("left": ey
    above the disc's centre, where ey grows to the left of the centre
    line) at the state nearest its centre in the (s, ey) plane, and that
    least distance."""
    out = []
    for so, eo, _ in discs:
        d = np.sqrt((states[:, 4] - so) ** 2 + (states[:, 5] - eo) ** 2)
        i = int(d.argmin())
        out.append(("left" if states[i, 5] > eo else "right", float(d[i])))
    return out


def simulator_obstacles_lap(env):
    """[simulator:obstacles_lap]: the simconfig's lap with obstacles on
    through RacingSimulator on the card (kernel 3 at B=1, the controller
    YAML's budget).  Where its largest violation exceeds LAP_VIOL_MAX, a
    second simulator replays the lap to that step (bit for bit) for
    ``simulator_kernel3_vs_plain``.  Returns the simulator, its controller's
    name, the snapshots (that step -> (state, carry), or none) and the
    lap's numbers for the kernels line."""
    from vehicle_control_tpu_torch.controllers.mpc.controllers import MPCCarry
    from vehicle_control_tpu_torch.simulation import RacingSimulator
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM
    from vehicle_control_tpu_torch.utils.config import load_config
    from vehicle_control_tpu_torch.utils.profiling import StepTimer

    root = env["root"]
    simcfg = load_config(f"{root}/configs/simconfig.yaml")
    simcfg.update(obstacles=True, name="obstacles_lap", save_data=False, logging=False,
                  output_dir=os.path.join(root, "build", "simulator"))
    track_cfg = load_config(f"{root}/configs/environment/{simcfg['track_name']}.yaml")
    sim = RacingSimulator(simcfg, env["car"], track_cfg)
    (name,) = sim.entries
    entry = sim.entries[name]
    discs = entry.problem.family.obstacles
    kernels = entry.run_chunk.kernels
    if len(kernels) != 1 or not isinstance(kernels[0], SolveKernelFM) or not discs:
        raise RuntimeError(f"the obstacle lap runs {kernels} on {len(discs)} discs, not kernel "
                           f"3 alone with the track's obstacles")
    (solve_kernel,) = kernels
    solve_kernel.launches = 0
    t0 = time.perf_counter()
    sim.run(max_steps=OBS_LAP_MAX_STEPS, chunk=LAP_CHUNK)
    lap_s = time.perf_counter() - t0
    launches = solve_kernel.launches
    st, viol = sim.state_traj[name].astype(np.float64), sim.violation_traj[name]
    lap_time = float(st[-1, sim.t_index]) + sim.dt
    ref = np.load(os.path.join(root, OBS_REF_RUN, f"{name}_state_traj.npy"))
    ref_lap = float(ref[-1, sim.t_index]) + sim.dt  # counted as lap_time is
    passes, ref_passes = disc_passes(st, discs), disc_passes(ref, discs)
    timer = StepTimer()
    timer.times = list(sim.elapsed[name])
    steps_ms = timer.summary()
    cleared = all(d > r for (_, d), (_, _, r) in zip(passes, discs))
    worst = int(viol.argmax())
    phase("simulator:obstacles_lap", controller=name, track=sim.track.name,
          dtype=str(sim.dtype).removeprefix("torch."), chunk=LAP_CHUNK, discs=len(discs),
          lap_completed=entry.done, lap_time_s=f"{lap_time:.4f}", ref_lap_time_s=f"{ref_lap:.4f}",
          tol=OBS_LAP_TOL, lap_steps=len(st), ref_lap_steps=len(ref), steps_run=entry.steps,
          kernel3_launches=launches, median_step_ms=f"{steps_ms['p50_ms']:.2f}",
          p95_step_ms=f"{steps_ms['p95_ms']:.2f}", mean_step_ms=f"{steps_ms['mean_ms']:.2f}",
          lap_wall_s=f"{lap_s:.1f}", max_violation=f"{viol.max():.3e}",
          max_violation_step=worst, steps_above_viol_max=int((viol > LAP_VIOL_MAX).sum()),
          iterations_mean=f"{sim.iter_traj[name].mean():.2f}", cleared=cleared,
          sides="|".join(f"{i}@{so:g}/{eo:g}:{p[0]}/{q[0]},dist:{p[1]:.3f}/{q[1]:.3f}>r{r:g}"
                         for i, ((so, eo, r), p, q) in enumerate(zip(discs, passes, ref_passes))),
          sides_key="disc@s/ey:port/jax,least_dist:port/jax>radius",
          same_sides=sum(p[0] == q[0] for p, q in zip(passes, ref_passes)))
    if not entry.done:
        raise RuntimeError(f"the obstacle lap did not complete in {OBS_LAP_MAX_STEPS} steps")
    if not abs(lap_time - ref_lap) <= OBS_LAP_TOL * ref_lap:
        raise RuntimeError(f"obstacle lap time {lap_time:.4f} s, the JAX f64 lap {ref_lap:.4f} s")
    if not cleared:
        raise RuntimeError(f"a disc not cleared: {passes} against the radii of {discs}")
    if launches != entry.steps:
        raise RuntimeError(f"kernel 3 launched {launches} times in {entry.steps} steps")
    snaps = {}
    if not viol.max() <= LAP_VIOL_MAX:  # replay to the worst step
        replay = RacingSimulator(simcfg, env["car"], track_cfg)
        replay.run(max_steps=worst, chunk=LAP_CHUNK)
        e = replay.entries[name]
        if e.steps != worst or not np.array_equal(
                e.state[0].cpu().numpy(), sim.state_traj[name][worst]):
            raise RuntimeError(f"the replay of the obstacle lap to step {worst} is not the lap's "
                               f"state bit for bit")
        snaps[worst] = (e.state.clone(), MPCCarry(*(a.clone() for a in e.carry)))
    return sim, name, snaps, dict(launches=launches, steps=entry.steps, lap_time_s=lap_time,
                                  ref_lap_time_s=ref_lap, median_step_ms=steps_ms["p50_ms"],
                                  p95_step_ms=steps_ms["p95_ms"], lap_wall_s=lap_s,
                                  max_violation=float(viol.max()), max_violation_step=worst)


def obstacle_violation_gate(lap, worst):
    """The obstacle lap's violations (``simulator_obstacles_lap``'s numbers
    ``lap``): at most LAP_VIOL_MAX, or at the replayed worst step
    (``worst``: step -> (kernel's, plain f32's, f64's violation)) the
    kernel's at most the largest QUANT_FACTOR x the larger of the plain
    solve's in f32 and f64 plus LAP_VIOL_MAX."""
    if lap["max_violation"] <= LAP_VIOL_MAX:
        return
    ((step, (v_k, v_p, v_64)),) = worst.items()
    if not v_k <= max(QUANT_FACTOR.values()) * max(v_p, v_64) + LAP_VIOL_MAX:
        raise RuntimeError(f"obstacle lap: max violation {lap['max_violation']:.3e} at step "
                           f"{step}; there kernel 3 gives {v_k:.4g}, the plain solve "
                           f"{v_p:.4g} in f32 and {v_64:.4g} in f64")


def load_track_config(root, track):
    from vehicle_control_tpu_torch.utils.config import load_config

    return load_config(f"{root}/configs/environment/{track}.yaml").to_dict()


def card_line():
    """(torch's name of card 0, nvidia-smi's name and power limit line)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def print_ptxas(lib_path):
    """Each kernel's stack frame, spills and registers from the build log."""
    with open(lib_path[:-3] + ".log") as fh:
        log = fh.read().splitlines()
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
            frame = log[i + 2].strip() if i + 2 < len(log) else ""
            regs = log[i + 3].split(":", 1)[-1].strip() if i + 3 < len(log) else ""
            print(f"  ptxas: {kernel[:48]}: {frame}; {regs}")


def make_env(dev):
    """The cars, the track and the plant steps the families share: the
    dynamic car's (``car``, ``transition``) and the kinematic car's
    (``kin_car``, ``kin_transition``)."""
    from vehicle_control_tpu_torch.environment.track import Track
    from vehicle_control_tpu_torch.models import dynamic_car as dc
    from vehicle_control_tpu_torch.models import kinematic_car as kc
    from vehicle_control_tpu_torch.utils.config import load_config, project_root

    root = project_root()
    car = load_config(f"{root}/configs/models/dynamic_car.yaml")
    kin_car = load_config(f"{root}/configs/models/kinematic_car.yaml")
    track = Track(load_config(f"{root}/configs/environment/ippodromo.yaml"))
    return dict(dev=dev, root=root, car=car, track=track,
                transition=dc.make_transitions(dc.DynamicCarParams.from_config(car))[0],
                kin_car=kin_car,
                kin_transition=kc.make_transitions(kc.KinematicCarParams.from_config(kin_car))[0],
                tdata=track.data.to(dev, torch.float32))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from vehicle_control_tpu_torch.solvers import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain Riccati
    dev = torch.device(DEVICE, 0)

    # 1. device
    name, smi = card_line()
    phase("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=repr(smi))

    # 2. build, each kernel's registers and stack, and the launch shape of
    # the team kernels (2 and 3) at B with their residency per SM
    t0 = time.perf_counter()
    warm = start_warm(FAMILIES)  # the families' checks' inputs, beside the build
    count_build = start_count_build()  # g++, beside nvcc
    lib_path = cuda_lib.build_library()
    lib = cuda_lib.load_library()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", library=lib_path.split("/")[-1])
    print_ptxas(lib_path)
    launch = {key: cuda_lib.launch_info(fn, B) for key, fn in
              (("bw", lib.vct_backward_fm_info), ("sv", lib.vct_solve_fm_info))}
    for key, info in launch.items():
        phase(f"launch:{'backward_fm' if key == 'bw' else 'solve_fm'}", B=B, **info)
    env = make_env(dev)
    env["count_lib"] = load_count_build(*count_build)
    env["warm"] = warm
    # every family's checks, in the order their start_warm processes end,
    # beside those processes and check (ii)'s f64 solves on the CPU; then,
    # once all of these are done, every family's timed phases alone on the
    # card and the host
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    results, parts = {}, {label: run_family(label, env) for label in FAMILIES}
    labels = {f: label for label, f in warm[1].items()}
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        env["cpu_pool"] = pool
        for f in as_completed(labels):
            t_fam = time.perf_counter()
            next(parts[labels[f]])
            phase(f"{labels[f]}:checks_seconds", seconds=f"{time.perf_counter() - t_fam:.1f}")
    warm_barrier(env)
    for label, part in parts.items():
        t_fam = time.perf_counter()
        results[label] = next(part)
        phase(f"{label}:timed_seconds", seconds=f"{time.perf_counter() - t_fam:.1f}")
    t_sim = time.perf_counter()
    # each lap alone, its seconds; then the plain solves of its steps on the
    # CPU, and kernel 3 against them (the lap's family's lane counts for its
    # B=1 bound)
    ran, compare, submitted = {}, {}, {}
    for tag in LAPS:
        t_lap = time.perf_counter()
        if tag == "obstacles":
            ran[tag] = simulator_obstacles_lap(env)
            compare["obstacles_worst_step"] = ran[tag][:3] + (None,)
        else:
            ran[tag] = simulator_lap(env, tag)
            label = "kernel3_vs_plain" if tag == "cascaded" else f"{tag}_vs_plain"
            compare[label] = ran[tag][:3] + (results[tag]["sv"]["lane_ops"],)
        phase(f"simulator:{tag}_lap_seconds", seconds=f"{time.perf_counter() - t_lap:.1f}")
    t_cmp = time.perf_counter()
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        for label, lap in compare.items():
            submitted[label] = submit_vs_plain(pool, env, lap)
        b1, compared = simulator_kernel3_vs_plain(env, compare, submitted)
    phase("simulator:vs_plain_seconds", seconds=f"{time.perf_counter() - t_cmp:.1f}")
    obs_lap = ran["obstacles"][3]
    worst = compared["obstacles_worst_step"]["viols"]
    obs_lap["worst_step_violation"] = {k: dict(kernel=v[0], plain_f32=v[1], f64=v[2])
                                       for k, v in worst.items()}
    obstacle_violation_gate(obs_lap, worst)
    phase("simulator:seconds", seconds=f"{time.perf_counter() - t_sim:.1f}")

    def row(key, kname, src, replaces):
        per = {label: results[label][key] for label in results}
        top = dict(per[TOP_FAMILY])
        top["launches"] = sum(p["launches"] for p in per.values())
        return dict(name=kname, route="cuda", source=f"vehicle_control_tpu_torch/csrc/{src}",
                    replaces=f"vehicle_control_tpu/solvers/{replaces}",
                    launches=top["launches"], max_abs_err=top["max_abs_err"], ms=top["ms"],
                    plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                    bound_by=top["bound_by"], library_ms=None, per_family=per,
                    **({"launch": launch[key]} if key in launch else {}))

    kernels = [
        row("ls", "linesearch_fm", "rollout_fm.cu", "rollout_kernel_fm.py:42"),
        row("bw", "backward_fm", "backward_fm.cu", "backward_kernel_fm.py:40"),
        row("sv", "solve_fm", "solve_fm.cu", "solve_kernel_fm.py:114"),
        row("dv", "derivs_fm", "derivs_fm.cu", "derivs_kernel_fm.py:43"),
        row("aos", "linesearch_aos", "rollout_aos.cu", "rollout_kernel.py:63"),
    ]
    # the simulator's laps are kernel 3's other paths: their launches join the
    # count (the kinematic lap's the kinematic family's too, the kc lap's the
    # kc cascade's)
    for tag, (_, _, _, numbers) in ran.items():
        kernels[2]["launches"] += numbers["launches"]
        if tag in ("kinematic", "cascaded_kinematic"):
            kernels[2]["per_family"][tag]["launches"] += numbers["launches"]
        label = "kernel3_vs_plain" if tag == "cascaded" else f"{tag}_vs_plain"
        key = "simulator_lap" if tag == "cascaded" else f"simulator_{tag}_lap"
        kernels[2][key] = dict(numbers, **b1.get(label, {}))
    missing = unlaunched(kernels)
    if missing:
        raise RuntimeError(f"a kernel was never launched on its path: {missing}")
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
