"""Smoke run of the torch port on one NVIDIA GPU.

Builds the five CUDA kernels from ``vehicle_control_tpu_torch/csrc`` with
nvcc (one process per source, all at once) and prints each kernel's
registers and stack, and for kernels 1-4 their launch shape (threads per
launch, shared memory per block, resident warps per SM).  Then it runs two
families at the bench's protocol (B=4096, f32, K=10 steps per chunk, states
from ``initial_states`` seed 0 with their aligned carries):

* the single-track family (``singletrack.yaml``, N=30, budget 2 outer x 5
  inner + 3 polish iterations, 6 line-search steps, mu0=300);
* the paper's cascade (``cascaded.yaml``, ``tail="pm"``: N=20 single-track
  and M=40 point-mass stages, H=60, budget 2 x 6 + 3 polish, 6 steps,
  mu0=300).

For each family it holds kernels 1 (line search), 2 (backward pass), 4
(stage derivatives), 5 (the line search in the array-of-structs layout)
and 3 (the whole solve) against their plain PyTorch versions on the inputs
of the solve after one closed-loop step whose solve is the plain whole
solve (so no kernel computed them; kernel 3 at the full budget on that
step's own cold first solve, both f32 versions against the plain version
in f64), drives the main path (the whole solve
in one launch, kernel 3), 1 warm and 3 timed chunks, with exactly one
kernel-3 launch per step and nothing else, profiles one main-path step,
counts each kernel's work and times each kernel against its plain version
(kernels 1, 4 and 5 as the launch alone and with their wrappers).  For the
single-track family it also drives the per-phase route (kernels 1 + 2) and
the derivatives route (kernel 4, the torch Riccati sweep, kernel 1), 1 warm
and 1 timed chunk of 2 steps each, with their launch counts.  Kernel 5 sits
on no route (as in the JAX package): it is launched only to be checked and
timed beside kernel 1.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of the kernels, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed
phase raises and the script exits non-zero; without CUDA it exits 1 and
prints no result.  Writes nothing outside ``build/``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, K, TIMED_CHUNKS, DT = 4096, 10, 3, 0.05
SIDE_K, SIDE_TIMED_CHUNKS = 2, 1  # the two earlier routes, cut in depth
FAMILIES = {  # controller config, tail, horizon cut, budget (bench.py's family table)
    "singletrack": ("singletrack.yaml", "none", dict(horizon=30),
                    dict(n_outer=2, n_inner=5, n_polish=3, n_alpha=6, mu0=300.0)),
    "cascaded": ("cascaded.yaml", "pm", dict(horizon=20, horizon_pm=40),
                 dict(n_outer=2, n_inner=6, n_polish=3, n_alpha=6, mu0=300.0)),
}
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
# Kernel 5 computes kernel 1's costs and is held to kernel 1's gates.
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
# version's plus LS_FLOOR), and at most
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
WITNESS_SHARE = 1e-3
ULP_COPIES = 64  # copies of a disputed rollout's inputs, one f32 ulp apart
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
REPS, PLAIN_REPS = 20, 5  # the plain whole solve is timed once, in check (ii)
# the card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores and HBM bandwidth, for each kernel's bound
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
OP_COUNT_LANES = 64
DEVICE = "cuda"


def phase(label, **fields):
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


def as_accurate(what, kern_err, plain_err, floor):
    """Raise unless the kernel's errors against f64 are, at each gated
    quantile, within QUANT_FACTOR of the plain f32 version's plus floor;
    return the quantiles (kernel/plain) as text."""
    out = []
    for q in (*QUANT_FACTOR, 0.999, 1.0):
        k, p = (torch.quantile(e, q).item() for e in (kern_err, plain_err))
        out.append(f"q{q:g}:{k:.2e}/{p:.2e}")
        factor = QUANT_FACTOR.get(q)
        if factor is not None and not k <= factor * p + floor:
            raise RuntimeError(f"{what}: kernel vs f64 at quantile {q} is {k:.3e}, "
                               f"plain f32 vs f64 {p:.3e} (allowed {factor} x plain + {floor})")
    return ",".join(out)


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


def witness(what, disputed, kernel_side, numbers, total):
    """The f64 witness of a lane-by-lane gate.  ``disputed`` (bool): the
    lanes where the kernel missed the gate against the plain f32 version;
    ``kernel_side`` (bool, same shape): where the plain version in f64 sides
    with the kernel; ``numbers``: name -> tensor of that shape, printed for
    each decided lane.  Raises if the witness sides with the plain version
    on a disputed lane, or if more than WITNESS_SHARE of the ``total`` lanes
    are disputed; returns the count and the decided lanes as text."""
    idx = disputed.nonzero().tolist()
    rows = ["/".join(map(str, i)) + ":" + ",".join(f"{k}={v[tuple(i)].item():.4g}"
                                                   for k, v in numbers.items()) for i in idx]
    lost = int((disputed & ~kernel_side).sum())
    if lost:
        raise RuntimeError(f"{what}: the f64 witness sides with the plain version on {lost} of "
                           f"{len(idx)} disputed lanes: {' '.join(rows)}")
    if len(idx) > WITNESS_SHARE * total:
        raise RuntimeError(f"{what}: {len(idx)} of {total} lanes decided by the f64 witness "
                           f"(at most {WITNESS_SHARE}): {' '.join(rows)}")
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


def solve_witness(what, err, kern64, plain64):
    """Kernel 3 check (i), per lane: ``err`` the kernel's error against the
    plain f32 version (not <= SOLVE_TOL: disputed, NaN included),
    ``kern64``/``plain64`` the kernel's and the plain f32 version's errors
    against the plain version in f64."""
    factor = max(QUANT_FACTOR.values())
    return witness(what, ~(err <= SOLVE_TOL), kern64 <= factor * plain64 + LS_FLOOR,
                   dict(err=err, kernel_f64=kern64, plain_f64=plain64), err.numel())


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


def family_problem(label, env):
    """(problem, budget, main-path config, main-path step, shape fields)."""
    from vehicle_control_tpu_torch.controllers.mpc import problems
    from vehicle_control_tpu_torch.parallel.batch import make_batched_racing_step
    from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
    from vehicle_control_tpu_torch.utils.config import load_config

    ctrl_yaml, tail, horizon, budget = FAMILIES[label]
    ctrl = load_config(f"{env['root']}/configs/controllers/{ctrl_yaml}")
    ctrl.update(obstacles=False, **horizon)
    problem = problems.build_cascaded_problem(env["car"], env["track"], ctrl, tail,
                                              torch.float32, env["dev"])
    fam = problem.family
    shape = dict(B=B, H=fam.H) if tail == "none" else dict(B=B, N=fam.N, M=fam.H - fam.N)
    cfg = ALILQRConfig(**budget, use_solve_kernel=True)
    main_step = make_batched_racing_step(problem, cfg, env["transition"], env["tdata"], DT, 4)
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


def warm_inputs(problem, cfg, env):
    """The checks' inputs, computed by no kernel: the drops
    (``initial_states`` seed 0) with their aligned carry, one closed-loop
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
    plain = PlainSolve(problem.family, cfg)
    plain_step = make_batched_racing_step(problem, cfg, env["transition"], env["tdata"], DT, 4,
                                          kernels=dict(solve_kernel=plain))
    states = torch.as_tensor(initial_states(env["track"].length, B, np.random.default_rng(0)),
                             dtype=f32, device=dev)
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


def run_family(label, env):
    """Checks, main path, profile, timings and bounds of one family; returns
    its numbers for the kernels line."""
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
    fam, tail = problem.family, FAMILIES[label][1]
    H = fam.H
    (solve_kernel,) = main_step.kernels
    side = {}
    if tail == "none":  # the two earlier routes
        side["per_phase_path"] = make_batched_racing_step(
            problem, ALILQRConfig(**budget), env["transition"], env["tdata"], DT, 4)
        side["derivs_path"] = make_batched_racing_step(
            problem, ALILQRConfig(**budget, use_derivs_kernel=True), env["transition"],
            env["tdata"], DT, 4)
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
    w = warm_inputs(problem, cfg, env)
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
        for name, kern in (("kernel 1", ls_kernel), ("kernel 5", aos_kernel)):
            costs = kern(*ls_args)
            torch.cuda.synchronize()
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
                if not kp.max() <= LS_RTOL:
                    raise RuntimeError(f"{name} (rho={rho_v}): max relative error {kp.max():.3e}")
            else:
                fin = fin & torch.isfinite(costs64)
                row += ",vs_f64:" + as_accurate(f"{name} (rho={rho_v})",
                                                cost_errors(costs[fin], costs64[fin]),
                                                cost_errors(costs_ref[fin], costs64[fin]),
                                                LS_FLOOR)
            ls_rows[f"{'k1' if kern is ls_kernel else 'k5'}_{cond}"] = row
        if not torch.equal(got[4], ref[4]):
            raise RuntimeError(f"kernel 2 ({cond}): fail flags differ on "
                               f"{(got[4] != ref[4]).sum().item()} lanes")
        # a lane whose warm start diverged can overflow its gains (flagged
        # not PD); such lanes must be the same in both, and are not compared
        ok = finite_lanes(ref[:4])
        if not torch.equal(finite_lanes(got[:4]), ok):
            raise RuntimeError(f"kernel 2 ({cond}): the lanes with non-finite gains differ")
        if cond == "rho0":
            ref64 = backward_plain(fam, *(t.double() for t in bw_args))
            ok64 = ok & finite_lanes(ref64[:4])
        for key, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
            kp = lane_errors(a[ok], b[ok])
            row = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
            if cond == "well":
                bw_abs = max(bw_abs, (a[ok] - b[ok]).abs().max().item())
                if not kp.max() <= BW_TOL:
                    raise RuntimeError(f"kernel 2 (rho={rho_v}): {key} error {kp.max():.3e}")
            else:
                c = ref64[("kff", "Kfb", "dV1", "dV2").index(key)][ok64]
                row += ",vs_f64:" + as_accurate(f"kernel 2 (rho={rho_v}) {key}",
                                                lane_errors(a[ok64], c), lane_errors(b[ok64], c),
                                                BW_FLOOR)
            bw_rows[f"{key}_{cond}"] = row
        bw_rows[f"fail_lanes_{cond}"] = int(got[4].sum())
        bw_rows[f"nonfinite_lanes_{cond}"] = int((~ok).sum())
    phase(f"{label}:kernel1_kernel5_vs_plain", **shape, A=len(alphas), rho_well=RHO_WELL,
          rho_solver=cfg.rho0, k1_max_abs_err_well=f"{ls_abs:.3e}",
          k5_max_abs_err_well=f"{aos_abs:.3e}", **ls_rows)
    phase(f"{label}:kernel2_vs_plain", **shape, rho_well=RHO_WELL, rho_solver=cfg.rho0,
          max_abs_err_well=f"{bw_abs:.3e}", **bw_rows)

    # the launch shapes of kernels 1 and 4 at the family's shapes
    lib = cuda_lib.load_library()
    launch_shapes = dict(ls=cuda_lib.launch_info(lib.vct_linesearch_fm_info, B, len(alphas)),
                         dv=cuda_lib.launch_info(lib.vct_derivs_fm_info, B, H))
    phase(f"{label}:launch:linesearch_fm", B=B, A=len(alphas), **launch_shapes["ls"])
    phase(f"{label}:launch:derivs_fm", B=B, H=H, **launch_shapes["dv"])

    # kernel 4 against its plain version (no rho: a direct check)
    dv_args = (X, U, lam, mu, curv, ds)
    got, ref = dv_kernel(*dv_args), derivs_plain(fam, *dv_args)
    torch.cuda.synchronize()
    dv_rows, dv_abs = {}, 0.0
    ok = finite_lanes(ref)
    if not torch.equal(finite_lanes(got), ok):
        raise RuntimeError("kernel 4: the lanes with non-finite derivatives differ")
    dv_rows["nonfinite_lanes"] = int((~ok).sum())
    for key, a, b in zip(("g", "Hw", "J"), got, ref):
        if a.shape != b.shape:
            raise RuntimeError(f"kernel 4: {key} has shape {tuple(a.shape)}")
        a, b = a[ok], b[ok]
        kp = lane_errors(a, b)
        dv_abs = max(dv_abs, (a - b).abs().max().item())
        dv_rows[key] = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
        if not kp.max() <= DV_TOL:
            raise RuntimeError(f"kernel 4: {key} error {kp.max():.3e} > {DV_TOL} on "
                               f"{int((kp > DV_TOL).sum())} lanes")
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

    def solve_lane_errors(a):  # (B,): a's worst of X, U, cost against f64
        e = torch.maximum(lane_errors(a[0], ref64[0]), lane_errors(a[1], ref64[1]))
        ok = torch.isfinite(a[3]) & torch.isfinite(ref64[3])
        e[ok] = torch.maximum(e[ok], cost_errors(a[3][ok], ref64[3][ok]))
        return e

    err = torch.zeros(B, dtype=torch.float64, device=dev)
    err[same] = torch.maximum(x_err, u_err)
    err[fin] = torch.maximum(err[fin], c_err)
    decided = solve_witness(f"{label} kernel 3 (well)", err[same],
                            solve_lane_errors(got)[same], solve_lane_errors(ref)[same])
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
    first_args, first_ref, sv_plain_ms = w["first"]
    first_got = solve_kernel(*first_args, trace=True)
    first_64 = solve_plain(fam, cfg, *(t.double() for t in first_args), trace=True)
    torch.cuda.synchronize()
    rows, passed = solve_gates(first_got, first_ref, first_64)
    phase(f"{label}:kernel3_vs_plain_rho0", **shape, rho0=cfg.rho0, inputs="cold_first_solve",
          **rows)
    if not passed:
        raise RuntimeError(f"{label} kernel 3 (rho0): the gates failed: {rows}")
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
        ls=cuda_ms(lambda: linesearch_costs_plain(fam, alphas, *ls_args), PLAIN_REPS),
        bw=cuda_ms(lambda: backward_plain(fam, *bw_args), PLAIN_REPS),
        dv=cuda_ms(lambda: derivs_plain(fam, *dv_args), PLAIN_REPS),
        sv=sv_plain_ms,
    )
    plain_ms["aos"] = plain_ms["ls"]
    phase(f"{label}:timing", median_of=REPS, plain_median_of=PLAIN_REPS, solve_plain_runs=1,
          **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
          **{f"{k}_wrapper_ms": f"{v:.3f}" for k, v in wrapper_ms.items()},
          **{f"{k}_plain_ms": f"{v:.3f}" for k, v in plain_ms.items()})

    # each kernel's bound: its bytes (inputs read once, outputs written
    # once) and its operations, counted on the plain version's arithmetic
    # over OP_COUNT_LANES lanes and scaled to B; kernel 3's by the inner
    # iterations each lane of the timed inputs ran
    lanes = OP_COUNT_LANES
    sub = lambda ts: tuple(t[:lanes] for t in ts)  # noqa: E731
    ops_cand = count_ops(lambda: linesearch_costs_plain(fam, alphas[:1], *sub(ls_args))) / lanes
    ops_bw = count_ops(lambda: backward_plain(fam, *sub(bw_args))) / lanes
    ops_dv = count_ops(lambda: derivs_plain(fam, *sub(dv_args))) / lanes
    A = len(alphas)
    # per lane: each inner iteration a backward pass, A candidates and a
    # re-roll (as one candidate); per solve a warm rollout, one AL cost sweep
    # per inner loop, one multiplier update per outer iteration and the
    # finalize sweep (one candidate each)
    sweeps = 1 + (cfg.n_outer + 1) + cfg.n_outer + 1
    ops_sv = runs.double().sum().item() * (ops_bw + (A + 1) * ops_cand) + B * sweeps * ops_cand
    f4, NZ, NU, NC = 4, fam.NZ, fam.NU, fam.NC  # bytes of an f32, the widths
    NW = NZ + NU
    bounds = {  # outputs: costs (A, B); kff, Kfb, dV (2, B), fail (B);
        # g, Hw, J; X, U, lam and the SOLVE_STATS rows
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
    return out


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
    """The car, the track and the plant step the families share."""
    from vehicle_control_tpu_torch.environment.track import Track
    from vehicle_control_tpu_torch.models import dynamic_car as dc
    from vehicle_control_tpu_torch.utils.config import load_config, project_root

    root = project_root()
    car = load_config(f"{root}/configs/models/dynamic_car.yaml")
    track = Track(load_config(f"{root}/configs/environment/ippodromo.yaml"))
    return dict(dev=dev, root=root, car=car, track=track,
                transition=dc.make_transitions(dc.DynamicCarParams.from_config(car))[0],
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
    lib_path = cuda_lib.build_library()
    lib = cuda_lib.load_library()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", library=lib_path.split("/")[-1])
    print_ptxas(lib_path)
    launch = {key: cuda_lib.launch_info(fn, B) for key, fn in
              (("bw", lib.vct_backward_fm_info), ("sv", lib.vct_solve_fm_info))}
    for key, info in launch.items():
        phase(f"launch:{'backward_fm' if key == 'bw' else 'solve_fm'}", B=B, **info)
    env = make_env(dev)
    results = {}
    for label in FAMILIES:
        results[label] = run_family(label, env)

    def row(key, kname, src, replaces):
        per = {label: results[label][key] for label in FAMILIES}
        top = dict(per["cascaded"])  # the slice's path; per_family has both
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
    # kernel 5 sits on no route; every other kernel must have run on its path
    if any(k["launches"] < 1 for k in kernels if k["name"] != "linesearch_aos"):
        raise RuntimeError(f"a kernel was never launched on its path: {kernels}")
    phase("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
