"""Smoke run of the torch port on one NVIDIA GPU.

Builds the four CUDA kernels from ``vehicle_control_tpu_torch/csrc`` with
nvcc (one process per source, all at once), holds each against its plain
PyTorch version at the main path's shapes, and drives the batched
single-track closed loop (the bench's protocol: N=30, B=4096, f32, budget 2
outer x 5 inner + 3 polish iterations, 6 line-search steps, mu0=300, K=10
steps per chunk) on its three kernel routes:

* the main path, the whole solve in one launch (kernel 3), 1 warm and 3
  timed chunks: exactly one kernel-3 launch per step and nothing else;
* the per-phase route (kernels 1 + 2) and the derivatives route (kernel 4,
  the torch Riccati sweep, kernel 1), 1 warm and 1 timed chunk of 2 steps
  each, with their launch counts.

Then it profiles one main-path step, counts each kernel's work, and times
each kernel against its plain version.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of the kernels, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed
phase raises and the script exits non-zero; without CUDA it exits 1 and
prints no result.  Writes nothing outside ``build/``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N, B, K, TIMED_CHUNKS, DT = 30, 4096, 10, 3, 0.05
SIDE_K, SIDE_TIMED_CHUNKS = 2, 1  # the two earlier routes, cut in depth
BUDGET = dict(n_outer=2, n_inner=5, n_polish=3, n_alpha=6, mu0=300.0)
# Kernel vs plain, at a real warm-started state, twice.  With the Riccati
# regularization rho = RHO_WELL both computations are well conditioned (the
# plain version in f32 stays within ~1e-5 of f64, N=30), so the kernel is
# held to direct tolerances: costs to LS_RTOL relative, gains to BW_TOL of
# each lane's largest magnitude, +inf lanes and PD-failure flags identical.
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
# (In f64, a host build of the same CUDA sources matches the plain
# versions to 1e-15 in costs and 5e-10 in the gains.)
RHO_WELL = 1.0
LS_RTOL = 1e-4
BW_TOL = 1e-3
QUANT_FACTOR = {0.5: 4.0, 0.9: 4.0, 0.99: 4.0}
LS_FLOOR = 1e-6  # relative, costs |a - b| / max(|b|, 1)
BW_FLOOR = 1e-5  # per lane, |a - b| / (1 + max |b| of the lane)
# Kernel 4 involves no rho: g, Hw and J are direct functions of the inputs,
# so every lane is held to DV_TOL of its largest magnitude.
DV_TOL = 1e-4
# Kernel 3, (i) one outer x one inner iteration at rho0 = RHO_WELL: the
# chosen step is identical on >= STEP_SAME of the lanes, and on those X, U
# (per lane, of the lane's magnitude) and cost (relative) agree to SOLVE_TOL.
# (ii) the full budget at the solver's rho0: the f32 rounding of either
# version tips Armijo ties and chaotic lanes, so it is held to the gates of
# the JAX package's own kernel-vs-solver check (tests/test_solve_kernel_flow.py:
# _compare): converged fractions within CONV_GAP, converged-flag flips on
# fewer than FLIP_MAX of the lanes with the kernel's cost no worse on a
# majority of them, median relative cost difference on lanes converged in
# both below COST_MEDIAN, iterations within 2 on at least ITER_WITHIN2.
# (iii) early exit and the alpha=1 fast path change no output bit.
SOLVE_TOL = 1e-4
STEP_SAME = 0.999
CONV_GAP, FLIP_MAX, COST_MEDIAN, ITER_WITHIN2 = 0.02, 0.02, 1e-4, 0.95
CONV_FLOOR = 0.90  # sanity gate on the converged fraction, not a target
REPS, PLAIN_REPS, SOLVE_PLAIN_REPS = 20, 5, 3
# the card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores and HBM bandwidth, for each kernel's bound
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
OP_COUNT_LANES = 64
DEVICE = "cuda"


def phase(label, **fields):
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps=REPS, warm=True):
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lane_errors(a, b):
    """Per lane (batch axis 0): max |a - b| / (1 + max |b| of the lane)."""
    a, b = a.double(), b.double()
    scale = 1.0 + b.abs().reshape(b.shape[0], -1).amax(-1)
    return (a - b).abs().reshape(b.shape[0], -1).amax(-1) / scale


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    from vehicle_control_tpu_torch.controllers.mpc import problems
    from vehicle_control_tpu_torch.environment.track import Track
    from vehicle_control_tpu_torch.models import dynamic_car as dc
    from vehicle_control_tpu_torch.parallel.batch import (
        aligned_carry,
        initial_states,
        make_batched_racing_step,
    )
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, rollout
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
    from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import derivs_plain
    from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import linesearch_costs_plain
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM, solve_plain
    from vehicle_control_tpu_torch.utils.config import load_config, project_root

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 in the plain Riccati
    dev = torch.device(DEVICE, 0)
    f32 = torch.float32

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=repr(smi))

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_lib.build_library()
    cuda_lib.load_library()
    build_s = time.perf_counter() - t0
    with open(lib_path[:-3] + ".log") as fh:
        ptxas = [ln.strip() for ln in fh
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    phase("build", seconds=f"{build_s:.1f}", library=lib_path.split("/")[-1])
    for ln in ptxas:
        print("  ptxas: " + ln)

    # the three routes' objects
    root = project_root()
    track = Track(load_config(f"{root}/configs/environment/ippodromo.yaml"))
    car = load_config(f"{root}/configs/models/dynamic_car.yaml")
    ctrl = load_config(f"{root}/configs/controllers/singletrack.yaml")
    ctrl["obstacles"] = False
    ctrl["horizon"] = N
    problem = problems.build_cascaded_problem(car, track, ctrl, "none", f32, dev)
    transition, _ = dc.make_transitions(dc.DynamicCarParams.from_config(car))
    tdata = track.data.to(dev, f32)
    cfg = ALILQRConfig(**BUDGET, use_solve_kernel=True)
    main_step = make_batched_racing_step(problem, cfg, transition, tdata, DT, 4)
    phase_step = make_batched_racing_step(problem, ALILQRConfig(**BUDGET), transition, tdata,
                                          DT, 4)
    derivs_step = make_batched_racing_step(problem, ALILQRConfig(**BUDGET, use_derivs_kernel=True),
                                           transition, tdata, DT, 4)
    (solve_kernel,) = main_step.kernels
    ls_kernel, bw_kernel = phase_step.kernels
    ls_kernel_d, dv_kernel = derivs_step.kernels
    wrappers = (solve_kernel, ls_kernel, bw_kernel, ls_kernel_d, dv_kernel)
    states = torch.as_tensor(initial_states(track.length, B, np.random.default_rng(0)),
                             dtype=f32, device=dev)
    carry = aligned_carry(problem, states)

    # kernel inputs from a real warm-started state: one closed-loop step,
    # then the next solve's inputs and its first backward pass and line search
    carry1, states1, _, _ = main_step(carry, states)
    params, z0 = problem.init_horizon(states1, carry1.X_pred, carry1.U_pred)
    U_init = carry1.U_pred.contiguous()
    U = torch.clamp(U_init, problem.u_lo, problem.u_hi).contiguous()
    X = torch.nan_to_num(rollout(problem.fns, params, z0, U)[0], nan=0.0, posinf=1e6,
                         neginf=-1e6).contiguous()
    lam = carry1.lam.contiguous()
    mu = torch.full((B,), cfg.mu0, dtype=f32, device=dev)
    curv, ds = params.curvature.contiguous(), params.ds.contiguous()
    z0 = z0.contiguous()
    fam = problem.family

    # 3.-4. kernels 1 and 2 against their plain versions on the same inputs,
    # at two regularizations: rho = RHO_WELL (well conditioned: direct
    # tolerances) and the solver's rho0 (ill conditioned: both against f64)
    alphas = ls_kernel.alphas
    ls_rows, bw_rows, ls_abs, bw_abs = {}, {}, 0.0, 0.0
    for label, rho_v in (("well", RHO_WELL), ("rho0", cfg.rho0)):
        rho = torch.full((B,), rho_v, dtype=f32, device=dev)
        bw_args = (X, U, lam, mu, rho, curv, ds)
        ref = backward_plain(fam, *bw_args)
        got = bw_kernel(*bw_args)
        # kernel 1 rolls out the plain backward pass's feedback law
        ls_args = (X, U, ref[0].contiguous(), ref[1].contiguous(), lam, mu, curv, ds, z0)
        costs = ls_kernel(*ls_args)
        costs_ref = linesearch_costs_plain(fam, alphas, *ls_args)
        torch.cuda.synchronize()
        if not torch.equal(torch.isposinf(costs), torch.isposinf(costs_ref)):
            raise RuntimeError(f"kernel 1 ({label}): +inf lanes differ on "
                               f"{(torch.isposinf(costs) != torch.isposinf(costs_ref)).sum().item()}")
        if not torch.equal(got[4], ref[4]):
            raise RuntimeError(f"kernel 2 ({label}): fail flags differ on "
                               f"{(got[4] != ref[4]).sum().item()} lanes")
        fin = torch.isfinite(costs_ref)
        kp = cost_errors(costs[fin], costs_ref[fin])
        row = f"inf:{int((~fin).sum())},max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
        if label == "well":
            ls_abs = (costs[fin] - costs_ref[fin]).abs().max().item()
            if not kp.max() <= LS_RTOL:
                raise RuntimeError(f"kernel 1 (rho={rho_v}): max relative error {kp.max():.3e} > {LS_RTOL}")
        else:
            costs64 = linesearch_costs_plain(fam, alphas, *(a.double() for a in ls_args))
            fin = fin & torch.isfinite(costs64)
            row += ",vs_f64:" + as_accurate(f"kernel 1 (rho={rho_v})",
                                            cost_errors(costs[fin], costs64[fin]),
                                            cost_errors(costs_ref[fin], costs64[fin]), LS_FLOOR)
            ref64 = backward_plain(fam, *(t.double() for t in bw_args))
        ls_rows[label] = row
        for key, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
            if not torch.isfinite(a).all():
                raise RuntimeError(f"kernel 2 ({label}): non-finite {key}")
            kp = lane_errors(a, b)
            row = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
            if label == "well":
                bw_abs = max(bw_abs, (a - b).abs().max().item())
                if not kp.max() <= BW_TOL:
                    raise RuntimeError(f"kernel 2 (rho={rho_v}): {key} error {kp.max():.3e} > {BW_TOL}")
            else:
                c = ref64[("kff", "Kfb", "dV1", "dV2").index(key)]
                row += ",vs_f64:" + as_accurate(f"kernel 2 (rho={rho_v}) {key}",
                                                lane_errors(a, c), lane_errors(b, c), BW_FLOOR)
            bw_rows[f"{key}_{label}"] = row
        bw_rows[f"fail_lanes_{label}"] = int(got[4].sum())
    phase("kernel1_vs_plain", B=B, H=N, A=len(alphas), rho_well=RHO_WELL, rho_solver=cfg.rho0,
          max_abs_err_well=f"{ls_abs:.3e}", **ls_rows)
    phase("kernel2_vs_plain", B=B, H=N, rho_well=RHO_WELL, rho_solver=cfg.rho0,
          max_abs_err_well=f"{bw_abs:.3e}", **bw_rows)

    # 5. kernel 4 against its plain version (no rho: a direct check)
    dv_args = (X, U, lam, mu, curv, ds)
    got, ref = dv_kernel(*dv_args), derivs_plain(fam, *dv_args)
    torch.cuda.synchronize()
    dv_rows, dv_abs = {}, 0.0
    for key, a, b in zip(("g", "Hw", "J"), got, ref):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"kernel 4: {key} has shape {tuple(a.shape)} or non-finite values")
        kp = lane_errors(a, b)
        dv_abs = max(dv_abs, (a - b).abs().max().item())
        dv_rows[key] = f"max:{kp.max().item():.2e},median:{kp.median().item():.2e}"
        if not kp.max() <= DV_TOL:
            raise RuntimeError(f"kernel 4: {key} error {kp.max():.3e} > {DV_TOL} on "
                               f"{int((kp > DV_TOL).sum())} lanes")
    phase("kernel4_vs_plain", B=B, H=N, tol=DV_TOL, max_abs_err=f"{dv_abs:.3e}", **dv_rows)

    # 6. kernel 3 against its plain version on the next solve's inputs
    sv_args = (z0, U_init, lam, curv, ds)
    # (i) well conditioned: one outer x one inner iteration at rho0 = RHO_WELL
    well = ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=BUDGET["n_alpha"],
                        mu0=BUDGET["mu0"], rho0=RHO_WELL)
    got = SolveKernelFM(fam, well)(*sv_args, trace=True)
    ref = solve_plain(fam, well, *sv_args, trace=True)
    torch.cuda.synchronize()
    same = got[7]["first_alpha"] == ref[7]["first_alpha"]
    x_err, u_err = lane_errors(got[0][same], ref[0][same]), lane_errors(got[1][same], ref[1][same])
    fin = same & torch.isfinite(ref[3])
    c_err = cost_errors(got[3][fin], ref[3][fin])
    sv_abs = max((got[0][same] - ref[0][same]).abs().max().item(),
                 (got[1][same] - ref[1][same]).abs().max().item())
    rows = dict(step_same=f"{same.float().mean().item():.4f}",
                accepted=f"{(ref[7]['first_alpha'] > 0).float().mean().item():.4f}",
                X=f"max:{x_err.max().item():.2e},median:{x_err.median().item():.2e}",
                U=f"max:{u_err.max().item():.2e},median:{u_err.median().item():.2e}",
                cost=f"max:{c_err.max().item():.2e},median:{c_err.median().item():.2e}")
    if same.float().mean().item() < STEP_SAME:
        raise RuntimeError(f"kernel 3 (well): the chosen step differs on "
                           f"{int((~same).sum())} lanes")
    if not (x_err.max() <= SOLVE_TOL and u_err.max() <= SOLVE_TOL and c_err.max() <= SOLVE_TOL):
        raise RuntimeError(f"kernel 3 (well): {rows}")
    if not torch.equal(torch.isfinite(got[3]), torch.isfinite(ref[3])):
        raise RuntimeError("kernel 3 (well): finite costs differ")
    phase("kernel3_vs_plain_well", B=B, H=N, rho0=RHO_WELL, tol=SOLVE_TOL,
          max_abs_err=f"{sv_abs:.3e}", **rows)
    # (ii) the main path's budget at the solver's rho0, with the JAX gates;
    # the plain run is also the first sample of its time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = solve_plain(fam, cfg, *sv_args, trace=True)
    end.record()
    got = solve_kernel(*sv_args, trace=True)
    torch.cuda.synchronize()
    solve_plain_first_ms = start.elapsed_time(end)
    conv_k, conv_p = got[5].cpu().numpy(), ref[5].cpu().numpy()
    cost_k, cost_p = got[3].double().cpu().numpy(), ref[3].double().cpu().numpy()
    flip = conv_k != conv_p
    no_worse = (cost_k[flip] <= cost_p[flip] + 1e-3 * (1.0 + np.abs(cost_p[flip]))).mean() \
        if flip.any() else 1.0
    both = conv_k & conv_p
    dcost = np.abs(cost_k[both] - cost_p[both]) / (1.0 + np.abs(cost_p[both]))
    d_it = got[6].cpu().numpy().astype(int) - ref[6].cpu().numpy()
    within2 = (np.abs(d_it) <= 2).mean()
    rows = dict(conv=f"{conv_k.mean():.4f}/{conv_p.mean():.4f}", flips=f"{flip.mean():.4f}",
                flips_no_worse=f"{no_worse:.3f}", cost_median=f"{np.median(dcost):.2e}",
                iters_within2=f"{within2:.4f}", iters_equal=f"{(d_it == 0).mean():.4f}",
                runs_mean=f"{got[7]['inner_runs'].float().mean().item():.2f}",
                runs_max=int(got[7]["inner_runs"].max()))
    phase("kernel3_vs_plain_rho0", B=B, H=N, rho0=cfg.rho0, **rows)
    if not (abs(conv_k.mean() - conv_p.mean()) <= CONV_GAP and flip.mean() < FLIP_MAX
            and no_worse >= 0.5 and both.mean() > 0.5 and np.median(dcost) < COST_MEDIAN
            and within2 >= ITER_WITHIN2):
        raise RuntimeError(f"kernel 3 (rho0): the gates failed: {rows}")
    runs = got[7]["inner_runs"]
    # (iii) early exit and the alpha=1 fast path change no output bit
    base = solve_kernel(*sv_args)
    for early_exit, fast in ((False, False), (True, True), (False, True)):
        other = ALILQRConfig(**BUDGET, early_exit=early_exit, ls_fast_path=fast)
        out = SolveKernelFM(fam, other)(*sv_args)
        if not all(same_bits(a, b) for a, b in zip(out, base)):
            raise RuntimeError(f"kernel 3: early_exit={early_exit} ls_fast_path={fast} "
                               "changed an output bit")
    phase("kernel3_exits_bitwise", configs="early_exit x ls_fast_path", identical=True)

    # 7. the main path: kernel 3 alone, K steps per chunk
    carry, states, times, conv_frac = drive(
        main_step, carry1, states1, wrappers, {solve_kernel: 1}, K, 1 + TIMED_CHUNKS, "main_path")
    step_s = statistics.median(times)
    phase("main_path", B=B, N=N, K=K, chunks=f"1+{TIMED_CHUNKS}",
          step_ms=f"{step_s * 1e3:.1f}", step_ms_chunks="/".join(f"{t * 1e3:.1f}" for t in times),
          solves_per_s=f"{B / step_s:.0f}", converged_frac=f"{conv_frac:.4f}",
          solve_launches=solve_kernel.launches,
          other_launches=sum(w.launches for w in wrappers[1:]))
    if conv_frac < CONV_FLOOR:
        raise RuntimeError(f"converged fraction {conv_frac:.4f} < {CONV_FLOOR}")
    launches = {solve_kernel: solve_kernel.launches}

    # 8. one main-path step under the profiler: the device's busy share
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
    phase("profile", step_ms_profiled=f"{prof_s * 1e3:.1f}", device_busy_ms=f"{busy_ms:.3f}",
          busy_share_of_step=f"{busy_ms / (step_s * 1e3):.4f}",
          device_launches=sum(e.count for e in events),
          top="|".join(f"{e.key[:40]}:{e.device_time_total / 1e3:.3f}ms" for e in top))

    # 9. the two earlier routes, cut in depth
    per_step = cfg.n_outer * cfg.n_inner + cfg.n_polish
    for label, step, expect in (
        ("per_phase_path", phase_step, {ls_kernel: per_step, bw_kernel: per_step}),
        ("derivs_path", derivs_step, {ls_kernel_d: per_step, dv_kernel: per_step}),
    ):
        _, _, times, frac = drive(step, carry1, states1, wrappers, expect, SIDE_K,
                                  1 + SIDE_TIMED_CHUNKS, label)
        t_s = statistics.median(times)
        phase(label, B=B, N=N, K=SIDE_K, chunks=f"1+{SIDE_TIMED_CHUNKS}",
              step_ms=f"{t_s * 1e3:.1f}", solves_per_s=f"{B / t_s:.0f}",
              converged_frac=f"{frac:.4f}",
              launches="/".join(f"{w.launches}" for w in expect))
        if frac < CONV_FLOOR:
            raise RuntimeError(f"{label}: converged fraction {frac:.4f} < {CONV_FLOOR}")
        launches.update({w: w.launches for w in expect})

    # 10. each kernel against its plain version at the main path's shapes, on
    # the inputs of the checks above (kernels 1 and 2 at the solver's rho0)
    ls_ms = cuda_ms(lambda: ls_kernel(*ls_args))
    ls_plain_ms = cuda_ms(lambda: linesearch_costs_plain(fam, alphas, *ls_args), PLAIN_REPS)
    bw_ms = cuda_ms(lambda: bw_kernel(*bw_args))
    bw_plain_ms = cuda_ms(lambda: backward_plain(fam, *bw_args), PLAIN_REPS)
    dv_ms = cuda_ms(lambda: dv_kernel(*dv_args))
    dv_plain_ms = cuda_ms(lambda: derivs_plain(fam, *dv_args), PLAIN_REPS)
    sv_ms = cuda_ms(lambda: solve_kernel(*sv_args))
    sv_plain_ms = statistics.median(
        [solve_plain_first_ms]
        + [cuda_ms(lambda: solve_plain(fam, cfg, *sv_args), 1, warm=False)
           for _ in range(SOLVE_PLAIN_REPS - 1)])
    phase("timing", median_of=REPS, plain_median_of=PLAIN_REPS,
          solve_plain_median_of=SOLVE_PLAIN_REPS,
          linesearch_ms=f"{ls_ms:.3f}", linesearch_plain_ms=f"{ls_plain_ms:.3f}",
          backward_ms=f"{bw_ms:.3f}", backward_plain_ms=f"{bw_plain_ms:.3f}",
          derivs_ms=f"{dv_ms:.3f}", derivs_plain_ms=f"{dv_plain_ms:.3f}",
          solve_ms=f"{sv_ms:.3f}", solve_plain_ms=f"{sv_plain_ms:.3f}")

    # 11. each kernel's bound: its bytes (inputs read once, outputs written
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
        "bw": bound(nbytes(*bw_args) + B * f4 * (N * (NU + NU * NZ) + 3), B * ops_bw),
        "dv": bound(nbytes(*dv_args) + B * N * f4 * NW * (1 + NW + NZ), B * ops_dv),
        "sv": bound(nbytes(*sv_args) + B * f4 * (N * (NZ + NU + NC) + cuda_lib.SOLVE_STATS),
                    ops_sv),
    }
    phase("bounds", ops_per_candidate_lane=f"{ops_cand:.0f}", ops_per_backward_lane=f"{ops_bw:.0f}",
          ops_per_derivs_lane=f"{ops_dv:.0f}", solve_inner_runs=int(runs.sum()),
          **{f"{k}_bound_ms": f"{v[0]:.4f}({v[1]})" for k, v in bounds.items()})

    def row(name, src, replaces, kernels, err, ms, plain_ms, key):
        return dict(name=name, route="cuda", source=f"vehicle_control_tpu_torch/csrc/{src}",
                    replaces=f"vehicle_control_tpu/solvers/{replaces}",
                    launches=sum(launches[k] for k in kernels), max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bounds[key][0], bound_by=bounds[key][1],
                    library_ms=None)

    kernels = [
        row("linesearch_fm", "rollout_fm.cu", "rollout_kernel_fm.py:42", (ls_kernel, ls_kernel_d),
            ls_abs, ls_ms, ls_plain_ms, "ls"),
        row("backward_fm", "backward_fm.cu", "backward_kernel_fm.py:40", (bw_kernel,), bw_abs,
            bw_ms, bw_plain_ms, "bw"),
        row("solve_fm", "solve_fm.cu", "solve_kernel_fm.py:114", (solve_kernel,), sv_abs, sv_ms,
            sv_plain_ms, "sv"),
        row("derivs_fm", "derivs_fm.cu", "derivs_kernel_fm.py:43", (dv_kernel,), dv_abs, dv_ms,
            dv_plain_ms, "dv"),
    ]
    if any(k["launches"] < 1 for k in kernels):
        raise RuntimeError(f"a kernel was never launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
