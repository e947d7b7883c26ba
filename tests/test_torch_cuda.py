"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import nothing of JAX, so they run where the card is, e.g.

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up).  Without a card they
skip.  The inputs come from the port alone: bench-like drops (``initial_states``,
seed 0) with their aligned warm starts, rolled out under perturbed controls,
with random multipliers and gains.  They are made in float64 on the CPU and
handed to both versions as float32 on the card.

The single-track family runs at H=8, the point-mass cascade (tail="pm") at
N=4 + M=4.  Tolerances: with rho = 1 the Riccati step is well conditioned,
and at H=8 the plain version in float32 stays within ~1e-7 of float64
(costs: ~1e-6 relative; ~2e-6 on the cascade), so kernel and plain
version, which round differently, agree to 1e-4.  (At small rho the float32 gains themselves are noisy; chip_smoke.py
checks that regime against float64.)  The whole solve (kernel 3) is held to
the same tolerance in that regime: one outer and one inner iteration at
rho0 = 1, where both versions must also pick the same step on every lane.
Lanes 0 and 1 start beyond the state guard and from a NaN: there only the
flags and counts are compared.  Its early exit and alpha=1 fast path must
change no output bit.  Kernel 5 (the array-of-structs line search) gives
kernel 1's costs on the same numbers, to the same tolerance.
"""

import numpy as np
import pytest
import torch

from vehicle_control_tpu_torch.controllers.mpc import problems
from vehicle_control_tpu_torch.environment.track import Track
from vehicle_control_tpu_torch.models import dynamic_car as dc
from vehicle_control_tpu_torch.parallel.batch import (
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, rollout
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import BackwardKernelFM, backward_plain
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import DerivsKernelFM, derivs_plain
from vehicle_control_tpu_torch.solvers.rollout_kernel import LinesearchKernelAoS
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import (
    LinesearchKernelFM,
    linesearch_costs_plain,
)
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM, solve_plain
from vehicle_control_tpu_torch.utils.config import load_config, project_root

H, B = 8, 64
ALPHAS = [1.0, 0.25, 0.01]
BUDGET = dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6, mu0=300.0)
WELL = ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=6, mu0=300.0, rho0=1.0)


def _lane_err(a, b):
    """Per lane: max |a - b| / (1 + max |b| of the lane)."""
    scale = 1.0 + b.abs().reshape(b.shape[0], -1).amax(-1)
    return (a - b).abs().reshape(b.shape[0], -1).amax(-1) / scale


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _config(rel):
    return load_config(f"{project_root()}/configs/{rel}")


def _problem(device="cpu", dtype=torch.float64, tail="none"):
    if tail == "pm":  # the cascade at N=4 + M=4 stages
        cfg = dict(_config("controllers/cascaded.yaml"), obstacles=False, horizon=H // 2,
                   horizon_pm=H // 2)
    else:
        cfg = dict(_config("controllers/singletrack.yaml"), obstacles=False, horizon=H)
    track = Track(_config("environment/ippodromo.yaml"))
    return track, problems.build_cascaded_problem(
        _config("models/dynamic_car.yaml"), track, cfg, tail, dtype, device
    )


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, tail):
    """(family, X, U, lam, mu, rho, curv, ds, z0, kff, Kfb) as f32 on the card."""
    track, prob = _problem(tail=tail)
    rng = np.random.default_rng(0)
    states = torch.as_tensor(initial_states(track.length, B, rng))
    carry = aligned_carry(prob, states)
    params, z0 = prob.init_horizon(states, carry.X_pred, carry.U_pred)
    U = carry.U_pred + torch.as_tensor(rng.normal(size=(B, H, 2)) * 0.05)
    X, _ = rollout(prob.fns, params, z0, U)
    lam = torch.as_tensor(np.abs(rng.normal(size=(B, H, 10))) * 0.1)
    kff = torch.as_tensor(rng.normal(size=(B, H, 2)) * 0.02)
    Kfb = torch.as_tensor(rng.normal(size=(B, H, 2, 10)) * 0.01)
    z0 = z0.clone()
    z0[0, 1] = 1e8  # beyond the 1e7 state guard: +inf
    z0[1, 2] = float("nan")  # a NaN start: +inf
    mu, rho = torch.full((B,), 10.0), torch.ones(B)
    arrays = (X, U, lam, mu, rho, params.curvature, params.ds, z0, kff, Kfb)
    return (prob.family,) + tuple(a.to(cuda, torch.float32).contiguous() for a in arrays)


@pytest.fixture(scope="module")
def inputs(cuda):
    return _inputs(cuda, "none")


@pytest.fixture(scope="module")
def pm_inputs(cuda):
    return _inputs(cuda, "pm")


@pytest.mark.cuda
def test_linesearch_kernel_matches_plain(inputs):
    fam, X, U, lam, mu, _, curv, ds, z0, kff, Kfb = inputs
    ls = LinesearchKernelFM(fam, ALPHAS)
    args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
    got = ls(*args)
    ref = linesearch_costs_plain(fam, ALPHAS, *args)
    assert ls.launches == 1 and got.shape == (len(ALPHAS), B)
    assert torch.isposinf(got[:, :2]).all()
    torch.testing.assert_close(torch.isposinf(got), torch.isposinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_backward_kernel_matches_plain(inputs):
    fam, X, U, lam, mu, rho, curv, ds = inputs[:8]
    bw = BackwardKernelFM(fam)
    got = bw(X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    assert bw.launches == 1
    torch.testing.assert_close(got[4], ref[4])
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        assert a.shape == b.shape, name
        scale = 1.0 + b.abs().reshape(B, -1).amax(-1).reshape((B,) + (1,) * (b.dim() - 1))
        assert ((a - b).abs() / scale).max().item() < 1e-4, name


@pytest.mark.cuda
def test_team_kernels_launch_shape(cuda):
    """Kernels 2 and 3 run a team of at least 4 threads per scenario, every
    team's lanes in one warp, with several warps resident per SM."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    lib = cuda_lib.load_library()
    for fn in (lib.vct_backward_fm_info, lib.vct_solve_fm_info):
        info = cuda_lib.launch_info(fn, 4096)
        assert info["team"] >= 4 and 32 % info["team"] == 0, info
        assert info["threads"] == 4096 * info["team"], info
        assert info["warps_per_sm"] >= 4, info


@pytest.mark.cuda
def test_linesearch_and_derivs_launch_shape(cuda):
    """Kernel 1: a block of 32 scenarios, a rollout and a cost warp per step
    size (up to 8 of each), three chunks of stage records and the ring in
    shared memory.  Kernel 4: a thread per (stage, scenario), blocks of 4
    warps."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    lib = cuda_lib.load_library()
    for A, warps, chunk in ((6, 6, 4), (10, 8, 4), (16, 8, 2)):
        info = cuda_lib.launch_info(lib.vct_linesearch_fm_info, 4096, A)
        assert info["scenarios_per_block"] == 32, info
        assert info["block"] == 64 * warps and info["threads"] == 128 * 64 * warps, info
        # records: 3 chunks x 32 scenarios x 53 floats; ring: 2 chunks x A x 32 x 13
        assert info["smem_bytes_per_block"] == chunk * 32 * 4 * (3 * 53 + 2 * A * 13), info
        assert info["blocks_per_sm"] >= 1, info
    info = cuda_lib.launch_info(lib.vct_derivs_fm_info, 4096, 30)
    assert info["threads_per_stage"] == 1 and info["block"] == 128, info
    assert info["threads"] == 4096 * 30 and info["smem_bytes_per_block"] == 0, info
    assert info["warps_per_sm"] >= 4, info


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["none", "pm"])
def test_linesearch_and_derivs_ragged_batch(inputs, pm_inputs, family):
    """Kernels 1 and 4 at B = 40 (a block of 32 scenarios and a ragged one),
    kernel 1 with 12 step sizes (some warps take two, chunks of 2 stages),
    against their plain versions."""
    fam, X, U, lam, mu, _, curv, ds, z0, kff, Kfb = inputs if family == "none" else pm_inputs
    n = 40
    X, U, lam, mu, curv, ds, z0, kff, Kfb = (t[:n].contiguous()
                                             for t in (X, U, lam, mu, curv, ds, z0, kff, Kfb))
    alphas = ALILQRConfig(n_alpha=12).alphas()
    args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
    got, ref = LinesearchKernelFM(fam, alphas)(*args), linesearch_costs_plain(fam, alphas, *args)
    assert got.shape == (12, n) and torch.isposinf(got[:, :2]).all()
    torch.testing.assert_close(torch.isposinf(got), torch.isposinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-4, atol=1e-4)
    for name, a, b in zip(("g", "Hw", "J"), DerivsKernelFM(fam)(X, U, lam, mu, curv, ds),
                          derivs_plain(fam, X, U, lam, mu, curv, ds)):
        assert a.shape == b.shape, name
        assert _lane_err(a, b).max().item() < 1e-4, name


@pytest.mark.cuda
def test_derivs_kernel_matches_plain(inputs):
    fam, X, U, lam, mu, _, curv, ds = inputs[:8]
    dk = DerivsKernelFM(fam)
    got = dk(X, U, lam, mu, curv, ds)
    ref = derivs_plain(fam, X, U, lam, mu, curv, ds)
    assert dk.launches == 1
    for name, a, b in zip(("g", "Hw", "J"), got, ref):
        assert a.shape == b.shape, name
        assert _lane_err(a, b).max().item() < 1e-4, name


@pytest.mark.cuda
def test_solve_kernel_matches_plain(inputs):
    fam, _, U, lam, _, _, curv, ds, z0 = inputs[:9]
    sk = SolveKernelFM(fam, WELL)
    got = sk(z0, U, lam, curv, ds, trace=True)
    ref = solve_plain(fam, WELL, z0, U, lam, curv, ds, trace=True)
    assert sk.launches == 1
    torch.testing.assert_close(got[5], ref[5])  # converged
    torch.testing.assert_close(got[6], ref[6])  # iterations
    torch.testing.assert_close(got[7]["first_alpha"], ref[7]["first_alpha"], rtol=0, atol=0)
    for name, a, b in zip(("X", "U", "lam"), got[:3], ref[:3]):
        assert _lane_err(a[2:], b[2:]).max().item() < 1e-4, name
    cost, cost_ref = got[3][2:], ref[3][2:]
    assert ((cost - cost_ref).abs() / cost_ref.abs().clamp_min(1.0)).max().item() < 1e-4


@pytest.mark.cuda
def test_solve_kernel_exits_change_no_bit(inputs):
    fam, _, U, lam, _, _, curv, ds, z0 = inputs[:9]
    outs = []
    for early_exit, fast in ((True, False), (False, False), (True, True), (False, True)):
        cfg = ALILQRConfig(**BUDGET, early_exit=early_exit, ls_fast_path=fast)
        outs.append(SolveKernelFM(fam, cfg)(z0, U, lam, curv, ds))
    for out in outs[1:]:
        assert all(_same_bits(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.cuda
def test_closed_loop_step_launches_both_kernels(cuda):
    """One f32 closed-loop step on the card goes through the kernels its
    config picks: kernels 1 + 2 by default, kernels 1 + 4 on the
    derivatives route, kernel 3 alone on the whole-solve route."""
    track, prob = _problem(cuda, torch.float32)
    transition, _ = dc.make_transitions(
        dc.DynamicCarParams.from_config(_config("models/dynamic_car.yaml"))
    )
    per_solve = BUDGET["n_outer"] * BUDGET["n_inner"] + BUDGET["n_polish"]
    states = torch.as_tensor(initial_states(track.length, 256, np.random.default_rng(0)),
                             dtype=torch.float32, device=cuda)
    routes = (({}, [per_solve, per_solve]), (dict(use_derivs_kernel=True), [per_solve, per_solve]),
              (dict(use_solve_kernel=True), [1]))
    for flags, launches in routes:
        step = make_batched_racing_step(
            prob, ALILQRConfig(**BUDGET, **flags), transition,
            track.data.to(cuda, torch.float32), 0.05, 4,
        )
        carry, nxt, action, info = step(aligned_carry(prob, states), states)
        assert [k.launches for k in step.kernels] == launches, flags
        assert torch.isfinite(nxt).all() and torch.isfinite(action).all()
        assert carry.X_pred.shape == (256, H, 10) and info.converged.shape == (256,)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["none", "pm"])
def test_aos_kernel_matches_kernel1(inputs, pm_inputs, family):
    """Kernel 5 reads the (B, H, F) tensors in place and gives kernel 1's costs."""
    fam, X, U, lam, mu, _, curv, ds, z0, kff, Kfb = inputs if family == "none" else pm_inputs
    args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
    aos, ls = LinesearchKernelAoS(fam, ALPHAS), LinesearchKernelFM(fam, ALPHAS)
    got, ref = aos(*args), ls(*args)
    assert aos.launches == 1 and got.shape == (len(ALPHAS), B)
    torch.testing.assert_close(torch.isposinf(got), torch.isposinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cascade_kernels_match_plain(pm_inputs):
    """Kernels 1, 2 and 4 on the cascade against their plain versions."""
    fam, X, U, lam, mu, rho, curv, ds, z0, kff, Kfb = pm_inputs
    ls = LinesearchKernelFM(fam, ALPHAS)
    args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
    got, ref = ls(*args), linesearch_costs_plain(fam, ALPHAS, *args)
    torch.testing.assert_close(torch.isposinf(got), torch.isposinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-4, atol=1e-4)
    bw = BackwardKernelFM(fam)
    got = bw(X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    torch.testing.assert_close(got[4], ref[4])
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        assert _lane_err(a, b).max().item() < 1e-4, name
    dk = DerivsKernelFM(fam)
    for name, a, b in zip(("g", "Hw", "J"), dk(X, U, lam, mu, curv, ds),
                          derivs_plain(fam, X, U, lam, mu, curv, ds)):
        assert _lane_err(a, b).max().item() < 1e-4, name
    assert (ls.launches, bw.launches, dk.launches) == (1, 1, 1)


@pytest.mark.cuda
def test_cascade_solve_kernel_matches_plain(pm_inputs):
    """Kernel 3 on the cascade: one iteration at rho0 = 1 against the plain
    version, and the early exit and alpha=1 fast path change no bit."""
    fam, _, U, lam, _, _, curv, ds, z0 = pm_inputs[:9]
    got = SolveKernelFM(fam, WELL)(z0, U, lam, curv, ds, trace=True)
    ref = solve_plain(fam, WELL, z0, U, lam, curv, ds, trace=True)
    torch.testing.assert_close(got[5], ref[5])
    torch.testing.assert_close(got[6], ref[6])
    torch.testing.assert_close(got[7]["first_alpha"], ref[7]["first_alpha"], rtol=0, atol=0)
    for name, a, b in zip(("X", "U", "lam"), got[:3], ref[:3]):
        assert _lane_err(a[2:], b[2:]).max().item() < 1e-4, name
    outs = [SolveKernelFM(fam, ALILQRConfig(**BUDGET, early_exit=ee, ls_fast_path=fast))(
        z0, U, lam, curv, ds) for ee, fast in ((True, False), (False, True))]
    assert all(_same_bits(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_cascade_closed_loop_routes(cuda):
    """One f32 closed-loop step of the cascade on the card on each route."""
    track, prob = _problem(cuda, torch.float32, "pm")
    transition, _ = dc.make_transitions(
        dc.DynamicCarParams.from_config(_config("models/dynamic_car.yaml"))
    )
    per_solve = BUDGET["n_outer"] * BUDGET["n_inner"] + BUDGET["n_polish"]
    states = torch.as_tensor(initial_states(track.length, 256, np.random.default_rng(0)),
                             dtype=torch.float32, device=cuda)
    routes = (({}, [per_solve, per_solve]), (dict(use_derivs_kernel=True), [per_solve, per_solve]),
              (dict(use_solve_kernel=True), [1]))
    for flags, launches in routes:
        step = make_batched_racing_step(
            prob, ALILQRConfig(**BUDGET, **flags), transition,
            track.data.to(cuda, torch.float32), 0.05, 4,
        )
        carry, nxt, action, info = step(aligned_carry(prob, states), states)
        assert [k.launches for k in step.kernels] == launches, flags
        assert torch.isfinite(nxt).all() and torch.isfinite(action).all()
        assert carry.X_pred.shape == (256, H, 10) and info.converged.shape == (256,)
