"""The whole-solve and stage-derivatives kernels' plain versions against the
JAX package, and the solver routes through them, on the CPU in float64.

* ``solve_plain`` (kernel 3's plain version) against JAX's XLA
  ``build_solver`` (``jit(vmap)``) at H=8, B=8, budget 2 outer x 3 inner + 1
  polish iteration, 6 line-search steps, mu0=300, on rolled-out random
  controls and multipliers (``solver_inputs``, numpy seed 0).  The two
  differ only where the TPU kernel does (a candidate whose *last* state
  diverges, the alpha**2 and rho-growth roundings), which these inputs do
  not reach, so in float64 every Armijo choice is the same: flags and
  counts are equal and the rest agrees to rtol 1e-6, with the multipliers'
  floor of 1e-4 x scale (lam + mu*c multiplies the constraints' rounding by
  mu), as in test_torch_slice.py.  Its early exit and alpha=1 fast path
  change no bit.
* ``derivs_plain`` (kernel 4's plain version) against JAX autodiff of the
  problem's callbacks: the same derivatives, to 1e-9 relative.
* ``build_solver``'s derivatives route (kernel 4, then the torch Riccati
  sweep) against its per-phase route (kernel 2): the same operations, so
  the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    config_path,
    derivs_oracle,
    problems,
    singletrack_cfg,
    solver_inputs,
    t,
    tracks,
)
from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.solvers import ALILQRConfig as JConfig
from vehicle_control_tpu.solvers.al_ilqr import build_solver as j_build_solver
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, build_solver
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import BackwardKernelFM
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import DerivsKernelFM, derivs_plain
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import LinesearchKernelFM
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM, solve_plain
from vehicle_control_tpu_torch.utils import convert
from vehicle_control_tpu_torch.utils.config import load_config

H, B = 8, 8
BUDGET = dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6, mu0=300.0)


def _close(a, b, what, rtol=1e-6, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


@pytest.fixture(scope="module")
def setup():
    jprob, tprob = problems(H)
    X, U, lam, mu, _, params, z0 = solver_inputs(jprob, B)
    torch_in = tuple(t(a) for a in (z0, U, lam, params.curvature, params.ds))
    return jprob, tprob, (X, U, lam, mu, params, z0), torch_in


@pytest.fixture(scope="module")
def plain(setup):
    """solve_plain at the budget, with its trace."""
    _, tprob, _, torch_in = setup
    return solve_plain(tprob.family, ALILQRConfig(**BUDGET), *torch_in, trace=True)


def test_solve_plain_matches_jax(setup, plain):
    jprob, _, (_, U, lam, _, params, z0), _ = setup
    jsolve = j_build_solver(jprob.fns, H, JConfig(**BUDGET, unroll=1), jprob.u_lo, jprob.u_hi)
    pv = jproblems.HorizonParams(jnp.asarray(params.curvature), jnp.asarray(params.ds))
    ref = jax.jit(jax.vmap(jsolve))(pv, jnp.asarray(z0), jnp.asarray(U), jnp.asarray(lam))
    np.testing.assert_array_equal(plain[5].numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(plain[6].numpy(), np.asarray(ref.iterations))
    assert np.asarray(ref.iterations).min() > 0  # every lane took steps
    for name, a, b in zip(("X", "U", "cost", "violation"), (plain[0], plain[1], plain[3],
                                                            plain[4]),
                          (ref.X, ref.U, ref.cost, ref.violation)):
        _close(a.numpy(), b, name)
    _close(plain[2].numpy(), ref.lam, "lam", atol=1e-4)


def test_solve_plain_exits_change_no_bit(setup, plain):
    """Warm-started from the first solve, lanes are done after a step or
    two: the early exit skips the rest, and no output bit moves."""
    _, tprob, _, (z0, _, _, curv, ds) = setup
    warm = (z0, plain[1], plain[2], curv, ds)
    outs = [
        solve_plain(tprob.family, ALILQRConfig(**BUDGET, early_exit=ee, ls_fast_path=fast),
                    *warm, trace=True)
        for ee, fast in ((True, False), (False, False), (True, True))
    ]
    for out in outs[1:]:
        for a, b in zip(out[:7], outs[0][:7]):
            assert torch.equal(a, b)
        assert torch.equal(out[7]["first_alpha"], outs[0][7]["first_alpha"])
    per_solve = BUDGET["n_outer"] * BUDGET["n_inner"] + BUDGET["n_polish"]
    assert outs[0][7]["inner_runs"].min() < per_solve
    assert (outs[1][7]["inner_runs"] == per_solve).all()


def test_derivs_plain_matches_jax_autodiff(setup):
    jprob, tprob, (X, U, lam, mu, params, _), _ = setup
    ref = derivs_oracle(jprob, X, U, lam, mu, params)
    got = derivs_plain(tprob.family, t(X), t(U), t(lam), t(mu), t(params.curvature),
                       t(params.ds))
    for name, a, b in zip(("g", "Hw", "J"), got, ref):
        assert a.shape == b.shape, name
        _close(a.numpy(), b, name, rtol=1e-9, atol=1e-9)


def test_derivs_route_equals_per_phase_route(setup):
    _, tprob, _, (z0, U, lam, curv, ds) = setup
    cfg = ALILQRConfig(n_outer=1, n_inner=2, n_alpha=6, mu0=300.0)
    fam = tprob.family
    params = tproblems.HorizonParams(curv, ds)
    sols = []
    for kernels in (dict(backward_kernel=BackwardKernelFM(fam)),
                    dict(derivs_kernel=DerivsKernelFM(fam))):
        solve = build_solver(tprob.fns, H, cfg, tprob.u_lo, tprob.u_hi,
                             ls_kernel=LinesearchKernelFM(fam, cfg.alphas()), **kernels)
        sols.append(solve(params, z0, U, lam))
    for a, b in zip(*sols):
        assert torch.equal(a, b)


def test_wrappers_run_plain_on_cpu(setup, plain):
    """On CPU tensors the wrappers run the plain versions and count no launch;
    the whole-solve route of build_solver is one wrapper call."""
    jprob, tprob, (X, U, lam, mu, params, _), torch_in = setup
    fam, cfg = tprob.family, ALILQRConfig(**BUDGET)
    sk, dk = SolveKernelFM(fam, cfg), DerivsKernelFM(fam)
    solve = build_solver(tprob.fns, H, cfg, tprob.u_lo, tprob.u_hi, solve_kernel=sk)
    curv, ds = t(params.curvature), t(params.ds)
    sol = solve(tproblems.HorizonParams(curv, ds), *torch_in[:3])
    for a, b in zip(sol, plain[:7]):
        assert torch.equal(a, b)
    for a, b in zip(dk(t(X), t(U), t(lam), t(mu), curv, ds),
                    derivs_plain(fam, t(X), t(U), t(lam), t(mu), curv, ds)):
        assert torch.equal(a, b)
    assert sk.launches == 0 and dk.launches == 0
    with pytest.raises(ValueError):
        sk(*(a.to("meta") for a in torch_in))


def test_default_device_is_the_card(monkeypatch):
    """Without a device the problem and the converters go to the card; on a
    machine without CUDA that raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tt = tracks()
    cfg, car = singletrack_cfg(H), load_config(config_path("models/dynamic_car.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproblems.build_cascaded_problem(car, tt, cfg, "none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.plant_states(np.zeros((2, 8)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.mpc_carry(np.zeros((2, H, 10)), np.zeros((2, H, 2)), np.zeros((2, H, 10)))
    assert tproblems.build_cascaded_problem(car, tt, cfg, "none", device="cpu").u_lo.is_cpu
