"""The port's point-mass cascade (tail="pm") through its solver routes and
its closed loop, against the JAX package, on the CPU in float64.

The cascade is cut to N=4 single-track and M=4 point-mass stages.  The
inputs are rolled-out random controls with random multipliers at bench-like
drops (``torch_parity.solver_inputs``, numpy seed 0), or the bench's
aligned carries of ``initial_states`` (seed 0).  The tolerances are those
of the single-track slice (test_torch_solve.py, test_torch_slice.py):

* three chained closed-loop steps of ``make_batched_racing_step`` on the
  whole-solve route (``solve_plain``, kernel 3's plain version) and the
  per-phase route against JAX's batched racing step (its XLA solver):
  equal flags and counts, rtol 1e-6 (the multipliers' floor 1e-4 x scale:
  lam + mu*c multiplies the constraints' rounding by mu); the derivatives
  route equals the per-phase route bit for bit;
* ``solve_plain``'s early exit and alpha=1 fast path change no bit;
* kernel 5's wrapper (array of structs) on CPU tensors gives kernel 1's
  plain version's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    config_path,
    problems,
    solver_inputs,
    t,
    tracks,
)
from vehicle_control_tpu.models import dynamic_car as jdc
from vehicle_control_tpu.parallel import aligned_carry as j_aligned_carry
from vehicle_control_tpu.parallel import make_batched_racing_step as j_make_step
from vehicle_control_tpu.solvers import ALILQRConfig as JConfig
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.parallel.batch import (
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
from vehicle_control_tpu_torch.solvers.rollout_kernel import LinesearchKernelAoS
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import linesearch_costs_plain
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
from vehicle_control_tpu_torch.utils.config import load_config

N, M, B = 4, 4, 8
H = N + M
ALPHAS = [1.0, 0.25, 0.01]
BUDGET = dict(n_outer=2, n_inner=3, n_alpha=6, mu0=300.0)
LOOP_B, STEPS, DT = 4, 3, 0.05
LOOP_BUDGET = dict(n_outer=2, n_inner=3, n_alpha=6, mu0=300.0)


def _close(a, b, what, rtol=1e-9, atol=1e-9):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


@pytest.fixture(scope="module")
def setup():
    jprob, tprob = problems(N, horizon_pm=M)
    X, U, lam, mu, rho, params, z0 = solver_inputs(jprob, B)
    rng = np.random.default_rng(1)
    kff = rng.normal(size=(B, H, 2)) * 0.02
    Kfb = rng.normal(size=(B, H, 2, 10)) * 0.01
    return jprob, tprob, (X, U, lam, mu, rho, params, z0, kff, Kfb)


def test_aos_wrapper_runs_kernel1_plain_on_cpu(setup):
    """Kernel 5's wrapper on CPU tensors: kernel 1's plain version, the same
    bits, no launch counted; another device raises."""
    _, tprob, (X, U, lam, mu, _, params, z0, kff, Kfb) = setup
    args = tuple(t(a) for a in (X, U, kff, Kfb, lam, mu, params.curvature, params.ds, z0))
    aos = LinesearchKernelAoS(tprob.family, ALPHAS)
    got = aos(*args)
    assert torch.equal(got, linesearch_costs_plain(tprob.family, ALPHAS, *args))
    assert got.shape == (len(ALPHAS), B) and aos.launches == 0
    with pytest.raises(ValueError):
        aos(args[0].to("meta"), *args[1:])


def test_solve_plain_exits_change_no_bit(setup):
    """solve_plain on the cascade: its early exit and alpha=1 fast path
    change no output bit (its results against JAX's XLA solver are held by
    the whole-solve closed loop below)."""
    _, tprob, (_, U, lam, _, _, params, z0, _, _) = setup
    ins = (t(z0), t(U), t(lam), t(params.curvature), t(params.ds))
    outs = [solve_plain(tprob.family, ALILQRConfig(**BUDGET, early_exit=ee, ls_fast_path=fast),
                        *ins, trace=True)
            for ee, fast in ((True, False), (False, True))]
    for a, b in zip(outs[0][:7], outs[1][:7]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][7]["first_alpha"], outs[1][7]["first_alpha"])
    assert (outs[1][7]["inner_runs"] == BUDGET["n_outer"] * BUDGET["n_inner"]).all()


@pytest.fixture(scope="module")
def jax_loop():
    """JAX's batched racing step on the cascade, 3 chained steps from the
    aligned carries of initial_states (seed 0), as numpy."""
    jprob, _ = problems(N, horizon_pm=M)
    jt, _ = tracks()
    states = initial_states(jt.length, LOOP_B, np.random.default_rng(0))
    jT, _ = jdc.make_transitions(
        jdc.DynamicCarParams.from_config(j_load_config(config_path("models/dynamic_car.yaml")))
    )
    jstep = jax.jit(j_make_step(jprob, JConfig(**LOOP_BUDGET, unroll=1), jT, jt.data, DT, 4))
    js = jnp.asarray(states)
    jc = j_aligned_carry(jprob, js, jnp.float64)
    steps = []
    for _ in range(STEPS):
        jc, js, ja, jinfo = jstep(jc, js)
        steps.append(jax.tree.map(np.asarray, (jc, js, ja, jinfo)))
    return states, steps


@pytest.mark.parametrize("route", ["whole_solve", "per_phase"])
def test_closed_loop_matches_jax(jax_loop, route):
    """Three closed-loop steps on the whole-solve route (kernel 3's plain
    version) and on the per-phase route (kernels 1 + 2); the shifted carry
    moves a point-mass row into single-track slot N-1, as JAX's does."""
    _, tprob = problems(N, horizon_pm=M)
    _, tt = tracks()
    tT, _ = tdc.make_transitions(
        tdc.DynamicCarParams.from_config(load_config(config_path("models/dynamic_car.yaml")))
    )
    flags = dict(use_solve_kernel=True) if route == "whole_solve" else {}
    step = make_batched_racing_step(tprob, ALILQRConfig(**LOOP_BUDGET, **flags), tT, tt.data,
                                    DT, 4)
    states, jsteps = jax_loop
    ts = t(states)
    tc = aligned_carry(tprob, ts, torch.float64)
    for k, (jc, js, ja, jinfo) in enumerate(jsteps):
        tc, ts, ta, tinfo = step(tc, ts)
        np.testing.assert_array_equal(tinfo.converged.numpy(), jinfo.converged)
        np.testing.assert_array_equal(tinfo.iterations.numpy(), jinfo.iterations)
        for name, a, b in (("action", ta, ja), ("next state", ts, js), ("cost", tinfo.cost,
                           jinfo.cost), ("violation", tinfo.violation, jinfo.violation),
                           ("carry X_pred", tc.X_pred, jc.X_pred),
                           ("carry U_pred", tc.U_pred, jc.U_pred)):
            _close(a, b, f"step {k} {name}", 1e-6, 1e-6)
        _close(tc.lam, jc.lam, f"step {k} carry lam", 1e-6, 1e-4)
    assert [k.launches for k in step.kernels] == [0] * len(step.kernels)


def test_derivs_route_equals_per_phase_route():
    """The derivatives route (kernel 4, then the torch Riccati sweep) runs
    the cascade's closed loop to the per-phase route's bits."""
    _, tprob = problems(N, horizon_pm=M)
    _, tt = tracks()
    tT, _ = tdc.make_transitions(
        tdc.DynamicCarParams.from_config(load_config(config_path("models/dynamic_car.yaml")))
    )
    states = t(initial_states(tt.length, LOOP_B, np.random.default_rng(0)))
    outs = []
    for flags in ({}, dict(use_derivs_kernel=True)):
        step = make_batched_racing_step(
            tprob, ALILQRConfig(n_outer=1, n_inner=2, n_alpha=6, mu0=300.0, **flags), tT,
            tt.data, DT, 4)
        outs.append(step(aligned_carry(tprob, states, torch.float64), states))
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        assert torch.equal(a, b)
