"""The port's batched single-track closed loop against the JAX package's.

``make_batched_racing_step`` at N=8, B=4 takes 3 chained closed-loop steps
on both sides from the bench's aligned carries of ``initial_states`` (seed
0), in float64, with the bench's line search (6 steps) and penalty
(mu0=300), once through the port's default route (kernels 1 + 2) and once
through its whole-solve route (kernel 3), against one compiled JAX run.
The budget is cut to 2 outer x 3 inner iterations and no polish
phase (the port's polish runs the same ``inner_loop`` at a boosted mu):
each inner-step copy costs JAX ~30 s of compilation on a CPU, and one
polish iteration took this test from ~55 s to ~88 s.  JAX runs
its XLA path; the port runs its kernels' plain versions, as it does for CPU
tensors.  In float64 every Armijo selection must come out the same, so the
tolerance (rtol 1e-6) only absorbs rounding: a mismatch is a bug, not
noise.  The multipliers are the exception by construction: lam + mu*c
multiplies the constraints' rounding by mu (3000 in the second outer loop),
so they get an absolute floor of 1e-4 x their scale.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import config_path, problems, t, tracks
from vehicle_control_tpu.controllers.mpc.controllers import _solver_config as j_solver_config
from vehicle_control_tpu.models import dynamic_car as jdc
from vehicle_control_tpu.parallel import aligned_carry as j_aligned_carry
from vehicle_control_tpu.parallel import make_batched_racing_step as j_make_step
from vehicle_control_tpu.solvers import ALILQRConfig as JConfig
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc.controllers import _solver_config
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.parallel.batch import (
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
from vehicle_control_tpu_torch.utils.config import load_config, project_root

N, B, STEPS, DT = 8, 4, 3, 0.05
BUDGET = dict(n_outer=2, n_inner=3, n_alpha=6, mu0=300.0)


def _close(a, b, what, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step's 3 chained closed-loop steps (compiled once per module):
    the drop's states, JAX's aligned carry and, per step, (carry, next
    states, action, info) as numpy."""
    jprob, _ = problems(N)
    jt, _ = tracks()
    states = initial_states(jt.length, B, np.random.default_rng(0))
    jT, _ = jdc.make_transitions(
        jdc.DynamicCarParams.from_config(j_load_config(config_path("models/dynamic_car.yaml")))
    )
    jstep = jax.jit(j_make_step(jprob, JConfig(**BUDGET, unroll=1), jT, jt.data, DT, 4))
    js = jnp.asarray(states)
    jc = j_aligned_carry(jprob, js, jnp.float64)
    aligned = jax.tree.map(np.asarray, jc)
    steps = []
    for _ in range(STEPS):
        jc, js, ja, jinfo = jstep(jc, js)
        steps.append(jax.tree.map(np.asarray, (jc, js, ja, jinfo)))
    return states, aligned, steps


def _torch_step(**flags):
    _, tprob = problems(N)
    _, tt = tracks()
    tT, _ = tdc.make_transitions(
        tdc.DynamicCarParams.from_config(load_config(config_path("models/dynamic_car.yaml")))
    )
    return tprob, make_batched_racing_step(
        tprob, ALILQRConfig(**BUDGET, **flags), tT, tt.data, DT, 4
    )


def _follow(tprob, tstep, jax_run):
    """Chain the port's steps from the same drop; compare each with JAX's."""
    states, jc, jsteps = jax_run
    ts = t(states)
    tc = aligned_carry(tprob, ts, torch.float64)
    _close(tc.X_pred, jc.X_pred, "aligned X_pred")
    _close(tc.U_pred, jc.U_pred, "aligned U_pred")
    for k, (jc, js, ja, jinfo) in enumerate(jsteps):
        tc, ts, ta, tinfo = tstep(tc, ts)
        np.testing.assert_array_equal(tinfo.converged.numpy(), jinfo.converged)
        np.testing.assert_array_equal(tinfo.iterations.numpy(), jinfo.iterations)
        _close(ta, ja, f"step {k} action")
        _close(ts, js, f"step {k} next state")
        _close(tinfo.cost, jinfo.cost, f"step {k} cost")
        _close(tinfo.violation, jinfo.violation, f"step {k} violation")
        _close(tc.X_pred, jc.X_pred, f"step {k} carry X_pred")
        _close(tc.U_pred, jc.U_pred, f"step {k} carry U_pred")
        _close(tc.lam, jc.lam, f"step {k} carry lam", atol=1e-4)
    assert np.isfinite(ts.numpy()).all()


def test_closed_loop_matches_jax(jax_run):
    tprob, tstep = _torch_step()
    _follow(tprob, tstep, jax_run)
    assert tstep.kernels[0].launches == 0 and tstep.kernels[1].launches == 0


def test_whole_solve_closed_loop_matches_jax(jax_run):
    """The whole-solve route (kernel 3's plain version on CPU tensors) gives
    JAX's XLA solver's closed loop too: its semantics differ only where no
    lane of this drop goes."""
    tprob, tstep = _torch_step(use_solve_kernel=True)
    _follow(tprob, tstep, jax_run)
    assert [k.launches for k in tstep.kernels] == [0]


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(project_root(), "configs", "controllers", "*.yaml"))),
    ids=os.path.basename,
)
def test_solver_config_matches_jax(path):
    """Every solver field the port keeps reads the same from each controller
    YAML, and the port's defaults are the JAX package's."""
    port, ref = _solver_config(load_config(path)), j_solver_config(j_load_config(path))
    for f in dataclasses.fields(ALILQRConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert f.default == getattr(JConfig(), f.name), f.name


def test_solver_config_reads_every_field():
    """Non-default values, tolerances included, read the same on both sides."""
    cfg = {"solver": dict(n_outer=3, n_inner=4, n_polish=2, polish_mu_boost=10.0, n_alpha=5,
                          mu0=50.0, mu_scale=5.0, tol_con=2e-4, tol_cost=3e-9, recover_viol=0.0)}
    port, ref = _solver_config(cfg), j_solver_config(cfg)
    for key, value in cfg["solver"].items():
        assert getattr(port, key) == value == getattr(ref, key), key
    for f in dataclasses.fields(ALILQRConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_port_imports_no_jax():
    """The port imports neither jax nor the JAX package."""
    mods = [
        "vehicle_control_tpu_torch." + m
        for m in (
            "parallel.batch", "utils.convert", "utils.config", "utils.device",
            "solvers.cuda_lib", "solvers.rollout_kernel_fm", "solvers.backward_kernel_fm",
            "solvers.solve_kernel_fm", "solvers.derivs_kernel_fm", "solvers.al_ilqr",
            "solvers.riccati", "controllers.mpc.controllers", "controllers.mpc.problems",
        )
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vehicle_control_tpu')]\n"
        + "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
