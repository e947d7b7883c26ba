"""The port's pure kinematic family against the JAX package's, on the CPU in float64.

The kinematic bicycle (``configs/models/kinematic_car.yaml``) and its MPC
(``configs/controllers/kinematic.yaml``, cut to N=8 running stages, H=9), on
ippodromo, from inputs made with a numpy seed.  The JAX runs that compile
a solver (its XLA solver, its batched racing step, its simulator) run in
subprocesses of this file (``python tests/test_torch_kinematic.py JOB
OUT``) while the port's side runs here.  Tolerances:

* the model: ``temporal_ode``, ``spatial_ode`` and the plant's temporal
  Euler step, rtol 1e-12;
* the regularized Euler step's derivative ``kc_prime_jacobian`` against
  JAX's autodiff of its ``fm_family._kc_prime``, at the kinematic family's
  regularization and at the kc tail's (v clamped too), ties included,
  1e-12 of each entry's scale;
* the family at every stage kind (0, 1, N-1, the terminal N), obstacles on
  and off: ``stage_cost``, ``al_cost``, ``constraints`` and ``dyn``, rtol
  1e-12;
* the family's hand-derived ``stage_derivs`` against JAX's generic autodiff
  of its own family (``fm_family.stage_derivs_cols``: the kinematic family
  has no fast path), 1e-9 of each entry's scale, with lanes at the edges of
  the closed forms: the integrated delta exactly on delta_max and on
  delta_min (the steering stop's tie), delta, ey and epsi on the clamps'
  ties, v at and above v_max on the terminal stage, a PHR row at lam + mu c
  = 0 exactly;
* ``build_kinematic_problem``'s ``init_horizon`` (the reference's ds and
  curvature off-by-one), ``initial_prediction``, ``warm_start`` and the
  control boxes: bit for bit;
* ``initial_states(..., ns=6)``: bench.py's kinematic drop, obstacles
  avoided, bit for bit;
* ``solve_plain`` (kernel 3's plain version) against JAX's XLA
  ``build_solver`` at B=8, budget 2 outer x 3 inner + 1 polish, 6 steps:
  equal flags and counts, rtol 1e-6 (the multipliers' floor 1e-4 x scale),
  as test_torch_solve.py holds the single track;
* three closed-loop steps of ``make_batched_racing_step`` (B=8, obstacles
  on, bench.py's drop and budget, 2 x 3, 6 steps, mu0 = 10) against JAX's,
  lane by lane: each lane's states and actions within rtol 1e-6 at every
  step, or, from the step where it parts, both solves converged and the
  port's cost within 1e-6 relative of JAX's or lower (another, equally good
  basin: the family can be multi-modal), on at most a quarter of the lanes;
* ``KinematicRacingSimulator``'s first two steps (the solver budget cut to
  2 x 4) against the JAX simulator's, rtol 1e-6, accepted iterations
  equal; ``scripts.kinmain --device cpu --steps 2``.

The full f64 lap (H=51, ~7 s a solve of kernel 3's plain version on one
core) is marked slow.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import config_path, t, tracks
from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.controllers.mpc.controllers import initial_carry as j_initial_carry
from vehicle_control_tpu.models import kinematic_car as jkc
from vehicle_control_tpu.solvers.fm_family import _kc_prime as j_kc_prime
from vehicle_control_tpu.solvers.fm_family import build_kinematic_family as j_family
from vehicle_control_tpu.solvers.fm_family import stage_derivs_cols
from vehicle_control_tpu.utils.config import ConfigDict as JConfigDict
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.models import kinematic_car as tkc
from vehicle_control_tpu_torch.parallel.batch import (
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.scripts import kinmain
from vehicle_control_tpu_torch.simulation import KinematicRacingSimulator
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
from vehicle_control_tpu_torch.solvers.fm_family import build_kinematic_family, kc_prime_jacobian
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
from vehicle_control_tpu_torch.utils import convert
from vehicle_control_tpu_torch.utils.config import ConfigDict, load_config, project_root

N, B = 8, 16
H = N + 1
CAR = "models/kinematic_car.yaml"
STAGES = (0, 1, N - 1, N)
CASES = [(n, obs) for obs in (True, False) for n in STAGES]
SOLVE_B, SOLVE_BUDGET = 8, dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6)
FLEET_B, FLEET_STEPS, DT = 8, 3, 0.05
FLEET_BUDGET = dict(n_outer=2, n_inner=3, n_alpha=6)  # bench.py's kinematic budget, mu0 = 10
SIM_STEPS = 2
SIM_OVERRIDES = {"kinematic": {"horizon": N, "solver": {"n_outer": 2, "n_inner": 4}}}
KIN_LAP_REF_S = 18.75  # the JAX f64 kinematic lap, 375 steps (tests/kinematic_lap_study.py)


def _close(a, b, what, rtol=1e-12, atol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


def _cfg(loader, obstacles=True, horizon=N):
    cfg = loader(config_path("controllers/kinematic.yaml"))
    cfg["horizon"] = horizon
    cfg["obstacles"] = obstacles
    return cfg


def _problems(obstacles=True):
    jt, tt = tracks()
    jprob = jproblems.build_kinematic_problem(j_load_config(config_path(CAR)), jt,
                                              _cfg(j_load_config, obstacles), jnp.float64)
    tprob = tproblems.build_kinematic_problem(load_config(config_path(CAR)), tt,
                                              _cfg(load_config, obstacles), torch.float64, "cpu")
    return jprob, tprob


def _simconfig():
    return {"track_name": "ippodromo", "controller_names": ["kinematic"], "obstacles": False,
            "name": "torch_kinematic_test", "save_data": False,
            "controller_overrides": SIM_OVERRIDES}


def _solve_inputs(jprob, Bn, seed=0):
    """Rolled-out random controls from kinematic drops (JAX side), random
    multipliers: (z0, U, lam, curvature, ds) as numpy arrays."""
    rng = np.random.default_rng(seed)
    state0 = np.zeros((Bn, 6))
    state0[:, 0] = 2.0 + rng.uniform(0, 6, Bn)
    state0[:, 2] = rng.uniform(0, 250, Bn)
    state0[:, 3] = rng.uniform(-1, 1, Bn)
    c0 = j_initial_carry(jprob, jnp.float64)
    warm = jax.vmap(jprob.warm_start)(jnp.asarray(state0))
    pv, zv = jax.vmap(jprob.init_horizon, in_axes=(0, 0, None))(
        jnp.asarray(state0), warm[0], c0.U_pred)
    U = np.stack([rng.normal(size=(Bn, H)) * 0.5, rng.normal(size=(Bn, H)) * 0.05], -1)
    lam = np.abs(rng.normal(size=(Bn, H, 10)) * 0.1)
    return (np.asarray(zv), U, lam, np.asarray(pv.curvature), np.asarray(pv.ds))


# -- the JAX runs, in subprocesses -----------------------------------------------


def _bench():
    """bench.py, imported with the JAX settings it changes put back (it
    points the compile cache at the repo)."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    sys.path.insert(0, project_root())
    try:
        import bench
    finally:
        sys.path.remove(project_root())
        for k, v in saved.items():
            jax.config.update(k, v)
    return bench


def _jax_job(job, out):
    """Run one JAX reference and save its arrays to ``out`` (an .npz)."""
    from vehicle_control_tpu.parallel import aligned_carry as j_aligned_carry
    from vehicle_control_tpu.parallel import make_batched_racing_step as j_make_step
    from vehicle_control_tpu.simulation import KinematicRacingSimulator as JSimulator
    from vehicle_control_tpu.solvers import ALILQRConfig as JConfig
    from vehicle_control_tpu.solvers.al_ilqr import build_solver as j_build_solver

    if job == "sim":
        sim = JSimulator(JConfigDict(_simconfig()), j_load_config(config_path(CAR)),
                         j_load_config(config_path("environment/ippodromo.yaml")))
        sim.run(max_steps=SIM_STEPS, chunk=SIM_STEPS)
        np.savez(out, state=sim.state_traj["kinematic"], action=sim.action_traj["kinematic"],
                 violation=sim.violation_traj["kinematic"],
                 iterations=sim.iter_traj["kinematic"], preds=sim._global_preds("kinematic"))
        return
    jprob, _ = _problems(obstacles=job == "fleet")
    if job == "solve":
        z0, U, lam, curv, ds = _solve_inputs(jprob, SOLVE_B)
        solve = j_build_solver(jprob.fns, H, JConfig(**SOLVE_BUDGET, unroll=1), jprob.u_lo,
                               jprob.u_hi)
        pv = jproblems.HorizonParams(jnp.asarray(curv), jnp.asarray(ds))
        ref = jax.jit(jax.vmap(solve))(pv, jnp.asarray(z0), jnp.asarray(U), jnp.asarray(lam))
        np.savez(out, **{k: np.asarray(getattr(ref, k)) for k in (
            "X", "U", "lam", "cost", "violation", "converged", "iterations")})
        return
    jt = tracks()[0]
    states = _bench().initial_states(jt, 6, FLEET_B, np.random.default_rng(0),
                                     avoid_obstacles=True)
    temporal, _ = jkc.make_transitions(jkc.KinematicCarParams.from_config(
        j_load_config(config_path(CAR))))
    step = jax.jit(j_make_step(jprob, JConfig(**FLEET_BUDGET), temporal, jt.data, DT, 2))
    st = jnp.asarray(states)
    carry = j_aligned_carry(jprob, st)
    rec = {k: [] for k in ("state", "action", "cost", "converged", "violation")}
    for _ in range(FLEET_STEPS):
        carry, st, action, info = step(carry, st)
        for k, v in (("state", st), ("action", action), ("cost", info.cost),
                     ("converged", info.converged), ("violation", info.violation)):
            rec[k].append(np.asarray(v))
    np.savez(out, drop=states, **{k: np.stack(v) for k, v in rec.items()})


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Start the JAX jobs at once; ``jax_runs(job)`` waits for one and
    returns its arrays."""
    out = tmp_path_factory.mktemp("jax_kinematic")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([project_root(), os.path.dirname(__file__)]))
    procs = {job: subprocess.Popen([sys.executable, __file__, job, str(out / f"{job}.npz")],
                                   cwd=project_root(), env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for job in ("solve", "fleet", "sim")}

    def result(job):
        log = procs[job].communicate(timeout=600)[0]
        assert procs[job].returncode == 0, f"JAX job {job} failed:\n{log[-4000:]}"
        return dict(np.load(out / f"{job}.npz"))

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- the model and the family ----------------------------------------------------------


def test_model_matches_jax():
    """temporal_ode, spatial_ode and the plant's temporal Euler step."""
    rng = np.random.default_rng(3)
    x = np.stack([2.0 + 6.0 * rng.random(B), 0.3 * rng.standard_normal(B),
                  250.0 * rng.random(B), rng.standard_normal(B), 0.3 * rng.standard_normal(B),
                  10.0 * rng.random(B)], -1)
    x[0, 0] = 1e-4  # safe_div's guard on v cos(epsi)
    u = np.stack([rng.standard_normal(B), 0.2 * rng.standard_normal(B)], -1)
    k = 0.05 * rng.standard_normal(B)
    jp = jkc.KinematicCarParams.from_config(j_load_config(config_path(CAR)))
    tp = tkc.KinematicCarParams.from_config(load_config(config_path(CAR)))
    assert tp == convert.kin_car_params({"l": np.asarray(jp.l)})
    for name, tf, jf in (("temporal_ode", tkc.temporal_ode, jkc.temporal_ode),
                         ("spatial_ode", tkc.spatial_ode, jkc.spatial_ode)):
        _close(tf(t(x), t(u), t(k), tp), jf(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), jp),
               name)
    step_t, step_j = tkc.make_transitions(tp)[0], jkc.make_transitions(jp)[0]
    _close(step_t(t(x), t(u), t(k), 0.05),
           step_j(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), 0.05), "plant step")


# (floor, beta, clamps) of the kinematic family and of the kc tail
REGULARIZATIONS = {
    "kinematic": (0.02, 50.0, {1: (-1.0, 1.0), 3: (-8.0, 8.0), 4: (-1.2, 1.2)}),
    "kc_tail": (0.3, 10.0, {0: (0.5, 1e3), 1: (-1.0, 1.0), 3: (-8.0, 8.0), 4: (-1.2, 1.2)}),
}


@pytest.mark.parametrize("reg", list(REGULARIZATIONS))
def test_kc_prime_jacobian_matches_jax(reg):
    """The step's primes and their partials over (v, delta, ey, epsi, a, w)
    against jax.jacfwd of _kc_prime; lanes on the clamps' ties (v at 0.5,
    delta at 1, ey at -8, epsi at 1.2) and a standstill below the floor."""
    floor, beta, clamps = REGULARIZATIONS[reg]
    rng = np.random.default_rng(7)
    x = np.stack([rng.uniform(0.0, 6.0, B), 0.3 * rng.standard_normal(B),
                  rng.uniform(0, 250, B), rng.standard_normal(B),
                  0.3 * rng.standard_normal(B), rng.random(B)])
    x[0, 0], x[1, 1], x[3, 2], x[4, 3], x[0, 4] = 0.5, 1.0, -8.0, 1.2, 0.0
    a, w, k = rng.standard_normal(B), 0.2 * rng.standard_normal(B), 0.05 * rng.standard_normal(B)
    l = float(load_config(config_path(CAR))["car"]["l"])
    prime, D = kc_prime_jacobian([t(r) for r in x], t(a), t(w), t(k), l, floor, beta, clamps)

    def f(xx, aa, ww, kk):
        return jnp.stack(j_kc_prime(list(xx), aa, ww, kk, l, floor, beta, clamps))

    args = tuple(jnp.asarray(v) for v in (x, a, w, k))
    ref = jax.vmap(f, in_axes=(1, 0, 0, 0))(*args)
    jac = jax.vmap(jax.jacfwd(f, argnums=(0, 1, 2)), in_axes=(1, 0, 0, 0))(*args)
    for r in range(6):
        _close(prime[r], ref[:, r], f"prime[{r}]")
    for (r, c), dv in D.items():
        col = jac[1][:, r] if c == "a" else jac[2][:, r] if c == "w" else jac[0][:, r, c]
        _close(dv + 0.0 * t(a), col, f"d prime[{r}] / d {c}")


@pytest.fixture(scope="module")
def families():
    """{obstacles: (JAX family, port family)} on ippodromo."""
    jt, tt = tracks()
    return {obs: (j_family(j_load_config(config_path(CAR)), _cfg(j_load_config, obs), jt.data),
                  build_kinematic_family(load_config(config_path(CAR)), _cfg(load_config, obs),
                                         tt.data))
            for obs in (True, False)}


def _inputs(n, seed=5):
    """Stage inputs (v, delta, s, ey, epsi, t, a_prev, w_prev, a, w): (s,
    ey) 2-8 m before one of the discs lane by lane, within 1.5 m of its
    ey; lanes 0-7 at the edges of the closed forms."""
    rng = np.random.default_rng(seed + n)
    obs = np.asarray(tracks()[1].data.obstacles)
    disc = obs[np.arange(B) % len(obs)]
    wf = np.stack([4.0 + 3.0 * rng.standard_normal(B), 0.15 * rng.standard_normal(B),
                   disc[:, 2] - rng.uniform(2.0, 8.0, B), disc[:, 3] + rng.uniform(-1.5, 1.5, B),
                   0.3 * rng.standard_normal(B), 5.0 + rng.standard_normal(B),
                   rng.standard_normal(B), 0.2 * rng.standard_normal(B),
                   2.0 * rng.standard_normal(B), 0.3 * rng.standard_normal(B)])
    wf[1, 0], wf[9, 0] = 0.3, 0.0  # the integrated delta exactly on delta_max
    wf[1, 1], wf[9, 1] = -0.3, 0.0  # and on delta_min
    wf[1, 2], wf[3, 2], wf[4, 2] = 1.0, 8.0, 1.2  # the clamps' ties
    wf[0, 3] = 10.0  # v at v_max
    wf[0, 4] = 11.0  # v beyond v_max
    wf[3, 5] = 3.0  # ey at ey_max
    wf[8, 6] = 3.0  # a at a_max: its row's c = 0
    wf[0, 7] = -1.0  # v below the state clamps' reach
    lam = np.abs(rng.standard_normal((10, B)))
    lam[3, 6] = 0.0  # lam + mu c = 0 exactly on a_max's row
    mu = np.full(B, 100.0)
    kv = 0.05 * rng.standard_normal(B)
    ds = 0.3 + 0.2 * np.abs(rng.standard_normal((H, B)))
    return wf, lam, mu, kv, ds


@pytest.mark.parametrize("n,obs", CASES)
def test_closures_match_jax(families, n, obs):
    jfam, tfam = families[obs]
    wf, lam, mu, kv, ds = _inputs(n)
    jw, tw = tuple(jnp.asarray(f) for f in wf), tuple(t(f) for f in wf)
    jds, tds = jnp.asarray(ds), t(ds)
    _close(tfam.stage_cost(n, tw, t(kv), lambda i: tds[i]),
           jfam.stage_cost(n, jw, jnp.asarray(kv), lambda i: jds[i]), "stage_cost")
    _close(tfam.al_cost(n, tw, lambda j: t(lam[j]), t(mu), t(kv), lambda i: tds[i]),
           jfam.al_cost(n, jw, lambda j: jnp.asarray(lam[j]), jnp.asarray(mu),
                        jnp.asarray(kv), lambda i: jds[i]), "al_cost")
    for r, (a, b) in enumerate(zip(tfam.constraints(n, tw), jfam.constraints(n, jw))):
        _close(a + 0.0 * tw[0], b + 0.0 * jw[0], f"constraint[{r}]")
    nxt = tfam.dyn(n, tw, t(kv), lambda i: tds[i])
    for r, (a, b) in enumerate(zip(nxt, jfam.dyn(n, jw, jnp.asarray(kv), lambda i: jds[i]))):
        _close(a, b, f"dyn[{r}]")
    if n < N:  # the edge lanes land on the steering stop
        assert nxt[1][0].item() == 0.3 and nxt[1][1].item() == -0.3


@pytest.mark.parametrize("n,obs", CASES)
def test_stage_derivs_match_jax(families, n, obs):
    """Against JAX's generic autodiff of its family; with obstacles the
    barrier's s gradient (the only term on s) is live on most lanes."""
    jfam, tfam = families[obs]
    wf, lam, mu, kv, ds = _inputs(n)
    jds, tds = jnp.asarray(ds), t(ds)
    g1, H1, J1 = stage_derivs_cols(
        jfam, n, tuple(jnp.asarray(f) for f in wf), [jnp.asarray(v) for v in lam],
        jnp.asarray(mu), jnp.asarray(kv), lambda i: jds[i])
    g, Hw, Jm = tfam.stage_derivs(n, tuple(t(f) for f in wf), [t(v) for v in lam], t(mu),
                                  t(kv), lambda i: tds[i])
    zero = 0.0 * np.asarray(g1[0])
    for i in range(10):
        _close(g[:, i], g1[i], f"stage {n} g[{i}]", 1e-9, 1e-9)
        for r in range(10):
            _close(Hw[:, r, i], H1[i][r] + zero, f"stage {n} H[{r}][{i}]", 1e-9, 1e-9)
        for r in range(8):
            _close(Jm[:, r, i], J1[i][r] + zero, f"stage {n} J[{r}][{i}]", 1e-9, 1e-9)
    if n < N:  # the steering stop's tie halves the integrated delta's row
        assert Jm[0, 1, 1].item() == 0.5 and Jm[1, 1, 1].item() == 0.5
    else:  # the speed hinge at v_max and beyond
        assert Hw[3, 0, 0].item() == Hw[4, 0, 0].item() == 2.0 * tfam.weights["v"]
    if obs and n < N:
        assert (g[:, 2] != 0).double().mean() >= 0.5


# -- the problem -------------------------------------------------------------------------


def test_problem_setup_matches_jax():
    """init_horizon (with the reference's off-by-one), initial_prediction,
    warm_start and the control boxes, bit for bit."""
    jprob, tprob = _problems()
    assert (tprob.horizon, tprob.nz, tprob.nu, tprob.nc, tprob.ns_model) == (
        jprob.horizon, jprob.nz, jprob.nu, jprob.nc, jprob.ns_model)
    rng = np.random.default_rng(4)
    state0 = np.stack([2.0 + 6.0 * rng.random(B), 0.1 * rng.standard_normal(B),
                       300.0 * rng.random(B), rng.standard_normal(B),
                       0.1 * rng.standard_normal(B), rng.random(B)], -1)
    state0[0, 0] = 0.05  # warm_start's floor of 0.1
    X_prev = rng.random((B, H, 8)) * 8.0
    U_prev = rng.standard_normal((B, H, 2))
    pv, zv = jax.vmap(jprob.init_horizon)(jnp.asarray(state0), jnp.asarray(X_prev),
                                          jnp.asarray(U_prev))
    params, z0 = tprob.init_horizon(t(state0), t(X_prev), t(U_prev))
    np.testing.assert_array_equal(params.ds.numpy(), np.asarray(pv.ds))
    np.testing.assert_array_equal(params.curvature.numpy(), np.asarray(pv.curvature))
    np.testing.assert_array_equal(z0.numpy(), np.asarray(zv))
    for a, b in zip(tprob.initial_prediction(), jprob.initial_prediction()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tprob.warm_start(t(state0)), jax.vmap(jprob.warm_start)(jnp.asarray(state0))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((tprob.u_lo, jprob.u_lo), (tprob.u_hi, jprob.u_hi), (tprob.u_scale,
                                                                      jprob.u_scale)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_initial_states_kinematic_drop():
    """bench.py's kinematic drop (v in [2, 8] at field 0, s and ey at 2 and
    3, clear of the discs): the same states to the bit."""
    jt, tt = tracks()
    states = initial_states(tt.length, 512, np.random.default_rng(0), tt.data.obstacles.numpy(),
                            ns=6)
    ref = _bench().initial_states(jt, 6, 512, np.random.default_rng(0), avoid_obstacles=True)
    np.testing.assert_array_equal(states, ref)
    obs = np.asarray(jt.data.obstacles)
    d = np.sqrt((states[:, 2, None] - obs[:, 2]) ** 2 + (states[:, 3, None] - obs[:, 3]) ** 2)
    assert (d >= obs[:, 4] + 2.0).all()


def test_solve_plain_matches_jax(jax_runs):
    jprob, tprob = _problems(obstacles=False)
    z0, U, lam, curv, ds = _solve_inputs(jprob, SOLVE_B)
    params = convert.horizon_params(curv, ds, "cpu")
    carry = convert.mpc_carry(np.zeros(U.shape[:2] + (8,)), U, lam, "cpu")
    got = solve_plain(tprob.family, ALILQRConfig(**SOLVE_BUDGET), t(z0), carry.U_pred,
                      carry.lam, params.curvature, params.ds)
    ref = jax_runs("solve")
    np.testing.assert_array_equal(got[5].numpy(), ref["converged"])
    np.testing.assert_array_equal(got[6].numpy(), ref["iterations"])
    assert ref["iterations"].min() > 0  # every lane took steps
    for name, i in (("X", 0), ("U", 1), ("cost", 3), ("violation", 4)):
        _close(got[i].numpy(), ref[name], name, 1e-6, 1e-6)
    _close(got[2].numpy(), ref["lam"], "lam", 1e-6, 1e-4)


def test_fleet_steps_match_jax(jax_runs):
    """Three closed-loop steps of the kinematic fleet (kernel 3's plain
    version) against JAX's batched racing step, gated lane by lane."""
    _, tprob = _problems(obstacles=True)
    ref = jax_runs("fleet")
    tt = tracks()[1]
    drop = initial_states(tt.length, FLEET_B, np.random.default_rng(0),
                          tt.data.obstacles.numpy(), ns=6)
    np.testing.assert_array_equal(drop, ref["drop"])
    transition = tkc.make_transitions(tkc.KinematicCarParams.from_config(
        load_config(config_path(CAR))))[0]
    step = make_batched_racing_step(tprob, ALILQRConfig(**FLEET_BUDGET, use_solve_kernel=True),
                                    transition, tt.data, DT, 2)
    st = t(drop)
    carry = aligned_carry(tprob, st)
    parted = np.full(FLEET_B, -1)
    for k in range(FLEET_STEPS):
        carry, st, action, info = step(carry, st)
        for b in np.nonzero(parted < 0)[0]:
            tight = all(np.allclose(a[b].numpy(), ref[key][k][b], rtol=1e-6,
                                    atol=1e-6 * (1.0 + np.abs(ref[key][k][b]).max()))
                        for key, a in (("state", st), ("action", action)))
            if tight:
                continue
            parted[b] = k  # another basin: both converged, the port's solve as good
            cost, cost_ref = info.cost[b].item(), ref["cost"][k][b]
            assert bool(info.converged[b]) and ref["converged"][k][b], (k, b)
            assert cost <= cost_ref + 1e-6 * (1.0 + abs(cost_ref)), (k, b, cost, cost_ref)
    assert (parted >= 0).mean() <= 0.25, parted


def test_simulator_matches_jax(jax_runs):
    """KinematicRacingSimulator's first two steps (standing start, H=9)."""
    sim = KinematicRacingSimulator(ConfigDict(_simconfig()), load_config(config_path(CAR)),
                                   load_config(config_path("environment/ippodromo.yaml")),
                                   device="cpu")
    sim.run(max_steps=SIM_STEPS, chunk=SIM_STEPS)
    ref = jax_runs("sim")
    got = dict(state=sim.state_traj["kinematic"], action=sim.action_traj["kinematic"],
               violation=sim.violation_traj["kinematic"], preds=sim._global_preds("kinematic"))
    for key, a in got.items():
        _close(a, ref[key], key, 1e-6, 1e-6)
    np.testing.assert_array_equal(sim.iter_traj["kinematic"], ref["iterations"])


def test_kinmain_cpu(tmp_path):
    """``python -m vehicle_control_tpu_torch.scripts.kinmain --device cpu
    --steps 2`` (the horizon cut through the simconfig's overrides), its
    artifacts under ``{name}_{track}_torch``."""
    from vehicle_control_tpu_torch.utils.config import save_config

    sc = dict(_simconfig(), save_data=True, output_dir=str(tmp_path))
    save_config(sc, str(tmp_path / "simconfig.yaml"))
    sim = kinmain.main(["--device", "cpu", "--steps", "2", "--config",
                        str(tmp_path / "simconfig.yaml")])
    assert sim.state_traj["kinematic"].shape == (2, 6)
    out = tmp_path / "data" / "torch_kinematic_test_ippodromo_torch"
    assert (out / "kinematic_state_traj.npy").exists()


@pytest.mark.slow
def test_full_lap_matches_reference():
    """The simconfig's kinematic lap on the CPU in f64 at the full horizon
    (kernel 3's plain version, ~7 s a step): the lap completes within 0.25
    s of the JAX f64 lap (tests/kinematic_lap_study.py)."""
    sc = load_config(config_path("simconfig.yaml"))
    sc.update(controller_names=["kinematic"], save_data=False, logging=False)
    sim = KinematicRacingSimulator(sc, load_config(config_path(CAR)),
                                   load_config(config_path("environment/ippodromo.yaml")),
                                   device="cpu")
    sim.run(max_steps=600)
    st = sim.state_traj["kinematic"]
    assert st[-1, 2] > sim.track.length - 0.1
    assert abs(st[-1, 5] + sim.dt - KIN_LAP_REF_S) <= 0.25


if __name__ == "__main__":
    _jax_job(sys.argv[1], sys.argv[2])
