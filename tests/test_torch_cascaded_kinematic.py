"""The port's kinematic tail (tail="kc") against the JAX package's, on the CPU in float64.

The single-track + kinematic-bicycle cascade
(``configs/controllers/cascaded_kinematic.yaml``) cut to N=4 single-track
stages and K=4 kinematic stages (H=8), and to N=4, K=8 (H=12), where the
a-slew's mask (JAX's traced ``(n >= N+1) & (n-1 < K-1)``: the reference's
``k < K - 1`` on the global stage index) is live; on ippodromo, from inputs
made with a numpy seed.  The JAX runs that compile a solver run in
subprocesses of this file (``python tests/test_torch_cascaded_kinematic.py
JOB OUT``), all started at once while the port's side runs here: one traces
and compiles the XLA solver once for the solve and the fleet's batched
racing step, one runs the simulator, one its derivatives' references.
Tolerances:

* the closures at every stage kind (0, 1, N-2, the seam N-1, the switch N,
  N+1 and H-1 at K=4; the switch, N+1 and H-1 at K=8): ``stage_cost``,
  ``al_cost``, ``constraints``, ``dyn`` and
  ``u_box`` against the JAX family's segment-specialized closures, rtol
  1e-12;
* the hand-derived ``stage_derivs`` against JAX's generic autodiff of its
  own family (``fm_family.stage_derivs_cols`` with ``FM_FAST_DERIVS=0``, on
  the segment-specialized closures its kernels differentiate), every column,
  the seam's stash columns included,
  1e-9 of each entry's scale, with lanes at the edges of the closed forms:
  the integrated tail delta exactly on each steering stop, v = 0.5, delta
  = +-1, ey = +-8 and epsi = +-1.2 on the clamps' ties, s_dot exactly at the
  floor, a PHR row at lam + mu c = 0 exactly, the terminal speed on
  ``max_speed``;
* ``build_cascaded_problem(..., "kc")``'s ``init_horizon``,
  ``initial_prediction``, ``warm_start`` and the control boxes: bit for bit;
* ``initial_states(..., ns=8)``: bench.py's cascaded_kinematic drop
  (obstacles off), bit for bit;
* ``solve_plain`` (kernel 3's plain version) against JAX's XLA
  ``build_solver`` at B=8, at the fleet's budget (bench.py's but its 6
  polish iterations, 3 x 8, 6 steps, mu0 = 300): equal flags and counts,
  rtol 1e-6 (the multipliers' floor 1e-4 x scale), as test_torch_solve.py
  holds the single track;
* three closed-loop steps of ``make_batched_racing_step`` (B=8, bench.py's
  drop, that budget) against JAX's, lane by lane at every step, each step of
  the port taken from JAX's state and carry before it (the first from the
  drop and the port's aligned carry, JAX's within 1e-12): each lane's states
  and actions within rtol 1e-6, or the port's solve converged at a cost
  within 1e-6 relative of JAX's or lower, and either JAX's converged too
  (another, equally good basin: the kc problem is multi-modal), on at most
  a quarter of the lanes, or JAX's solve took no step because its seam
  Jacobian was NaN there (a_final = 0, see the test), which excuses that
  lane at that step alone;
* ``RacingSimulator``'s first three steps of ``CascadedKinematicMPC`` (the
  horizon cut to N=4, K=4, the solver to 2 x 4) against the JAX simulator's,
  rtol 1e-6, the accepted iterations within one of JAX's (see the test), the
  predictions' tail read at the kinematic fields; the controller's
  ``command`` on the simulator's first two states against the JAX
  simulator's actions and its
  ``get_state_prediction`` against the JAX controller's on the same carry;
  ``scripts.main --device cpu --steps 2`` with a cascaded_kinematic
  simconfig;
* the kc tail with obstacles raises (its own barrier is not ported).

The full f64 lap (H=40) is marked slow.
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
from vehicle_control_tpu.models import dynamic_car as jdc
from vehicle_control_tpu.solvers.fm_family import build_cascaded_family as j_family
from vehicle_control_tpu.solvers.fm_family import stage_derivs_cols
from vehicle_control_tpu.utils.config import ConfigDict as JConfigDict
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers import CascadedKinematicMPC
from vehicle_control_tpu_torch.controllers.mpc.controllers import MPCCarry
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.environment.track import Track
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.parallel.batch import (
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.scripts import main as tmain
from vehicle_control_tpu_torch.simulation import RacingSimulator
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig
from vehicle_control_tpu_torch.solvers.fm_family import build_cascaded_family
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
from vehicle_control_tpu_torch.utils import convert
from vehicle_control_tpu_torch.utils.config import ConfigDict, load_config, project_root

N, B = 4, 16
K_CUTS = (4, 8)  # horizon_kc: the a-slew's mask is live only where K >= N + 2
CAR = "models/dynamic_car.yaml"
CTRL = "controllers/cascaded_kinematic.yaml"
NAME = "cascaded_kinematic"
# every stage kind at K = 4; at K = 8 the switch, the a-slew's first live
# stage and the terminal stage
CASES = [(4, n) for n in (0, 1, N - 2, N - 1, N, N + 1, N + 3)] + [(8, n) for n in (N, N + 1, 11)]
# bench.py's cascaded_kinematic budget but its polish phase (which would
# trace JAX's inner loop twice: ~40 s more of tracing and compiling), for
# the solve and the fleet alike: JAX's solver is traced and compiled once
BUDGET = dict(n_outer=3, n_inner=8, n_alpha=6, mu0=300.0)
SOLVE_B, FLEET_B, FLEET_STEPS, DT = 8, 8, 3, 0.05
SIM_STEPS = 3
SIM_OVERRIDES = {NAME: {"horizon": N, "horizon_kc": 4, "solver": {"n_outer": 2, "n_inner": 4}}}


def _close(a, b, what, rtol=1e-12, atol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


def _cfg(loader, K=4, obstacles=False):
    cfg = loader(config_path(CTRL))
    cfg["horizon"] = N
    cfg["horizon_kc"] = K
    cfg["obstacles"] = obstacles
    return cfg


def _problems(K=4):
    jt, tt = tracks()
    jprob = jproblems.build_cascaded_problem(j_load_config(config_path(CAR)), jt,
                                             _cfg(j_load_config, K), "kc", jnp.float64)
    tprob = tproblems.build_cascaded_problem(load_config(config_path(CAR)), tt,
                                             _cfg(load_config, K), "kc", torch.float64, "cpu")
    return jprob, tprob


def _ctrl_cfg(loader):
    """The simulator's controller config (SIM_OVERRIDES over the YAML)."""
    return dict(_cfg(loader), solver={"n_outer": 2, "n_inner": 4})


def _simconfig():
    return {"track_name": "ippodromo", "controller_names": [NAME], "obstacles": False,
            "name": "torch_kc_test", "save_data": False, "controller_overrides": SIM_OVERRIDES}


def _solve_inputs(jprob, Bn, seed=0):
    """Rolled-out random controls from bench-like drops (JAX side), random
    multipliers: (z0, U, lam, curvature, ds) as numpy arrays."""
    rng = np.random.default_rng(seed)
    H = jprob.horizon
    state0 = np.zeros((Bn, 8))
    state0[:, 0] = 6.0 + rng.uniform(0, 8, Bn)
    state0[:, 4] = rng.uniform(0, 250, Bn)
    state0[:, 5] = rng.uniform(-1, 1, Bn)
    c0 = j_initial_carry(jprob, jnp.float64)
    warm = jax.vmap(jprob.warm_start)(jnp.asarray(state0))
    pv, zv = jax.vmap(jprob.init_horizon, in_axes=(0, 0, None))(
        jnp.asarray(state0), warm[0], c0.U_pred)
    U = np.stack([rng.normal(size=(Bn, H)) * 0.05, rng.normal(size=(Bn, H)) * 0.05], -1)
    U[:, N:, 0] *= 0.02  # the tail's a in units of FORCE_SCALE
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
    from unittest import mock

    from vehicle_control_tpu.controllers.mpc import controllers as jcontrollers
    from vehicle_control_tpu.parallel import aligned_carry as j_aligned_carry
    from vehicle_control_tpu.parallel import make_batched_racing_step as j_make_step
    from vehicle_control_tpu.simulation import RacingSimulator as JSimulator
    from vehicle_control_tpu.solvers import ALILQRConfig as JConfig
    from vehicle_control_tpu.solvers.al_ilqr import build_solver as j_build_solver

    if job == "sim":
        sim = JSimulator(JConfigDict(_simconfig()), j_load_config(config_path(CAR)),
                         j_load_config(config_path("environment/ippodromo.yaml")))
        sim.run(max_steps=SIM_STEPS, chunk=SIM_STEPS)
        np.savez(out, state=sim.state_traj[NAME], action=sim.action_traj[NAME],
                 violation=sim.violation_traj[NAME], iterations=sim.iter_traj[NAME],
                 preds=sim._global_preds(NAME))
        return
    if job == "derivs":  # JAX's generic autodiff of its family at every case
        os.environ["FM_FAST_DERIVS"] = "0"
        jt = tracks()[0]
        ref = {}
        for K, n in CASES:
            jfam = j_family(j_load_config(config_path(CAR)), _cfg(j_load_config, K), "kc",
                            jt.data)
            wf, lam, mu, kv, ds = _inputs(n, N + K)
            jds = jnp.asarray(ds)
            g1, H1, J1 = stage_derivs_cols(
                jfam, n, tuple(jnp.asarray(f) for f in wf), [jnp.asarray(v) for v in lam],
                jnp.asarray(mu), jnp.asarray(kv), lambda i: jds[i], seg=_seg(jfam, n))
            zero = 0.0 * np.asarray(g1[0])
            ref[f"{K}_{n}_g"] = np.stack([np.asarray(v) + zero for v in g1], -1)
            # (B, r, i): row r of column i
            ref[f"{K}_{n}_H"] = np.stack([np.stack([np.asarray(v) + zero for v in col], -1)
                                          for col in H1], -1)
            ref[f"{K}_{n}_J"] = np.stack([np.stack([np.asarray(v) + zero for v in col], -1)
                                          for col in J1], -1)
        np.savez(out, **ref)
        return
    # job == "solver": the solve, then the fleet's steps through the same
    # traced and compiled solver (make_mpc_step's build_solver hands it on)
    jprob = jproblems.build_cascaded_problem(j_load_config(config_path(CAR)), tracks()[0],
                                             _cfg(j_load_config), "kc", jnp.float64)
    jcfg = JConfig(**BUDGET, unroll=1)
    solve = jax.jit(j_build_solver(jprob.fns, jprob.horizon, jcfg, jprob.u_lo, jprob.u_hi))
    z0, U, lam, curv, ds = _solve_inputs(jprob, SOLVE_B)
    sol = jax.vmap(solve)(jproblems.HorizonParams(jnp.asarray(curv), jnp.asarray(ds)),
                          jnp.asarray(z0), jnp.asarray(U), jnp.asarray(lam))
    rec = {f"solve_{k}": np.asarray(getattr(sol, k)) for k in (
        "X", "U", "lam", "cost", "violation", "converged", "iterations")}

    def built(fns, horizon, cfg, u_lo, u_hi, **kernels):
        assert fns is jprob.fns and cfg == jcfg and not any(kernels.values())
        return solve

    jt = tracks()[0]
    states = _bench().initial_states(jt, 8, FLEET_B, np.random.default_rng(0))
    temporal, _ = jdc.make_transitions(jdc.DynamicCarParams.from_config(
        j_load_config(config_path(CAR))))
    with mock.patch.object(jcontrollers, "build_solver", built):
        step = j_make_step(jprob, jcfg, temporal, jt.data, DT, 4)
    st = jnp.asarray(states)
    carry = j_aligned_carry(jprob, st)
    fleet = {k: [] for k in ("state_in", "X_in", "U_in", "lam_in", "state", "action", "cost",
                             "converged", "violation", "iterations", "a_seam")}
    for _ in range(FLEET_STEPS):
        for k, v in (("state_in", st), ("X_in", carry.X_pred), ("U_in", carry.U_pred),
                     ("lam_in", carry.lam)):
            fleet[k].append(np.asarray(v))
        carry, st, action, info = step(carry, st)
        # a_final on the solution's seam (X[N] = X_pred[N-1]): where the
        # solve took no step, the warm rollout's
        for k, v in (("state", st), ("action", action), ("cost", info.cost),
                     ("converged", info.converged), ("violation", info.violation),
                     ("iterations", info.iterations), ("a_seam", carry.X_pred[:, N - 1, 6])):
            fleet[k].append(np.asarray(v))
    np.savez(out, drop=states, **rec, **{k: np.stack(v) for k, v in fleet.items()})


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Start the JAX jobs at once; ``jax_runs(job)`` waits for one and
    returns its arrays."""
    out = tmp_path_factory.mktemp("jax_cascaded_kinematic")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([project_root(), os.path.dirname(__file__)]))
    procs = {job: subprocess.Popen([sys.executable, __file__, job, str(out / f"{job}.npz")],
                                   cwd=project_root(), env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for job in ("solver", "sim", "derivs")}

    def result(job):
        log = procs[job].communicate(timeout=600)[0]
        assert procs[job].returncode == 0, f"JAX job {job} failed:\n{log[-4000:]}"
        return dict(np.load(out / f"{job}.npz"))

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- the family --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def families():
    """{K: (JAX family, port family)} on ippodromo, obstacles off."""
    jt, tt = tracks()
    return {K: (j_family(j_load_config(config_path(CAR)), _cfg(j_load_config, K), "kc", jt.data),
                build_cascaded_family(load_config(config_path(CAR)), _cfg(load_config, K), "kc",
                                      tt.data))
            for K in K_CUTS}


def _seg(jfam, n):
    (seg,) = [s for s in jfam.segments if s.lo <= n < s.hi]
    return seg


def _inputs(n, H, seed=11):
    """Stage inputs in the units of stage n's model, with lanes at the edges.
    Single track (n < N): the state (Ux, Uy, r, delta, s, ey, epsi, t), the
    stash (Fx_prev in kN, w_prev), (u_Fx, w); |ey| beyond ey_max, Ux at
    max_speed, the steering stop, a w row at lam + mu c = 0.  Kinematic tail
    (n >= N): (v, delta, s, ey, epsi, t, a_final, w stash, a_prev, w_prev,
    u_a, w), a in units of FORCE_SCALE; lanes 0-9 on the edges of the closed
    forms."""
    rng = np.random.default_rng(seed + n)
    if n < N:
        scales = [4.0, 0.6, 0.3, 0.2, 50.0, 1.5, 0.2, 5.0, 3.0, 0.2, 3.0, 0.2]
        offs = [10.0, 0, 0, 0, 50.0, 0, 0, 5.0, 1.0, 0, 1.0, 0]
    else:
        scales = [3.0, 0.2, 50.0, 1.5, 0.3, 5.0, 3.0, 0.2, 0.003, 0.2, 0.003, 0.2]
        offs = [8.0, 0, 50.0, 0, 0, 5.0, 1.0, 0, 0, 0, 0, 0]
    wf = np.stack([offs[i] + scales[i] * rng.standard_normal(B) for i in range(12)])
    lam = np.abs(rng.standard_normal((10, B)))
    if n < N:
        wf[5, 0], wf[5, 1] = 3.7, -4.2  # beyond the road's bounds
        wf[0, 2] = 20.0  # Ux at max_speed
        wf[3, 3] = 0.45  # delta on delta_max
        wf[11, 4], lam[4, 4] = 0.4, 0.0  # w on w_max with a zero multiplier: lam + mu c = 0
        wf[8, 5], wf[9, 5] = 2.5, 0.1  # the stash the kc seam reads
    else:
        wf[1, 0], wf[11, 0] = 0.45, 0.0  # the integrated delta exactly on delta_max
        wf[1, 1], wf[11, 1] = -0.45, 0.0  # and on delta_min
        wf[0, 2] = 0.5  # v on its clamp's tie
        wf[1, 3], wf[3, 3], wf[4, 3] = 1.0, 8.0, 1.2  # delta, ey, epsi on the clamps' ties
        wf[1, 4], wf[3, 4], wf[4, 4] = -1.0, -8.0, -1.2
        wf[0, 5], wf[4, 5], wf[3, 5] = 0.6, 0.0, -4.0  # s_dot = 0.6 / (1 - ey k) at the floor
        wf[0, 6] = 20.0  # v on max_speed (the terminal hinge's tie)
        wf[11, 7], lam[5, 7] = 0.4, 0.0  # w on w_max, lam + mu c = 0
        wf[0, 8], lam[0, 8] = 3.0, 0.0  # v on v_min, lam + mu c = 0
        wf[3, 9] = 3.5  # ey beyond ey_max
    lam[:, 10:12] = 0.0
    mu = np.full(B, 100.0)
    kv = 0.05 * rng.standard_normal(B)
    if n >= N:
        kv[5] = 0.25  # with ey = -4: 1 - ey k = 2
    ds = 0.3 + 0.2 * np.abs(rng.standard_normal((H, B)))
    return wf, lam, mu, kv, ds


@pytest.mark.parametrize("K,n", CASES)
def test_closures_match_jax(families, K, n):
    """stage_cost, al_cost, constraints, dyn and u_box against the JAX
    family's segment-specialized closures."""
    jfam, tfam = families[K]
    H = N + K
    wf, lam, mu, kv, ds = _inputs(n, H)
    seg = _seg(jfam, n)
    jw, tw = tuple(jnp.asarray(f) for f in wf), tuple(t(f) for f in wf)
    jds, tds = jnp.asarray(ds), t(ds)
    _close(tfam.stage_cost(n, tw, t(kv), lambda i: tds[i]),
           jfam.stage_cost(n, jw, jnp.asarray(kv), lambda i: jds[i], seg=seg), "stage_cost")
    _close(tfam.al_cost(n, tw, lambda j: t(lam[j]), t(mu), t(kv), lambda i: tds[i]),
           jfam.al_cost(n, jw, lambda j: jnp.asarray(lam[j]), jnp.asarray(mu),
                        jnp.asarray(kv), lambda i: jds[i], seg=seg), "al_cost")
    for r, (a, b) in enumerate(zip(tfam.constraints(n, tw), jfam.constraints(n, jw, seg=seg))):
        _close(a + 0.0 * tw[0], b + 0.0 * jw[0], f"constraint[{r}]")
    nxt = tfam.dyn(n, tw, t(kv), lambda i: tds[i])
    ref = jfam.dyn(n, jw, jnp.asarray(kv), lambda i: jds[i], seg=seg)
    assert len(nxt) == len(ref) == 10
    for r, (a, b) in enumerate(zip(nxt, ref)):
        _close(a, b + 0.0 * jw[0], f"dyn[{r}]")
    for j in range(2):
        for a, b in zip(tfam.u_box(n, j), jfam.u_box(n, j, seg=seg)):
            assert float(a) == float(b), (n, j)
    if n >= N:  # the edge lanes land on the steering stop
        assert nxt[1][0].item() == 0.45 and nxt[1][1].item() == -0.45


def test_kc_obstacles_raise():
    """The kc tail with obstacles needs its own barrier (the JAX package's
    _obstacles_kc), which is not ported: the family, the problem and the
    simulator raise."""
    car, tt = load_config(config_path(CAR)), tracks()[1]
    with pytest.raises(NotImplementedError, match="kc tail with obstacles"):
        build_cascaded_family(car, _cfg(load_config, obstacles=True), "kc", tt.data)
    with pytest.raises(NotImplementedError, match="kc tail with obstacles"):
        tproblems.build_cascaded_problem(car, tt, _cfg(load_config, obstacles=True), "kc",
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="kc tail with obstacles"):
        RacingSimulator(ConfigDict(dict(_simconfig(), obstacles=True)), car,
                        load_config(config_path("environment/ippodromo.yaml")), device="cpu")


# -- the problem -------------------------------------------------------------------------


@pytest.mark.parametrize("K", K_CUTS)
def test_problem_setup_matches_jax(K):
    """init_horizon (the tail's ds from mpc_dt_kc and its predicted speed),
    initial_prediction, warm_start and the control boxes, bit for bit."""
    jprob, tprob = _problems(K)
    H = N + K
    assert (tprob.horizon, tprob.nz, tprob.nu, tprob.nc, tprob.ns_model) == (
        jprob.horizon, jprob.nz, jprob.nu, jprob.nc, jprob.ns_model)
    rng = np.random.default_rng(4)
    state0 = np.stack([6.0 + 8.0 * rng.random(B), 0.1 * rng.standard_normal(B),
                       0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
                       300.0 * rng.random(B), rng.standard_normal(B),
                       0.1 * rng.standard_normal(B), rng.random(B)], -1)
    state0[0, 0] = 0.5  # warm_start's floor of 1
    X_prev = rng.random((B, H, 10)) * 12.0
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
    assert (tprob.u_lo[N:, 0] == -6.0 / 1000.0).all() and (tprob.u_scale[:, 1] == 1.0).all()


def test_initial_states_cascaded_kinematic_drop():
    """bench.py's cascaded_kinematic drop (the dynamic car, obstacles off):
    the same states to the bit."""
    jt, tt = tracks()
    states = initial_states(tt.length, 512, np.random.default_rng(0), ns=8)
    ref = _bench().initial_states(jt, 8, 512, np.random.default_rng(0))
    np.testing.assert_array_equal(states, ref)


def test_main_cpu(tmp_path):
    """``python -m vehicle_control_tpu_torch.scripts.main --device cpu
    --steps 2`` on a simconfig with ``controller_names: [cascaded_kinematic]``
    (the horizon cut through its overrides), its artifacts under
    ``{name}_{track}_torch``."""
    from vehicle_control_tpu_torch.utils.config import save_config

    sc = dict(_simconfig(), save_data=True, output_dir=str(tmp_path))
    save_config(sc, str(tmp_path / "simconfig.yaml"))
    sim = tmain.main(["--device", "cpu", "--steps", "2", "--config",
                      str(tmp_path / "simconfig.yaml")])
    assert sim.state_traj[NAME].shape == (2, 8)
    out = tmp_path / "data" / "torch_kc_test_ippodromo_torch"
    assert (out / f"{NAME}_state_traj.npy").exists()
    assert np.load(out / f"{NAME}_preds.npy").shape == (2, 8, 3)


@pytest.fixture(scope="module")
def port_runs():
    """The port's runs that the JAX jobs are compared with, made at once
    while those jobs run: RacingSimulator's first SIM_STEPS steps,
    CascadedKinematicMPC's commands on its first two states (with the
    prediction after each), ``solve_plain`` on ``_solve_inputs``, and the
    fleet's first step from bench.py's drop and its aligned carry."""
    sim = RacingSimulator(ConfigDict(_simconfig()), load_config(config_path(CAR)),
                          load_config(config_path("environment/ippodromo.yaml")), device="cpu")
    sim.run(max_steps=SIM_STEPS, chunk=SIM_STEPS)
    track_cfg = config_path("environment/ippodromo.yaml")
    ctrl = CascadedKinematicMPC(load_config(config_path(CAR)), Track(load_config(track_cfg)),
                                _ctrl_cfg(load_config), device="cpu")
    commands = []
    for state in sim.state_traj[NAME][:2]:
        action = ctrl.command(t(state)).numpy()
        commands.append((action, MPCCarry(*(a.clone() for a in ctrl._carry)),
                         ctrl.get_state_prediction().numpy()))
    jprob, tprob = _problems()
    z0, U, lam, curv, ds = _solve_inputs(jprob, SOLVE_B)
    params = convert.horizon_params(curv, ds, "cpu")
    carry = convert.mpc_carry(np.zeros(U.shape[:2] + (10,)), U, lam, "cpu")
    solve = solve_plain(tprob.family, ALILQRConfig(**BUDGET), t(z0), carry.U_pred,
                        carry.lam, params.curvature, params.ds)
    tt = tracks()[1]
    drop = initial_states(tt.length, FLEET_B, np.random.default_rng(0), ns=8)
    transition = tdc.make_transitions(tdc.DynamicCarParams.from_config(
        load_config(config_path(CAR))))[0]
    step = make_batched_racing_step(tprob, ALILQRConfig(**BUDGET, use_solve_kernel=True),
                                    transition, tt.data, DT, 4)
    carry0 = aligned_carry(tprob, t(drop))
    return dict(sim=sim, commands=commands, solve=solve, drop=drop, fleet_step=step,
                fleet_carry0=carry0, fleet0=step(carry0, t(drop)))


def test_simulator_matches_jax(port_runs, jax_runs):
    """RacingSimulator's first three steps of CascadedKinematicMPC (standing
    start, N=4 + K=4).

    The accepted iterations may differ by one: with the a-slew's mask dead
    (K < N + 2) the tail's acceleration has no curvature of its own, so at
    rho0 = 1e-6 its gains reach ~6.6e6 (step 3: dV1 = -4.3e7 in both
    solvers, the model not sane), and the plain-descent step taken then
    rounds apart; both solves reach the same solution (states within 1e-9)
    in 4 and 5 accepted steps."""
    sim = port_runs["sim"]
    ref = jax_runs("sim")
    got = dict(state=sim.state_traj[NAME], action=sim.action_traj[NAME],
               violation=sim.violation_traj[NAME], preds=sim._global_preds(NAME))
    for key, a in got.items():
        _close(a, ref[key], key, 1e-6, 1e-6)
    assert np.abs(sim.iter_traj[NAME] - ref["iterations"]).max() <= 1


def test_controller_matches_jax(port_runs, jax_runs):
    """CascadedKinematicMPC's commands on the simulator's first two states
    (the JAX simulator's within rtol 1e-6: test_simulator_matches_jax)
    against the JAX simulator's actions (the controller is the simulator's
    step on a batch of one), and the global prediction (the tail read at the
    kinematic fields) against the JAX controller's ``get_state_prediction``
    on the same carry."""
    from vehicle_control_tpu.controllers.mpc.controllers import CascadedKinematicMPC as JCtrl
    from vehicle_control_tpu.controllers.mpc.controllers import MPCCarry as JCarry
    from vehicle_control_tpu.environment.track import Track as JTrack

    track_cfg = config_path("environment/ippodromo.yaml")
    jctrl = JCtrl(j_load_config(config_path(CAR)), JTrack(j_load_config(track_cfg)),
                  _ctrl_cfg(j_load_config))
    ref = jax_runs("sim")
    for k, (action, carry, prediction) in enumerate(port_runs["commands"]):
        _close(action, ref["action"][k], f"command {k}", 1e-6, 1e-6)
        jctrl._carry = JCarry(*(jnp.asarray(a[0].numpy()) for a in carry))
        _close(prediction, jctrl.get_state_prediction(), f"prediction {k}", 1e-12, 1e-12)


# -- the references whose JAX runs take longest: the tests above run meanwhile ------------


@pytest.mark.parametrize("K,n", CASES)
def test_stage_derivs_match_jax(families, jax_runs, K, n):
    """Against JAX's generic autodiff of its family (the "derivs" job:
    ``stage_derivs_cols`` with its fast paths off, the linearization of the
    gradient and the dynamics of the stage's segment), all 12 columns (at
    the seam the stash columns a_final reads)."""
    _, tfam = families[K]
    H = N + K
    wf, lam, mu, kv, ds = _inputs(n, H)
    tds = t(ds)
    ref = jax_runs("derivs")
    g1, H1, J1 = (ref[f"{K}_{n}_{x}"] for x in "gHJ")
    g, Hw, Jm = tfam.stage_derivs(n, tuple(t(f) for f in wf), [t(v) for v in lam], t(mu),
                                  t(kv), lambda i: tds[i])
    for i in range(12):
        _close(g[:, i], g1[:, i], f"stage {n} g[{i}]", 1e-9, 1e-9)
        for r in range(12):
            _close(Hw[:, r, i], H1[:, r, i], f"stage {n} H[{r}][{i}]", 1e-9, 1e-9)
        for r in range(10):
            _close(Jm[:, r, i], J1[:, r, i], f"stage {n} J[{r}][{i}]", 1e-9, 1e-9)
    if n == N - 1:  # the seam reads the Fx stash and hands the w stash on
        assert (Jm[:, 6, 8] != 0).all() and (Jm[:, 7, 9] == 1).all()
    if n >= N:  # the steering stop's tie halves the integrated delta's row
        assert Jm[0, 1, 1].item() == 0.5 and Jm[1, 1, 1].item() == 0.5
    if n == N + 1:  # the a-slew: live at K = 8 only
        assert (Hw[:, 8, 8] != 0).all() == (K >= N + 2)


def test_solve_plain_matches_jax(port_runs, jax_runs):
    got = port_runs["solve"]
    ref = {k[len("solve_"):]: v for k, v in jax_runs("solver").items() if k.startswith("solve_")}
    np.testing.assert_array_equal(got[5].numpy(), ref["converged"])
    np.testing.assert_array_equal(got[6].numpy(), ref["iterations"])
    assert ref["iterations"].min() > 0  # every lane took steps
    for name, i in (("X", 0), ("U", 1), ("cost", 3), ("violation", 4)):
        _close(got[i].numpy(), ref[name], name, 1e-6, 1e-6)
    _close(got[2].numpy(), ref["lam"], "lam", 1e-6, 1e-4)


def test_fleet_steps_match_jax(port_runs, jax_runs):
    """Three closed-loop steps of the cascaded_kinematic fleet (kernel 3's
    plain version) against JAX's batched racing step, gated lane by lane at
    every step: each step of the port starts from JAX's state and carry
    before it (the first from the drop and the port's aligned carry, which
    matches JAX's), so a lane that parts at one step is compared again at
    the next.

    Where JAX's solver reaches the seam on its warm rollout with a_final = 0
    (the drop's straight-line state under the drag force: Ux' = Uy' = 0),
    its autodiff of sqrt gives the seam's Jacobian NaN entries and the solve
    takes no step (its X is then the warm rollout: a_final = 0 there); the
    port takes the norm's subgradient 0 there (fm_family._norm2) and solves.
    That lane is excused at that step alone if the port's solve converged
    at a cost no worse.  Every other lane that parts is another basin of the
    multi-modal problem: both converged, the port's cost as good, on at most
    a quarter of the lanes."""
    ref = jax_runs("solver")
    np.testing.assert_array_equal(port_runs["drop"], ref["drop"])
    for a, key in zip(port_runs["fleet_carry0"], ("X_in", "U_in", "lam_in")):
        _close(a.numpy(), ref[key][0], f"aligned carry {key}")
    # steps 1 and 2 from JAX's, in one batch
    lanes = (FLEET_STEPS - 1) * FLEET_B  # (step, lane) pairs, step-major
    carry = convert.mpc_carry(*(ref[k][1:].reshape((lanes,) + ref[k].shape[2:])
                                for k in ("X_in", "U_in", "lam_in")), "cpu")
    steps = [port_runs["fleet0"], port_runs["fleet_step"](
        carry, t(ref["state_in"][1:].reshape(lanes, -1)))]
    got = {}
    for key, f in (("state", lambda o: o[1]), ("action", lambda o: o[2]),
                   ("cost", lambda o: o[3].cost), ("converged", lambda o: o[3].converged),
                   ("iterations", lambda o: o[3].iterations)):
        v = torch.cat([f(o) for o in steps]).numpy()
        got[key] = v.reshape((FLEET_STEPS, FLEET_B) + v.shape[1:])
    parted, excused = set(), 0
    for k in range(FLEET_STEPS):
        for b in range(FLEET_B):
            if all(np.allclose(got[key][k][b], ref[key][k][b], rtol=1e-6,
                               atol=1e-6 * (1.0 + np.abs(ref[key][k][b]).max()))
                   for key in ("state", "action")):
                continue
            cost, cost_ref = got["cost"][k][b], ref["cost"][k][b]
            assert got["converged"][k][b], (k, b)
            assert cost <= cost_ref + 1e-6 * (1.0 + abs(cost_ref)), (k, b, cost, cost_ref)
            if ref["iterations"][k][b] == 0 and ref["a_seam"][k][b] == 0.0:
                assert got["iterations"][k][b] > 0, (k, b)  # JAX's NaN slope: no step
                excused += 1
            else:  # another basin: both converged, the port's solve as good
                assert ref["converged"][k][b], (k, b)
                parted.add(b)
    assert len(parted) <= FLEET_B // 4, (parted, excused)


@pytest.mark.slow
def test_full_lap_matches_reference():
    """The simconfig's cascaded_kinematic lap on the CPU in f64 at the full
    horizon (kernel 3's plain version, seconds a step): it runs as the JAX
    f64 lap does (tests/cascaded_kinematic_lap_study.py)."""
    sc = load_config(config_path("simconfig.yaml"))
    sc.update(controller_names=[NAME], save_data=False, logging=False)
    sim = RacingSimulator(sc, load_config(config_path(CAR)),
                          load_config(config_path("environment/ippodromo.yaml")), device="cpu")
    sim.run(max_steps=800)
    st = sim.state_traj[NAME]
    assert np.isfinite(st).all()


if __name__ == "__main__":
    _jax_job(sys.argv[1], sys.argv[2])
