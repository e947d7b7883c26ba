"""The port's obstacle barrier against the JAX package's, on the CPU in float64.

The barrier is a cost term, sum_i w ds / max(dist_i - (r_i + 0.1), 1e-2)
over the (s, ey) distance to each disc's centre, on (z[4], z[5]) at the
single-track stages and on (z[1], z[2]) at the point-mass stages.  On
ippodromo's seven discs, on the same float64 inputs, the port is held
against:

* the track's obstacle side: the discs, the host occupancy grid (equal),
  the host lookup and the device lookups ``occupancy`` and
  ``obstacle_distances`` at 1,000 seeded (s, ey) points, rtol 1e-12;
* the families with ``obstacles=True``, both tails (``"pm"`` cut to N=4 +
  M=5, every static segment; ``"none"``, the single-track family, H=4):
  the closures (stage cost, AL cost, constraints, dynamics) to rtol 1e-12
  against the JAX family's, and the hand-derived stage derivatives against
  JAX's fast path (``stage_derivs_cols``) to 1e-9 of each entry's scale
  (5e-9 where JAX's single-track Jacobian is its analytic RK4 chain), as
  ``test_torch_cascaded_family.py`` holds them.  The lanes sit 2-15 m
  before a disc, one on the barrier's floor and one beside a disc; the
  barrier's (s, ey) gradient must be live on at least half of them;
* kernel 1's plain version (the line-search costs) on the obstacle cascade
  against the JAX problem's XLA line search (``torch_parity``'s oracle, run
  in a subprocess of this file), rtol 1e-9;
* ``initial_states`` with the track's discs: bench.py's drop, to the bit;
* ``RacingSimulator`` with ``obstacles: true``, 3 closed-loop steps of the
  cascade cut to N=4 + M=5, budget 2 x 4, against the JAX simulator in f64
  (run in a subprocess of this file) to rtol 1e-6, accepted iterations
  equal, as ``test_torch_simulation.py`` holds the obstacle-free lap.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    config_path,
    linesearch_oracle,
    singletrack_cfg,
    cascaded_cfg,
    solver_inputs,
    t,
    tracks,
)
from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.environment import track as jtrack
from vehicle_control_tpu.simulation import RacingSimulator as JSimulator
from vehicle_control_tpu.solvers.fm_family import (
    build_cascaded_family as j_family,
    stage_derivs_cols,
)
from vehicle_control_tpu.utils.config import ConfigDict as JConfigDict
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.environment import track as ttrack
from vehicle_control_tpu_torch.parallel.batch import initial_states
from vehicle_control_tpu_torch.simulation import RacingSimulator
from vehicle_control_tpu_torch.solvers.fm_family import build_cascaded_family
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import linesearch_costs_plain
from vehicle_control_tpu_torch.utils.config import ConfigDict, load_config, project_root

N, M = 4, 5
B = 16
CAR = "models/dynamic_car.yaml"
TAILS = {  # tail -> (horizon, stages: every static segment)
    "pm": (N + M, (0, 1, N - 1, N, N + 1, N + M - 1)),
    "none": (N, (0, 1, N - 1)),
}
CASES = [(tail, n) for tail, (_, stages) in TAILS.items() for n in stages]
SIM_STEPS, SIM_CHUNK = 3, 3
SIM_OVERRIDES = {"cascaded": {"horizon": N, "horizon_pm": M,
                              "solver": {"n_outer": 2, "n_inner": 4}}}
ALPHAS = [1.0, 0.25, 0.01]


def _close(a, b, what, rtol=1e-12, atol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


def _cfg(tail, loader):
    cfg = cascaded_cfg(N, M, loader) if tail == "pm" else singletrack_cfg(N, loader)
    cfg["obstacles"] = True
    return cfg


def _simconfig():
    return {"track_name": "ippodromo", "controller_names": ["cascaded"], "obstacles": True,
            "name": "torch_obstacles_test", "save_data": False,
            "controller_overrides": SIM_OVERRIDES}


def _car_track(loader):
    return (loader(config_path(CAR)), loader(config_path("environment/ippodromo.yaml")))


# -- the JAX runs, in subprocesses -----------------------------------------------


def _jax_job(job, out):
    """Run one JAX reference and save its arrays to ``out`` (an .npz): the
    simulator, or the plain kernels' inputs and their XLA references."""
    if job == "sim":
        sim = JSimulator(JConfigDict(_simconfig()), *_car_track(j_load_config))
        sim.run(max_steps=SIM_STEPS, chunk=SIM_CHUNK)
        np.savez(out, state=sim.state_traj["cascaded"], action=sim.action_traj["cascaded"],
                 violation=sim.violation_traj["cascaded"], iterations=sim.iter_traj["cascaded"],
                 preds=sim._global_preds("cascaded"))
        return
    jprob = jproblems.build_cascaded_problem(j_load_config(config_path(CAR)), tracks()[0],
                                             _cfg("pm", j_load_config), "pm", jnp.float64)
    X, U, lam, mu, _, params, z0 = solver_inputs(jprob, 8)
    rng = np.random.default_rng(1)
    kff = rng.normal(size=(8, N + M, 2)) * 0.02
    Kfb = rng.normal(size=(8, N + M, 2, 10)) * 0.01
    np.savez(out, X=X, U=U, lam=lam, mu=mu, curv=params.curvature, ds=params.ds, z0=z0,
             kff=kff, Kfb=Kfb,
             costs=linesearch_oracle(jprob, ALPHAS, X, U, kff, Kfb, lam, mu, params, z0))


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Start the JAX jobs at once; ``jax_runs(job)`` waits for one and
    returns its arrays."""
    out = tmp_path_factory.mktemp("jax_obstacles")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([project_root(), os.path.dirname(__file__)]))
    procs = {job: subprocess.Popen([sys.executable, __file__, job, str(out / f"{job}.npz")],
                                   cwd=project_root(), env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for job in ("sim", "kernels")}

    def result(job):
        log = procs[job].communicate(timeout=600)[0]
        assert procs[job].returncode == 0, f"JAX job {job} failed:\n{log[-4000:]}"
        return dict(np.load(out / f"{job}.npz"))

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def families():
    """{tail: (JAX family, port family)} with obstacles on ippodromo."""
    jt, tt = tracks()
    out = {}
    for tail in TAILS:
        jfam = j_family(j_load_config(config_path(CAR)), _cfg(tail, j_load_config), tail,
                        jt.data)
        tfam = build_cascaded_family(load_config(config_path(CAR)), _cfg(tail, load_config),
                                     tail, tt.data)
        out[tail] = (jfam, tfam)
    return out


def _inputs(tail, n, seed=5):
    """Stage inputs in the units of stage n's model.  (s, ey) 2-15 m before
    one of the discs (in table order, lane by lane), ey within 1.5 m of its
    centre; lane 0 inside a disc (on the barrier's floor), lane 1 level with
    a disc's centre, beside it.  The other fields as in
    test_torch_cascaded_family.py, with active engine and friction rows."""
    H = TAILS[tail][0]
    rng = np.random.default_rng(seed + n + (100 if tail == "none" else 0))
    obs = np.asarray(tracks()[1].data.obstacles)
    if tail == "none" or n < N:
        scales = [4.0, 0.6, 0.3, 0.2, 0.0, 0.0, 0.2, 5.0, 3.0, 0.2, 3.0, 0.2]
        offs = [10.0, 0, 0, 0, 0, 0, 0, 5.0, 1.0, 0, 1.0, 0]
        i_s = 4
    else:  # (V, s, ey, epsi, t, Fy stash [N], -, -, Fx_prev, Fy_prev, u_Fx, u_Fy [kN])
        scales = [4.0, 0.0, 0.0, 0.2, 5.0, 2000.0, 0.1, 0.1, 3.0, 2.0, 3.0, 2.0]
        offs = [10.0, 0, 0, 0, 5.0, 0, 0, 0, 1.0, 0, 1.0, 0]
        i_s = 1
    wf = np.stack([offs[i] + scales[i] * rng.standard_normal(B) for i in range(12)])
    disc = obs[np.arange(B) % len(obs)]
    wf[i_s] = disc[:, 2] - rng.uniform(2.0, 15.0, B)
    wf[i_s + 1] = disc[:, 3] + rng.uniform(-1.5, 1.5, B)
    wf[i_s, 0], wf[i_s + 1, 0] = obs[1, 2] + 0.3, obs[1, 3] + 0.5  # inside disc 1
    wf[i_s, 1], wf[i_s + 1, 1] = obs[4, 2], obs[4, 3] + obs[4, 4] + 0.4  # beside disc 4
    if tail == "none" or n < N:
        wf[10, 7] = 45.0  # engine-power row active
        wf[10, 8] = -15.0  # friction rows active
    else:
        wf[10, 6], wf[0, 6] = 45.0, 2.0
    lam = np.abs(rng.standard_normal((10, B)))
    mu = np.full(B, 100.0)
    kv = 0.05 * rng.standard_normal(B)
    ds = 0.3 + 0.2 * np.abs(rng.standard_normal((H, B)))
    if tail == "pm":
        ds[N:] += 2.7  # the point-mass steps are ds_pm = 3 long
    return wf, lam, mu, kv, ds, i_s


def _seg(jfam, n):
    if jfam.segments is None:
        return None
    (seg,) = [s for s in jfam.segments if s.lo <= n < s.hi]
    return seg


def test_track_obstacles_match_jax():
    """The discs, the occupancy grid, the host lookup and the device lookups
    at 1,000 seeded points over negative s and later laps."""
    jt, tt = tracks()
    assert len(tt.obstacles) == len(jt.obstacles) == 7
    for a, b in zip(tt.obstacles, jt.obstacles):
        _close([a.cx, a.cy, a.s, a.ey, a.radius], [b.cx, b.cy, b.s, b.ey, b.radius], "disc")
    assert "_occupancy_host" not in vars(tt)  # the grid is built on its first lookup
    grid = tt.occupancy_grid
    np.testing.assert_array_equal(grid.occ_grid.numpy(), jt._occ_grid)
    _close(tt.data.obstacles.numpy(), jt.data.obstacles, "obstacles")
    for f in ("occ_grid", "occ_ds", "occ_ey0", "occ_dey", "length"):
        _close(getattr(grid, f).numpy(), getattr(jt.data, f), f)
    rng = np.random.default_rng(0)
    s = rng.uniform(-1.5 * jt.length, 2.5 * jt.length, 1000)
    ey = rng.uniform(-4.5, 4.5, 1000)
    obs = np.asarray(jt.data.obstacles)
    s[:300] = obs[np.arange(300) % 7, 2] + rng.uniform(-4, 4, 300)  # near the discs
    _close(ttrack.occupancy(grid, t(s), t(ey)).numpy(), jtrack.occupancy(jt.data, s, ey),
           "device occupancy")
    _close(ttrack.obstacle_distances(tt.data, t(s), t(ey)).numpy(),
           jtrack.obstacle_distances(jt.data, s, ey), "obstacle_distances")
    s_host = np.mod(s, jt.length)
    _close(tt.occupancy(s_host, ey), jt.occupancy(s_host, ey), "host occupancy")
    occupied = ttrack.occupancy(grid, t(obs[:, 2]), t(obs[:, 3])).numpy()
    assert (occupied > 0.5).all(), occupied


@pytest.mark.parametrize("tail,n", CASES)
def test_closures_match_jax(families, tail, n):
    jfam, tfam = families[tail]
    seg = _seg(jfam, n)
    kw = {} if seg is None else {"seg": seg}
    wf, lam, mu, kv, ds, _ = _inputs(tail, n)
    jw, tw = tuple(jnp.asarray(f) for f in wf), tuple(t(f) for f in wf)
    jds, tds = jnp.asarray(ds), t(ds)
    _close(tfam.stage_cost(n, tw, t(kv), lambda i: tds[i]),
           jfam.stage_cost(n, jw, jnp.asarray(kv), lambda i: jds[i], **kw), "stage_cost")
    _close(tfam.al_cost(n, tw, lambda j: t(lam[j]), t(mu), t(kv), lambda i: tds[i]),
           jfam.al_cost(n, jw, lambda j: jnp.asarray(lam[j]), jnp.asarray(mu),
                        jnp.asarray(kv), lambda i: jds[i], **kw), "al_cost")
    for r, (a, b) in enumerate(zip(tfam.constraints(n, tw), jfam.constraints(n, jw, **kw))):
        _close(a + 0.0 * tw[0], b + 0.0 * jw[0], f"constraint[{r}]")
    for r, (a, b) in enumerate(zip(tfam.dyn(n, tw, t(kv), lambda i: tds[i]),
                                   jfam.dyn(n, jw, jnp.asarray(kv), lambda i: jds[i], **kw))):
        _close(a, b, f"dyn[{r}]")


@pytest.mark.parametrize("tail,n", CASES)
def test_stage_derivs_match_jax(families, tail, n):
    """Against JAX's fast path (generic at the seam, where JAX has none),
    with the barrier live: its (s, ey) gradient and Hessian block (the only
    terms on s) non-zero on at least half of the lanes."""
    jfam, tfam = families[tail]
    atol = 5e-9 if n < N - 1 else 1e-9
    wf, lam, mu, kv, ds, i_s = _inputs(tail, n)
    jds, tds = jnp.asarray(ds), t(ds)
    g1, H1, J1 = stage_derivs_cols(
        jfam, n, tuple(jnp.asarray(f) for f in wf), [jnp.asarray(v) for v in lam],
        jnp.asarray(mu), jnp.asarray(kv), lambda i: jds[i], seg=_seg(jfam, n),
    )
    g, Hw, Jm = tfam.stage_derivs(
        n, tuple(t(f) for f in wf), [t(v) for v in lam], t(mu), t(kv), lambda i: tds[i]
    )
    for i in range(12):
        _close(g[:, i], g1[i], f"stage {n} g[{i}]", 1e-9, atol)
        for r in range(12):
            _close(Hw[:, r, i], H1[i][r] + 0.0 * g1[0], f"stage {n} H[{r}][{i}]", 1e-9, atol)
        for r in range(10):
            _close(Jm[:, r, i], J1[i][r] + 0.0 * g1[0], f"stage {n} J[{r}][{i}]", 1e-9, atol)
    live = (g[:, i_s].abs() > 1e-6) & (Hw[:, i_s, i_s].abs() > 1e-6)
    assert live.double().mean() >= 0.5, live
    assert g[0, i_s] != 0.0 or not live[0]  # lane 0 floored on disc 1, live on the others


def test_plain_linesearch_matches_jax(jax_runs):
    """Kernel 1's plain version (the line-search costs) on the obstacle
    cascade against the JAX problem's XLA line search, from drops over the
    whole lap.  (Kernels 2 and 4's plain versions are the stage derivatives
    of test_stage_derivs_match_jax, and kernel 2's the Riccati sweep over
    them.)"""
    tprob = tproblems.build_cascaded_problem(load_config(config_path(CAR)), tracks()[1],
                                             _cfg("pm", load_config), "pm", torch.float64, "cpu")
    fam = tprob.family
    ref = jax_runs("kernels")
    X, U, lam, mu, curv, ds, z0, kff, Kfb = (
        t(ref[k]) for k in ("X", "U", "lam", "mu", "curv", "ds", "z0", "kff", "Kfb"))
    got = linesearch_costs_plain(fam, ALPHAS, X, U, kff, Kfb, lam, mu, curv, ds, z0)
    _close(got.numpy(), ref["costs"], "line-search costs", 1e-9, 1e-9)


def _bench():
    """bench.py, imported with the JAX settings it changes put back (it
    points the compile cache at the repo)."""
    import jax

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


def test_initial_states_avoid_obstacles():
    """bench.py's drop with avoid_obstacles (``bench.initial_states``): the
    same states to the bit, every drop at least radius + 2 from each disc's
    centre."""
    jt, tt = tracks()
    states = initial_states(tt.length, 512, np.random.default_rng(0), tt.data.obstacles.numpy())
    ref = _bench().initial_states(jt, 8, 512, np.random.default_rng(0), avoid_obstacles=True)
    np.testing.assert_array_equal(states, ref)
    obs = np.asarray(jt.data.obstacles)
    d = np.sqrt((states[:, 4, None] - obs[:, 2]) ** 2 + (states[:, 5, None] - obs[:, 3]) ** 2)
    assert (d >= obs[:, 4] + 2.0).all()


def test_simulator_matches_jax(jax_runs):
    """RacingSimulator with obstacles: 3 steps of the cut cascade against
    the JAX simulator in f64."""
    sim = RacingSimulator(ConfigDict(_simconfig()), *_car_track(load_config), device="cpu")
    assert sim.entries["cascaded"].problem.family.obstacles
    sim.run(max_steps=SIM_STEPS, chunk=SIM_CHUNK)
    ref = jax_runs("sim")
    got = dict(state=sim.state_traj["cascaded"], action=sim.action_traj["cascaded"],
               violation=sim.violation_traj["cascaded"], preds=sim._global_preds("cascaded"))
    for key, a in got.items():
        _close(a, ref[key], key, 1e-6, 1e-6)
    np.testing.assert_array_equal(sim.iter_traj["cascaded"], ref["iterations"])


if __name__ == "__main__":
    _jax_job(sys.argv[1], sys.argv[2])
