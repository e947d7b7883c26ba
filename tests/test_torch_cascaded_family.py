"""The torch port's point-mass cascade (tail="pm") against the JAX package's.

The cascade is cut to N=4 single-track and M=5 point-mass stages, so every
static segment of the family has a stage here: single track (0, 1), the
seam N-1 (3), the switch N (4), the point-mass tail (5) and the terminal
stage H-1 (8).  On the same float64 inputs, field by field over a batch of
lanes, the port is held against:

* the point-mass model (``models.point_mass``): the ODEs and transitions,
  to rtol 1e-12;
* the closures (stage cost, AL cost, constraints, dynamics, control boxes):
  against the JAX family's segment-specialized closures and against the
  JAX problem's own callbacks (``build_cascaded_problem(..., "pm")``), to
  rtol 1e-12 - the same expressions, evaluated in the same order but for
  the masked blends;
* the hand-derived stage derivatives: against JAX's ``stage_derivs_cols``
  on its fast path (``_st_fast``, ``_tail_fast``; generic at the seam),
  against its generic tangent sweep, and against ``torch.func`` autodiff of
  the port's own closures, to 1e-9 of each entry's scale.  Forward-mode
  jets and JAX's reverse mode reassociate sums; JAX's single-track fast
  path takes its RK4 Jacobian from ``rk4_step_jac``, which sits up to
  2.1e-9 x scale from the autodiff on saturated lanes, hence a 5e-9 floor
  there (as in test_torch_family.py);
* the problem set-up: ``init_horizon``, ``warm_start``,
  ``initial_prediction``, the per-stage boxes and ``u_scale``, to 1e-12;
* the plain versions of kernels 1, 2 and 4 against the JAX problem's XLA
  references (``torch_parity``'s oracles) on rolled-out random controls and
  multipliers: rtol 1e-9, as for the single-track family
  (test_torch_kernels_plain.py, test_torch_solve.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    backward_oracle,
    cascaded_cfg,
    config_path,
    derivs_oracle,
    linesearch_oracle,
    problems,
    solver_inputs,
    t,
    tracks,
)
from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.models import point_mass as jpm
from vehicle_control_tpu.solvers.fm_family import (
    build_cascaded_family as j_family,
    stage_derivs_cols,
)
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.models import point_mass as tpm
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import derivs_plain
from vehicle_control_tpu_torch.solvers.fm_family import build_cascaded_family
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import linesearch_costs_plain
from vehicle_control_tpu_torch.utils import convert
from vehicle_control_tpu_torch.utils.config import load_config

N, M = 4, 5
H = N + M
STAGES = (0, 1, N - 1, N, N + 1, H - 1)  # single track x2, seam, switch, tail, terminal
B = 16
CAR = "models/dynamic_car.yaml"
ALPHAS = [1.0, 0.25, 0.01]


@pytest.fixture(scope="module")
def families():
    jt, _ = tracks()
    jfam = j_family(j_load_config(config_path(CAR)), cascaded_cfg(N, M, j_load_config), "pm",
                    jt.data)
    tfam = build_cascaded_family(load_config(config_path(CAR)), cascaded_cfg(N, M), "pm")
    return jfam, tfam


def _seg(jfam, n):
    (seg,) = [s for s in jfam.segments if s.lo <= n < s.hi]
    return seg


def _inputs(n, seed=3):
    """Stage inputs in the units of stage n's model, with adversarial lanes.
    Single track (n < N): |ey| beyond ey_max, Ux at and beyond max_speed and
    at the solver clamp, saturated tires, the steering stop, active engine
    and friction rows.  Point mass: V at the engine row's max tie (1), at
    the clamp (0.5), below both and beyond max_speed, |ey| beyond ey_max, an
    active engine row, a large lateral force."""
    rng = np.random.default_rng(seed + n)
    if n < N:
        scales = [4.0, 0.6, 0.3, 0.2, 50.0, 1.5, 0.2, 5.0, 3.0, 0.2, 3.0, 0.2]
        offs = [10.0, 0, 0, 0, 50.0, 0, 0, 5.0, 1.0, 0, 1.0, 0]
    else:  # (V, s, ey, epsi, t, Fy stash [N], -, -, Fx_prev, Fy_prev, u_Fx, u_Fy [kN])
        scales = [4.0, 50.0, 1.5, 0.2, 5.0, 2000.0, 0.1, 0.1, 3.0, 2.0, 3.0, 2.0]
        offs = [10.0, 50.0, 0, 0, 5.0, 0, 0, 0, 1.0, 0, 1.0, 0]
    wf = np.stack([offs[i] + scales[i] * rng.standard_normal(B) for i in range(12)])
    if n < N:
        wf[5, 0], wf[5, 1] = 3.7, -4.2
        wf[0, 2], wf[0, 3] = 20.0, 23.5
        wf[0, 4] = 1.0
        wf[1, 5], wf[2, 5] = 5.0, 1.5
        wf[3, 6] = 0.45
        wf[10, 7] = 45.0
        wf[10, 8] = -15.0
    else:
        wf[0, 0], wf[0, 1], wf[0, 2], wf[0, 3] = 1.0, 0.5, 0.8, 23.5
        wf[2, 4], wf[2, 5] = 3.7, -4.2
        wf[10, 6], wf[0, 6] = 45.0, 2.0
        wf[11, 7] = 24.0
    lam = np.abs(rng.standard_normal((10, B)))
    lam[:, 9:12] = 0.0
    mu = np.full(B, 100.0)
    kv = 0.05 * rng.standard_normal(B)
    ds = 0.3 + 0.2 * np.abs(rng.standard_normal((H, B)))
    ds[N:] += 2.7  # the point-mass steps are ds_pm = 3 long
    return wf, lam, mu, kv, ds


def _close(a, b, what, rtol=1e-12, atol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    scale = 1.0 + np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale, err_msg=what)


def test_point_mass_matches_jax():
    jp = jpm.PointMassParams.from_config(j_load_config(config_path(CAR)))
    tp = tdc.DynamicCarParams.from_config(load_config(config_path(CAR)))
    rng = np.random.default_rng(0)
    x = np.stack([8 + 4 * rng.standard_normal(B), 100 * rng.random(B), rng.standard_normal(B),
                  0.2 * rng.standard_normal(B), 5 * rng.random(B)], -1)
    x[0, 0], x[1, 0] = 0.0, 5e-4  # the 1e-3 guard on V, both sides of it
    u = np.stack([1000 * rng.standard_normal(B), 2000 * rng.standard_normal(B)], -1)
    k = 0.05 * rng.standard_normal(B)
    for name in ("temporal_ode", "spatial_ode"):
        _close(getattr(tpm, name)(t(x), t(u), t(k), tp),
               getattr(jpm, name)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), jp), name)
    for name, a, b in zip(("temporal", "spatial"), tpm.make_transitions(tp),
                          jpm.make_transitions(jp)):
        _close(a(t(x), t(u), t(k), 0.05), b(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), 0.05),
               f"{name} transition")
    for name in ("Fz_f", "Fz_r"):
        _close(getattr(tpm, name)(t(x[:, 0]), t(u[:, 0]), tp),
               getattr(jpm, name)(jnp.asarray(x[:, 0]), jnp.asarray(u[:, 0]), jp), name)


@pytest.mark.parametrize("n", STAGES)
def test_closures_match_jax(families, n):
    """Against the JAX family's closures on the stage's segment, and against
    the JAX problem's callbacks (the masked blend of every branch)."""
    jfam, tfam = families
    jprob, _ = problems(N, horizon_pm=M)
    seg = _seg(jfam, n)
    wf, lam, mu, kv, ds = _inputs(n)
    jw = tuple(jnp.asarray(f) for f in wf)
    tw = tuple(t(f) for f in wf)
    jds, tds = jnp.asarray(ds), t(ds)
    jlam, tlam = (lambda j: jnp.asarray(lam[j])), (lambda j: t(lam[j]))
    tc = tfam.al_cost(n, tw, tlam, t(mu), t(kv), lambda i: tds[i])
    _close(tc, jfam.al_cost(n, jw, jlam, jnp.asarray(mu), jnp.asarray(kv), lambda i: jds[i],
                            seg=seg), "al_cost")
    ts = tfam.stage_cost(n, tw, t(kv), lambda i: tds[i])
    tdyn = tfam.dyn(n, tw, t(kv), lambda i: tds[i])
    tcon = [c + 0.0 * tw[0] for c in tfam.constraints(n, tw)]
    for r, (a, b) in enumerate(zip(tdyn, jfam.dyn(n, jw, jnp.asarray(kv), lambda i: jds[i],
                                                  seg=seg))):
        _close(a, b, f"dyn[{r}]")
    for r, (a, b) in enumerate(zip(tcon, jfam.constraints(n, jw, seg=seg))):
        _close(a, b + 0.0 * jw[0], f"constraint[{r}]")
    for j in range(2):
        assert tfam.u_box(n, j) == tuple(float(v) for v in jfam.u_box(n, j, seg=seg))

    # the XLA problem's batched callbacks
    z, u = jnp.asarray(wf[:10].T), jnp.asarray(wf[10:].T)
    params = jproblems.HorizonParams(jnp.asarray(np.repeat(kv[:, None], H, 1)), jds.T)
    _close(ts, jprob.fns.stage_cost(n, z, u, params), "problem stage_cost")
    _close(torch.stack(tcon, -1), jprob.fns.constraints(n, z, u, params), "problem constraints")
    _close(torch.stack(tdyn, -1), jprob.fns.dynamics(n, z, u, params), "problem dynamics")


@pytest.mark.parametrize("path", ["fast", "generic"])
@pytest.mark.parametrize("n", STAGES[1:])  # stage 0's single-track rows: test_torch_family.py
def test_stage_derivs_match_jax(families, n, path):
    """Against JAX's stage_derivs_cols on the stage's segment: its fast path
    (generic at the seam, where JAX has none) and its generic tangent sweep."""
    jfam, tfam = families
    atol = 5e-9 if path == "fast" and n < N - 1 else 1e-9
    if path == "generic":
        jfam = jfam._replace(fast_derivs=None)
    wf, lam, mu, kv, ds = _inputs(n)
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


@pytest.mark.parametrize("n", STAGES)
def test_stage_derivs_match_torch_func(families, n):
    """Against autodiff of the port's own closures, on lanes away from the
    kinks where conventions at a tie could differ."""
    _, tfam = families
    wf, lam, mu, kv, ds = _inputs(n, seed=11)
    tds = t(ds)
    g, Hw, Jm = tfam.stage_derivs(
        n, tuple(t(f) for f in wf), [t(v) for v in lam], t(mu), t(kv), lambda i: tds[i]
    )
    for b in range(12, 15):
        lam_b = [t(v[b]) for v in lam]

        def L(w):
            return tfam.al_cost(n, tuple(w.unbind(-1)), lambda j: lam_b[j], t(mu[b]),
                                t(kv[b]), lambda i: tds[i, b])

        def f(w):
            return torch.stack(tfam.dyn(n, tuple(w.unbind(-1)), t(kv[b]), lambda i: tds[i, b]))

        w0 = t(wf[:, b])
        _close(g[b], torch.func.grad(L)(w0), f"stage {n} lane {b} g", 1e-9, 1e-9)
        _close(Hw[b], torch.func.hessian(L)(w0), f"stage {n} lane {b} H", 1e-9, 1e-9)
        _close(Jm[b], torch.func.jacfwd(f)(w0), f"stage {n} lane {b} J", 1e-9, 1e-9)


def test_problem_setup_matches_jax():
    """init_horizon (from a warm start and from the standing start),
    warm_start, initial_prediction, the per-stage boxes and u_scale."""
    jprob, tprob = problems(N, horizon_pm=M)
    jt, _ = tracks()
    rng = np.random.default_rng(1)
    states = np.zeros((B, 8))
    states[:, 0] = 6.0 + 8.0 * rng.random(B)
    states[:, 4] = float(jt.length) * rng.random(B)
    states[:, 5] = rng.uniform(-1, 1, B)
    js = jnp.asarray(states)
    jX, jU = jax.vmap(jprob.warm_start)(js)
    tX, tU = tprob.warm_start(t(states))
    _close(tX, jX, "warm_start X")
    _close(tU, jU, "warm_start U")
    jX0, jU0 = jprob.initial_prediction()
    tX0, tU0 = tprob.initial_prediction()
    _close(tX0, jX0, "initial_prediction X")
    _close(tU0, jU0, "initial_prediction U")
    for Xp, Up, tXp, tUp, what in ((jX, jU, tX, tU, "warm"),
                                   (jnp.broadcast_to(jX0, jX.shape), jnp.broadcast_to(jU0, jU.shape),
                                    tX0.expand(tX.shape), tU0.expand(tU.shape), "standing")):
        jp, jz = jax.vmap(jprob.init_horizon)(js, Xp, Up)
        tp, tz = tprob.init_horizon(t(states), tXp, tUp)
        _close(tp.curvature, jp.curvature, f"init_horizon curvature ({what})")
        _close(tp.ds, jp.ds, f"init_horizon ds ({what})")
        _close(tz, jz, f"init_horizon z0 ({what})")
    for name in ("u_lo", "u_hi", "u_scale"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)), err_msg=name)
    assert (tprob.horizon, tprob.family.N, tprob.family.tail) == (H, N, "pm")


def test_unported_families_raise():
    """The kinematic tail with obstacles (its own barrier) is not ported yet,
    without them it builds (tests/test_torch_cascaded_kinematic.py holds it
    against JAX's); the "pm" and "none" families build with the obstacle
    barrier (tests/test_torch_obstacles.py holds it against JAX's); a
    cascade with M = 0 is the single-track family."""
    car, tt = load_config(config_path(CAR)), tracks()[1]
    kc_cfg = dict(load_config(config_path("controllers/cascaded_kinematic.yaml")), horizon=N,
                  horizon_kc=M)
    with pytest.raises(NotImplementedError, match="kc tail with obstacles"):
        tproblems.build_cascaded_problem(car, tt, dict(kc_cfg, obstacles=True), "kc",
                                         device="cpu")
    prob = tproblems.build_cascaded_problem(car, tt, kc_cfg, "kc", device="cpu")
    assert (prob.family.tail, prob.horizon, prob.family.obstacles) == ("kc", H, ())
    with pytest.raises(ValueError, match="tail"):
        build_cascaded_family(car, cascaded_cfg(N, M), "point_mass")
    for tail in ("pm", "none"):
        prob = tproblems.build_cascaded_problem(car, tt, dict(cascaded_cfg(N, M), obstacles=True),
                                                tail, device="cpu")
        assert prob.family.tail == tail and len(prob.family.obstacles) == len(tt.obstacles) == 7
    fam = build_cascaded_family(car, cascaded_cfg(N, 0), "pm")
    assert (fam.tail, fam.H, fam.N) == ("none", N, N)


def test_plain_kernels_match_jax():
    """Kernels 1, 2 and 4's plain versions on the cascade: the line-search
    costs (lane 0 starts beyond the 1e7 state guard), the backward pass and
    the stage derivatives at every stage."""
    jprob, tprob = problems(N, horizon_pm=M)
    fam = tprob.family
    X, U, lam, mu, rho, params, z0 = solver_inputs(jprob, 8)
    rng = np.random.default_rng(1)
    kff = rng.normal(size=(8, H, 2)) * 0.02
    Kfb = rng.normal(size=(8, H, 2, 10)) * 0.01
    hp = convert.horizon_params(params.curvature, params.ds, "cpu")
    z0 = np.array(z0)
    z0[0, 1] = 1e8
    ref = linesearch_oracle(jprob, ALPHAS, X, U, kff, Kfb, lam, mu, params, z0)
    got = linesearch_costs_plain(fam, ALPHAS, t(X), t(U), t(kff), t(Kfb), t(lam), t(mu),
                                 hp.curvature, hp.ds, t(z0)).numpy()
    assert np.isposinf(ref[:, 0]).all() and np.isposinf(got[:, 0]).all()
    assert np.isfinite(ref[:, 1:]).all()
    _close(got[:, 1:], ref[:, 1:], "line-search costs", 1e-9, 1e-9)

    derivs = derivs_oracle(jprob, X, U, lam, mu, params)
    ref = backward_oracle(jprob, X, U, lam, mu, rho, params, derivs)
    got = backward_plain(fam, t(X), t(U), t(lam), t(mu), t(rho), hp.curvature, hp.ds)
    np.testing.assert_array_equal(got[4].numpy(), ref[4])
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        _close(a.numpy(), b, name, 1e-9, 1e-9)

    got = derivs_plain(fam, t(X), t(U), t(lam), t(mu), hp.curvature, hp.ds)
    for name, a, b in zip(("g", "Hw", "J"), got, derivs):
        assert a.shape == b.shape, name
        _close(a.numpy(), b, name, 1e-9, 1e-9)
