"""Shared helpers for the tests that hold the torch port against the JAX package.

Both sides get the same inputs, made from a numpy seed, in float64; data
crosses between the packages as numpy arrays.  The JAX references here are
its plain (XLA) paths, rebuilt from the problem's public callbacks:

* ``linesearch_oracle``: the line-search rollout costs of the field-major
  line-search kernel (``rollout_kernel_fm``), including its guard - a
  candidate whose next state goes non-finite or reaches |z| >= 1e7 costs
  +inf;
* ``backward_oracle``: ``riccati_backward`` over ``jax.jacfwd`` stage
  derivatives, the solver's XLA backward pass.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.controllers.mpc.controllers import initial_carry as j_initial_carry
from vehicle_control_tpu.environment.track import Track as JTrack
from vehicle_control_tpu.solvers.al_ilqr import _al_penalty, rollout as j_rollout
from vehicle_control_tpu.solvers.riccati import riccati_backward as j_riccati
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.environment.track import Track as TTrack
from vehicle_control_tpu_torch.utils.config import load_config, project_root

F64 = torch.float64

# One intra-op thread per test process: the suite runs in several xdist
# workers at once, and torch's default of one thread per core would
# oversubscribe the cores that the JAX tests beside it are timed on.
torch.set_num_threads(1)


def config_path(rel):
    return os.path.join(project_root(), "configs", rel)


def singletrack_cfg(horizon, loader=load_config):
    cfg = loader(config_path("controllers/singletrack.yaml"))
    cfg["obstacles"] = False
    cfg["horizon"] = horizon
    return cfg


def cascaded_cfg(horizon, horizon_pm, loader=load_config):
    """The paper's cascade (cascaded.yaml) cut to N single-track and M
    point-mass stages."""
    cfg = loader(config_path("controllers/cascaded.yaml"))
    cfg["obstacles"] = False
    cfg["horizon"] = horizon
    cfg["horizon_pm"] = horizon_pm
    return cfg


_TRACKS = {}


def tracks(name="ippodromo"):
    """(JAX Track, torch Track) of one track, built once per process."""
    if name not in _TRACKS:
        rel = f"environment/{name}.yaml"
        _TRACKS[name] = (
            JTrack(j_load_config(config_path(rel))),
            TTrack(load_config(config_path(rel))),
        )
    return _TRACKS[name]


def problems(horizon, dtype_j=jnp.float64, dtype_t=F64, horizon_pm=0):
    """The singletrack problem at ``horizon`` on both sides or, with
    ``horizon_pm``, the cascade of ``horizon`` + ``horizon_pm`` stages."""
    jt, tt = tracks()
    if horizon_pm:
        tail, cfgs = "pm", (cascaded_cfg(horizon, horizon_pm, j_load_config),
                            cascaded_cfg(horizon, horizon_pm))
    else:
        tail, cfgs = "none", (singletrack_cfg(horizon, j_load_config), singletrack_cfg(horizon))
    jprob = jproblems.build_cascaded_problem(
        j_load_config(config_path("models/dynamic_car.yaml")), jt, cfgs[0], tail, dtype_j,
    )
    tprob = tproblems.build_cascaded_problem(
        load_config(config_path("models/dynamic_car.yaml")), tt, cfgs[1], tail, dtype_t, "cpu",
    )
    return jprob, tprob


def t(a):
    """numpy/JAX array -> float64 torch tensor."""
    return torch.tensor(np.asarray(a), dtype=F64)


def solver_inputs(jprob, B, seed=0):
    """Rolled-out states of random controls from bench-like drops (JAX
    side), with random multipliers: (X, U, lam, mu, rho, params, z0) as
    numpy arrays (params a HorizonParams of arrays)."""
    rng = np.random.default_rng(seed)
    H, nz, nu, nc = jprob.horizon, jprob.nz, jprob.nu, jprob.nc
    z0 = np.zeros((B, nz - 2))
    z0[:, 0] = 5.0 + rng.uniform(0, 8, B)
    z0[:, 4] = rng.uniform(0, 250, B)
    z0[:, 5] = rng.uniform(-1, 1, B)
    U = rng.normal(size=(B, H, nu)) * 0.05
    c0 = j_initial_carry(jprob, jnp.float64)
    pv, zv = jax.vmap(jprob.init_horizon, in_axes=(0, None, None))(
        jnp.asarray(z0), c0.X_pred, c0.U_pred
    )
    X = jax.vmap(lambda p_, z_, u_: j_rollout(jprob.fns, p_, z_, u_)[0])(pv, zv, jnp.asarray(U))
    lam = np.abs(rng.normal(size=(B, H, nc)) * 0.1)
    mu = np.full((B,), 10.0)
    rho = np.full((B,), 1e-4)
    params = jproblems.HorizonParams(np.asarray(pv.curvature), np.asarray(pv.ds))
    return np.asarray(X), U, lam, mu, rho, params, np.asarray(zv)


def linesearch_oracle(jprob, alphas, Xref, Uref, kff, Kfb, lam, mu, params, z0):
    """(A, B) line-search costs from the JAX problem's public callbacks."""
    fns, H = jprob.fns, jprob.horizon

    def fwd_one(alpha, Xr, Ur, kf, Kf, lm, m, pp, zz):
        def fstep(carry, n):
            z, acc = carry
            u = jnp.clip(
                Ur[n] + alpha * kf[n] + Kf[n] @ (z - Xr[n]), jprob.u_lo[n], jprob.u_hi[n]
            )
            cost = fns.stage_cost(n, z, u, pp) + _al_penalty(
                fns.constraints(n, z, u, pp), lm[n], m
            )
            z2 = fns.dynamics(n, z, u, pp)
            ok = jnp.all(jnp.isfinite(z2) & (jnp.abs(z2) < 1e7))
            return (z2, jnp.where(ok, acc + cost, jnp.inf)), None

        (_, tot), _ = jax.lax.scan(fstep, (zz, jnp.zeros(())), jnp.arange(H))
        return jnp.where(jnp.isfinite(tot), tot, jnp.inf)

    f = jax.vmap(
        jax.vmap(fwd_one, in_axes=(0,) + (None,) * 8), in_axes=(None,) + (0,) * 8
    )
    pv = jproblems.HorizonParams(jnp.asarray(params.curvature), jnp.asarray(params.ds))
    args = [jnp.asarray(a) for a in (Xref, Uref, kff, Kfb, lam, mu)]
    return np.asarray(f(jnp.asarray(alphas), *args, pv, jnp.asarray(z0))).T


def backward_oracle(jprob, X, U, lam, mu, rho, params, derivs=None):
    """riccati_backward over jacfwd stage derivatives (``derivs_oracle``'s,
    or ``derivs`` where the caller has them), per scenario."""
    nz = jprob.nz
    g, Hw, J = derivs_oracle(jprob, X, U, lam, mu, params) if derivs is None else derivs

    def one(g1, Hw1, J1, rho1):
        Hs = 0.5 * (Hw1 + jnp.swapaxes(Hw1, -1, -2))
        return j_riccati(g1[:, :nz], g1[:, nz:], Hs[:, :nz, :nz], Hs[:, nz:, :nz],
                         Hs[:, nz:, nz:], J1[:, :, :nz], J1[:, :, nz:], rho1, 1)

    out = jax.jit(jax.vmap(one))(*[jnp.asarray(a) for a in (g, Hw, J, rho)])
    return tuple(np.asarray(a) for a in out)


def derivs_oracle(jprob, X, U, lam, mu, params):
    """(g, Hw, J) per (scenario, stage) from JAX autodiff of the problem's
    public callbacks: jax.grad and jax.jacfwd(jax.grad) of the AL stage cost
    (Hw unsymmetrized) and jax.jacfwd of the dynamics, over w = (z, u)."""
    fns, H, nz = jprob.fns, jprob.horizon, jprob.nz
    ns = jnp.arange(H)

    def stage(n, z, u, lam_n, m, pp):
        w = jnp.concatenate([z, u])

        def cost_fn(ww):
            c = fns.constraints(n, ww[:nz], ww[nz:], pp)
            return fns.stage_cost(n, ww[:nz], ww[nz:], pp) + _al_penalty(c, lam_n, m)

        J = jax.jacfwd(lambda ww: fns.dynamics(n, ww[:nz], ww[nz:], pp))(w)
        return jax.grad(cost_fn)(w), jax.jacfwd(jax.grad(cost_fn))(w), J

    def one(X1, U1, lam1, mu1, k1, ds1):
        pp = jproblems.HorizonParams(k1, ds1)
        return jax.vmap(lambda n, z, u, l: stage(n, z, u, l, mu1, pp))(ns, X1, U1, lam1)

    out = jax.jit(jax.vmap(one))(
        *[jnp.asarray(a) for a in (X, U, lam, mu, params.curvature, params.ds)]
    )
    return tuple(np.asarray(a) for a in out)
