"""MPC problem construction (counterpart of vehicle_control_tpu/controllers/mpc/problems.py).

``build_cascaded_problem`` turns the controller YAML into batched problem
callbacks for the AL-iLQR solver.  The port covers ``tail="none"``, the
single-track family (``configs/controllers/singletrack.yaml``), and
``tail="pm"``, the paper's cascade of N single-track stages and M
point-mass stages (``configs/controllers/cascaded.yaml``), both with or
without the obstacle barrier (``cfg["obstacles"]``: a cost term over the
track's discs, ``_obstacle_barrier``), and ``tail="kc"``, N single-track
stages and a kinematic-bicycle tail of ``horizon_kc`` stages
(``configs/controllers/cascaded_kinematic.yaml``), without obstacles (the
kc tail's own barrier is not ported: with obstacles it raises
``NotImplementedError``).  ``build_kinematic_problem`` is the pure kinematic
bicycle (``configs/controllers/kinematic.yaml``, H = N + 1 stages).

The callbacks are the family's field-wise closures (solvers.fm_family)
applied to batch-first tensors: the solver state is z = [x(8), u_prev(2)]
so the slew costs are Markov stage costs, forces are solved in kN
(FORCE_SCALE), the dynamics are the regularized spatial RK4 step with the
steering stop (``_sat_col``) and the softplus-floored 1/s_dot (then the
seam and the point-mass or kinematic Euler step for ``tail="pm"`` or
``"kc"``), and the stage-0 state-only constraint rows are masked.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vehicle_control_tpu_torch.environment import track as track_mod
from vehicle_control_tpu_torch.solvers.al_ilqr import OCPFunctions
from vehicle_control_tpu_torch.solvers.fm_family import (  # noqa: F401  OBSTACLE_EPS: JAX's name
    OBSTACLE_EPS,
    FMFamily,
    _obstacles_std,
    build_cascaded_family,
    build_kinematic_family,
)
from vehicle_control_tpu_torch.utils.device import DEFAULT_DEVICE, require_device

FORCE_SCALE = 1000.0  # solve forces in kN


class HorizonParams(NamedTuple):
    """Per-step stage parameters: curvature and arc-step, (B, H) each."""

    curvature: torch.Tensor
    ds: torch.Tensor


class MPCProblem(NamedTuple):
    fns: OCPFunctions
    horizon: int  # solver horizon H
    nz: int
    nu: int
    nc: int
    u_scale: torch.Tensor  # (H, nu): physical = scaled * u_scale
    init_horizon: Callable  # (state0 (B, ns), X_prev, U_prev) -> (params, z0 (B, nz))
    initial_prediction: Callable  # () -> (X0 (H, nz), U0 (H, nu))
    ns_model: int
    u_lo: torch.Tensor  # (H, nu) rollout control box, solver units
    u_hi: torch.Tensor
    warm_start: Callable  # (state0 (B, ns)) -> (X_pred, U_pred) cold-start guess
    family: FMFamily


def _obstacle_barrier(obstacles, s, ey, ds, w):
    """sum_i w ds / max(dist_i - (r_i + 0.1), OBSTACLE_EPS) over the discs
    of ``obstacles`` ((n_obs, 5): cx, cy, s, ey, radius), dist_i the (s,
    ey)-plane distance to disc i's centre: the barrier that the family's
    stage costs add (``fm_family._obstacles_std``, which this calls)."""
    rows = tuple((o[2], o[3], o[4]) for o in torch.as_tensor(obstacles).tolist())
    return _obstacles_std(rows, torch.as_tensor(s), torch.as_tensor(ey), torch.as_tensor(ds), w)


def _fields(z, u):
    return tuple(z.unbind(-1)) + tuple(u.unbind(-1))


def _callbacks(family: FMFamily) -> OCPFunctions:
    """The solver's batched callbacks over the family's field-wise closures."""

    def _stage(params, n):
        return params.curvature[:, n], lambda i: params.ds[:, i]

    def dynamics(n, z, u, params):
        kv, ds_read = _stage(params, n)
        return torch.stack(family.dyn(n, _fields(z, u), kv, ds_read), dim=-1)

    def stage_cost(n, z, u, params):
        kv, ds_read = _stage(params, n)
        return family.stage_cost(n, _fields(z, u), kv, ds_read)

    def constraints(n, z, u, params):
        c = family.constraints(n, _fields(z, u))
        return torch.stack(
            [ci if isinstance(ci, torch.Tensor) else torch.full_like(z[..., 0], ci) for ci in c],
            dim=-1,
        )

    return OCPFunctions(dynamics, stage_cost, constraints)


def _u_boxes(family: FMFamily, **kw):
    """The rollout control boxes (u_lo, u_hi), (H, nu) each, stage by stage
    (solver units)."""
    u_lo = torch.empty(family.H, family.NU, **kw)
    u_hi = torch.empty(family.H, family.NU, **kw)
    for n in range(family.H):
        for j in range(family.NU):
            u_lo[n, j], u_hi[n, j] = family.u_box(n, j)
    return u_lo, u_hi


def build_cascaded_problem(
    car_config, track: "track_mod.Track", cfg, tail: str = "none",
    dtype=torch.float64, device=DEFAULT_DEVICE,
) -> MPCProblem:
    """The cascaded MPC problem (``tail`` "none", "pm" or "kc") on
    ``device`` in ``dtype``.

    The card is the default; without CUDA that raises, and the caller asks
    for ``device="cpu"`` (where the kernels' plain versions run)."""
    device = require_device(device)
    family = build_cascaded_family(car_config, cfg, tail, track.data)  # kc with obstacles raises
    track_data = track.data.to(device=device, dtype=dtype)
    p = family.params
    H, N = family.H, family.N
    M = H - N
    pm, kc = family.tail == "pm", family.tail == "kc"
    ds_pm = float(cfg["ds_pm"]) if pm else 0.0
    mpc_dt_kc = float(cfg["mpc_dt_kc"]) if kc else 0.0
    nz, nu, nc = family.NZ, family.NU, family.NC
    mpc_dt = float(cfg["mpc_dt"])
    kw = dict(dtype=dtype, device=device)

    u_scale = torch.ones(H, nu, **kw)
    u_scale[:, 0] = FORCE_SCALE  # Fx in kN at every stage
    if pm:
        u_scale[N:, 1] = FORCE_SCALE  # Fy in kN on the point-mass stages

    def init_horizon(state0, X_prev, U_prev):
        """Warm-started ds/curvature horizon from the previous prediction:
        single-track steps of mpc_dt at the predicted speed, then point-mass
        steps of ds_pm, or kinematic steps of mpc_dt_kc at the tail's
        predicted speed."""
        ds_st = mpc_dt * X_prev[:, :N, 0]
        s_traj = torch.cumsum(ds_st, dim=1) - ds_st[:, :1] + state0[:, 4:5]
        k_st = track_mod.curvature(track_data, s_traj)
        z0 = torch.cat([state0, state0.new_zeros(state0.shape[0], 2)], dim=1)
        if not (pm or kc):
            return HorizonParams(curvature=k_st, ds=ds_st), z0
        if pm:
            ds_tail = torch.full((state0.shape[0], M), ds_pm, dtype=ds_st.dtype,
                                 device=ds_st.device)
        else:
            ds_tail = mpc_dt_kc * X_prev[:, N:H, 0]
        s_tail = torch.cumsum(ds_tail, dim=1) - ds_st[:, -1:] + s_traj[:, -1:]
        k_tail = track_mod.curvature(track_data, s_tail)
        params = HorizonParams(curvature=torch.cat([k_st, k_tail], 1),
                               ds=torch.cat([ds_st, ds_tail], 1))
        return params, z0

    def initial_prediction():
        X0 = torch.ones(H, nz, **kw)
        X0[:, 0] = 4.0
        return X0, torch.zeros(H, nu, **kw)

    def warm_start(state0):
        """Speed-consistent cold-start guess for scenarios dropped mid-track:
        Ux held, Fx = drag, on the point-mass stages the curvature
        feed-forward Fy = m Ux^2 k, on the kinematic tail a = 0 (holds the
        speed)."""
        Ux0 = torch.clamp_min(state0[:, 0], 1.0)
        X0 = torch.ones(state0.shape[0], H, nz, **kw)
        X0[:, :, 0] = Ux0[:, None]
        U0 = torch.zeros(state0.shape[0], H, nu, **kw)
        U0[:, :, 0] = ((p.Frr + p.Cd * Ux0**2) / FORCE_SCALE)[:, None]
        if pm:
            steps = torch.arange(N, **kw)
            s_st_last = state0[:, 4] + mpc_dt * Ux0 * steps[-1]
            s_tail = s_st_last[:, None] + ds_pm * torch.arange(1, M + 1, **kw)
            k_tail = track_mod.curvature(track_data, s_tail)
            U0[:, N:, 1] = p.m * Ux0[:, None] ** 2 * k_tail / FORCE_SCALE
        elif kc:
            U0[:, N:, 0] = 0.0
        return X0, U0

    u_lo, u_hi = _u_boxes(family, **kw)
    return MPCProblem(
        _callbacks(family), H, nz, nu, nc, u_scale, init_horizon, initial_prediction, 8,
        u_lo, u_hi, warm_start, family,
    )


def build_kinematic_problem(
    car_config, track: "track_mod.Track", cfg, dtype=torch.float64, device=DEFAULT_DEVICE,
) -> MPCProblem:
    """The pure kinematic MPC problem (``kinematic.yaml``: N running stages
    and the terminal stage, H = N + 1) on ``device`` in ``dtype``; the
    controls (a, w) are solved in physical units.

    The card is the default; without CUDA that raises, and the caller asks
    for ``device="cpu"``."""
    device = require_device(device)
    family = build_kinematic_family(car_config, cfg, track.data)
    track_data = track.data.to(device=device, dtype=dtype)
    H, N = family.H, family.N
    nz, nu, nc = family.NZ, family.NU, family.NC
    mpc_dt = float(cfg["mpc_dt"])
    kw = dict(dtype=dtype, device=device)

    def init_horizon(state0, X_prev, U_prev):
        """The ds/curvature horizon from the previous prediction's speeds,
        with the reference's off-by-one: stage n's ds is mpc_dt v_n + 0.5,
        while the arc positions the curvature is read at start from s0 with
        a zero first step; the terminal stage repeats stage N-1's."""
        ds_traj = mpc_dt * X_prev[:, :, 0] + 0.5  # (B, H)
        steps = torch.cat([torch.zeros_like(ds_traj[:, :1]), ds_traj[:, 1:]], dim=1)
        s_traj = torch.cumsum(steps, dim=1) + state0[:, 2:3]
        k_param = track_mod.curvature(track_data, s_traj[:, :N])
        ds_param = ds_traj[:, :N]
        params = HorizonParams(curvature=torch.cat([k_param, k_param[:, -1:]], 1),
                               ds=torch.cat([ds_param, ds_param[:, -1:]], 1))
        z0 = torch.cat([state0, state0.new_zeros(state0.shape[0], 2)], dim=1)
        return params, z0

    def initial_prediction():
        """The reference's standing-start seed: zeros with v = 0.1."""
        X0 = torch.zeros(H, nz, **kw)
        X0[:, 0] = 0.1
        return X0, torch.zeros(H, nu, **kw)

    def warm_start(state0):
        """Speed-aligned cold-start guess: v held at max(v0, 0.1)."""
        X0 = torch.zeros(state0.shape[0], H, nz, **kw)
        X0[:, :, 0] = torch.clamp_min(state0[:, 0], 0.1)[:, None]
        return X0, torch.zeros(state0.shape[0], H, nu, **kw)

    u_lo, u_hi = _u_boxes(family, **kw)
    return MPCProblem(
        _callbacks(family), H, nz, nu, nc, torch.ones(H, nu, **kw), init_horizon,
        initial_prediction, 6, u_lo, u_hi, warm_start, family,
    )
