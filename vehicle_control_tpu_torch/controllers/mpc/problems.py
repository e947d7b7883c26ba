"""MPC problem construction (counterpart of vehicle_control_tpu/controllers/mpc/problems.py).

``build_cascaded_problem`` turns the controller YAML into batched problem
callbacks for the AL-iLQR solver.  The port covers ``tail="none"``, the
single-track family (``configs/controllers/singletrack.yaml``); the other
tails and obstacles raise ``NotImplementedError``.

The callbacks are the family's field-wise closures (solvers.fm_family)
applied to batch-first tensors: the solver state is z = [x(8), u_prev(2)]
so the Fx slew cost is a Markov stage cost, forces are solved in kN
(FORCE_SCALE), the dynamics are the regularized spatial RK4 step with the
steering stop (``_sat_col``) and the softplus-floored 1/s_dot, and the
stage-0 state-only constraint rows are masked.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vehicle_control_tpu_torch.environment import track as track_mod
from vehicle_control_tpu_torch.solvers.al_ilqr import OCPFunctions
from vehicle_control_tpu_torch.solvers.fm_family import FMFamily, build_cascaded_family
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
    init_horizon: Callable  # (state0 (B,8), X_prev, U_prev) -> (params, z0 (B, nz))
    initial_prediction: Callable  # () -> (X0 (H, nz), U0 (H, nu))
    ns_model: int
    u_lo: torch.Tensor  # (H, nu) rollout control box, solver units
    u_hi: torch.Tensor
    warm_start: Callable  # (state0 (B, 8)) -> (X_pred, U_pred) cold-start guess
    family: FMFamily


def _fields(z, u):
    return tuple(z.unbind(-1)) + tuple(u.unbind(-1))


def build_cascaded_problem(
    car_config, track: "track_mod.Track", cfg, tail: str = "none",
    dtype=torch.float64, device=DEFAULT_DEVICE,
) -> MPCProblem:
    """Single-track MPC problem on ``device`` in ``dtype`` (tail="none").

    The card is the default; without CUDA that raises, and the caller asks
    for ``device="cpu"`` (where the kernels' plain versions run)."""
    device = require_device(device)
    family = build_cascaded_family(car_config, cfg, tail)  # raises past tail="none"
    track_data = track.data.to(device=device, dtype=dtype)
    p = family.params
    N = H = family.H
    nz, nu, nc = family.NZ, family.NU, family.NC
    mpc_dt = float(cfg["mpc_dt"])
    kw = dict(dtype=dtype, device=device)

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

    u_scale = torch.ones(H, nu, **kw)
    u_scale[:, 0] = FORCE_SCALE

    def init_horizon(state0, X_prev, U_prev):
        """Warm-started ds/curvature horizon from the previous prediction."""
        ds_st = mpc_dt * X_prev[:, :N, 0]
        s_traj = torch.cumsum(ds_st, dim=1) - ds_st[:, :1] + state0[:, 4:5]
        k_st = track_mod.curvature(track_data, s_traj)
        z0 = torch.cat([state0, state0.new_zeros(state0.shape[0], 2)], dim=1)
        return HorizonParams(curvature=k_st, ds=ds_st), z0

    def initial_prediction():
        X0 = torch.ones(H, nz, **kw)
        X0[:, 0] = 4.0
        return X0, torch.zeros(H, nu, **kw)

    def warm_start(state0):
        """Speed-consistent cold-start guess for scenarios dropped mid-track:
        Ux held, Fx = drag."""
        Ux0 = torch.clamp_min(state0[:, 0], 1.0)
        X0 = torch.ones(state0.shape[0], H, nz, **kw)
        X0[:, :, 0] = Ux0[:, None]
        U0 = torch.zeros(state0.shape[0], H, nu, **kw)
        U0[:, :, 0] = ((p.Frr + p.Cd * Ux0**2) / FORCE_SCALE)[:, None]
        return X0, U0

    u_lo = torch.empty(H, nu, **kw)
    u_hi = torch.empty(H, nu, **kw)
    for j in range(nu):
        lo, hi = family.u_box(0, j)
        u_lo[:, j], u_hi[:, j] = lo, hi

    fns = OCPFunctions(dynamics, stage_cost, constraints)
    return MPCProblem(
        fns, H, nz, nu, nc, u_scale, init_horizon, initial_prediction, 8,
        u_lo, u_hi, warm_start, family,
    )
