"""Dynamic point-mass model: the low-fidelity long-horizon tail of the
cascaded MPC (counterpart of vehicle_control_tpu/models/point_mass.py).

State  (ns=5): V, s, ey, epsi, t
Action (na=2): Fx, Fy

The point mass shares the dynamic car's parameters.  Discretization is
explicit Euler.  The stateful ``DynamicPointMass`` comes with the simulators.
"""

from __future__ import annotations

import torch

from vehicle_control_tpu_torch.models import dynamic_car as dc
from vehicle_control_tpu_torch.utils.integrators import euler
from vehicle_control_tpu_torch.utils.math import safe_div

PointMassParams = dc.DynamicCarParams


def Fz_f(V, Fx, p: PointMassParams):
    """Front normal load, as the dynamic car's."""
    return dc.Fz_f(V, Fx, p)


def Fz_r(V, Fx, p: PointMassParams):
    return dc.Fz_r(V, Fx, p)


def temporal_ode(x, u, k, p: PointMassParams):
    """Temporal point-mass dynamics on (..., 5) states and (..., 2) actions."""
    V, s, ey, epsi, t = x.unbind(-1)
    Fx, Fy = u[..., 0], u[..., 1]
    Fd = p.Frr + p.Cd * V**2
    V_dot = (Fx - Fd) / p.m
    s_dot = (V * torch.cos(epsi)) / (1.0 - k * ey)
    ey_dot = V * torch.sin(epsi)
    epsi_dot = Fy / (p.m * torch.where(torch.abs(V) > 1e-3, V, 1e-3)) - k * s_dot
    return torch.stack([V_dot, s_dot, ey_dot, epsi_dot, torch.ones_like(V)], dim=-1)


def spatial_ode(x, u, k, p: PointMassParams):
    """Spatial point-mass dynamics: d/ds = d/dt / s_dot, s' = 1 exactly."""
    xdot = temporal_ode(x, u, k, p)
    s_dot = xdot[..., 1]
    prime = xdot * safe_div(1.0, s_dot, eps=1e-3).unsqueeze(-1)
    prime[..., 1] = 1.0
    return prime


def make_transitions(p: PointMassParams):
    """Discrete transitions (temporal, spatial), both explicit Euler."""
    temporal = euler(lambda x, u, k: temporal_ode(x, u, k, p))
    spatial = euler(lambda x, u, k: spatial_ode(x, u, k, p))
    return temporal, spatial
