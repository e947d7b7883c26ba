"""Kinematic bicycle in Frenet coordinates (counterpart of
vehicle_control_tpu/models/kinematic_car.py).

State  (ns=6): v, delta, s, ey, epsi, t
Action (na=2): a, w

Both the temporal and the spatial forms are explicit Euler steps.  The
stateful ``KinematicCar`` steps one car on a track, on the CPU in float64.
"""

from __future__ import annotations

import dataclasses

import torch

from vehicle_control_tpu_torch.utils.integrators import euler
from vehicle_control_tpu_torch.utils.math import safe_div, tan
from vehicle_control_tpu_torch.utils.structs import VectorSpec

STATE = VectorSpec("kinematic_car_state", ["v", "delta", "s", "ey", "epsi", "t"])
ACTION = VectorSpec("kinematic_car_action", ["a", "w"], [r"$a$", r"$\omega$"])


@dataclasses.dataclass(frozen=True)
class KinematicCarParams:
    l: float  # wheelbase (configs/models/kinematic_car.yaml)

    @classmethod
    def from_config(cls, config) -> "KinematicCarParams":
        return cls(l=float(config["car"]["l"]))


def temporal_ode(x, u, k, p: KinematicCarParams):
    """Temporal kinematic dynamics on (..., 6) states and (..., 2) actions."""
    v, delta, s, ey, epsi, t = x.unbind(-1)
    a, w = u[..., 0], u[..., 1]
    s_dot = (v * torch.cos(epsi)) / (1.0 - ey * k)
    ey_dot = v * torch.sin(epsi)
    epsi_dot = v * tan(delta) / p.l - s_dot * k
    return torch.stack([a, w, s_dot, ey_dot, epsi_dot, torch.ones_like(v)], dim=-1)


def spatial_ode(x, u, k, p: KinematicCarParams):
    """Spatial kinematic dynamics: temporal_ode / s_dot with s' = 1, the
    division guarded at 1e-3 (``safe_div``)."""
    v, delta, s, ey, epsi, t = x.unbind(-1)
    a, w = u[..., 0], u[..., 1]
    dt_ds = safe_div(1.0 - ey * k, v * torch.cos(epsi), eps=1e-3)
    ey_prime = (1.0 - ey * k) * tan(epsi)
    epsi_prime = tan(delta) / p.l * safe_div(1.0 - ey * k, torch.cos(epsi)) - k
    return torch.stack([dt_ds * a, dt_ds * w, torch.ones_like(v), ey_prime, epsi_prime, dt_ds],
                       dim=-1)


def make_transitions(p: KinematicCarParams):
    """Discrete transitions (temporal, spatial), both explicit Euler."""
    temporal = euler(lambda x, u, k: temporal_ode(x, u, k, p))
    spatial = euler(lambda x, u, k: spatial_ode(x, u, k, p))
    return temporal, spatial


class KinematicCar:
    """One kinematic car on a track: ``drive(action)`` steps its state by
    the temporal Euler transition over the config's dt."""

    state_spec = STATE
    action_spec = ACTION

    def __init__(self, config, track=None):
        self.config = config
        self.track = track
        self.dt = float(config["dt"])
        self.params = KinematicCarParams.from_config(config)
        self.transition, self.spatial_transition = make_transitions(self.params)
        self.state = torch.zeros(len(STATE), dtype=torch.float64)
        self.input = torch.zeros(len(ACTION), dtype=torch.float64)

    def drive(self, action):
        from vehicle_control_tpu_torch.environment import track as track_mod

        k = track_mod.curvature(self.track.data, STATE.get(self.state, "s"))
        action = torch.as_tensor(action, dtype=self.state.dtype)
        self.state = self.transition(self.state, action, k, self.dt)
        self.input = action
        return self.state

    def rel2glob(self, state):
        from vehicle_control_tpu_torch.environment import track as track_mod

        return track_mod.rel2glob(self.track.data, STATE.get(state, "s"),
                                  STATE.get(state, "ey"), STATE.get(state, "epsi"))
