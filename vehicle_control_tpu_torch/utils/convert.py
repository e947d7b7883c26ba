"""Carry the JAX package's state across to the port.

The JAX package's objects reach this module as numpy arrays (``np.asarray``
of each field), so the port never imports JAX.  Each function returns the
port's counterpart on ``device`` in ``dtype``, so that both packages compute
from identical numbers.  The device is the card unless the caller asks for
another; without CUDA the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from vehicle_control_tpu_torch.controllers.mpc.controllers import MPCCarry
from vehicle_control_tpu_torch.environment.track import TrackData
from vehicle_control_tpu_torch.models.dynamic_car import DynamicCarParams
from vehicle_control_tpu_torch.utils.device import DEFAULT_DEVICE, require_device


def tensor(a, device=DEFAULT_DEVICE, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=require_device(device))


def track_data(
    fields: Mapping[str, np.ndarray], device=DEFAULT_DEVICE, dtype=torch.float64
) -> TrackData:
    """TrackData from the JAX TrackData's arrays (extra fields are ignored)."""
    return TrackData(
        **{
            f.name: tensor(fields[f.name], device, dtype)
            for f in dataclasses.fields(TrackData)
        }
    )


def car_params(fields: Mapping[str, np.ndarray]) -> DynamicCarParams:
    """DynamicCarParams from the JAX dataclass's (scalar) fields."""
    return DynamicCarParams(
        **{f.name: float(fields[f.name]) for f in dataclasses.fields(DynamicCarParams)}
    )


def mpc_carry(X_pred, U_pred, lam, device=DEFAULT_DEVICE, dtype=torch.float64) -> MPCCarry:
    """MPCCarry from (B, H, nz), (B, H, nu) and (B, H, nc) arrays."""
    return MPCCarry(*(tensor(a, device, dtype) for a in (X_pred, U_pred, lam)))


def plant_states(states, device=DEFAULT_DEVICE, dtype=torch.float64) -> torch.Tensor:
    """(B, ns) plant states."""
    return tensor(states, device, dtype)
