"""Scenario batching (counterpart of vehicle_control_tpu/parallel/batch.py).

The solver is batch-first, so the batched entry points need no ``vmap``:
they build the carries of a batch and the closed-loop step of B MPC solves
plus B plant steps.
"""

from __future__ import annotations

import numpy as np
import torch

from vehicle_control_tpu_torch.controllers.mpc.controllers import (
    MPCCarry,
    initial_carry,
    make_mpc_step,
)
from vehicle_control_tpu_torch.environment import track as track_mod


def tile_carry(problem, batch: int, dtype=None) -> MPCCarry:
    """Broadcast the standing-start carry across a scenario batch."""
    c = initial_carry(problem, dtype)
    return MPCCarry(*(a.expand((batch,) + a.shape).contiguous() for a in c))


def aligned_carry(problem, states, dtype=None) -> MPCCarry:
    """State-aligned warm-start carries for scenarios dropped mid-track
    (the problem's speed-consistent cold-start guess)."""
    X0, U0 = problem.warm_start(states)
    if dtype is not None:
        X0, U0 = X0.to(dtype), U0.to(dtype)
    return MPCCarry(X0, U0, X0.new_zeros(X0.shape[0], problem.horizon, problem.nc))


def make_batched_racing_step(problem, solver_cfg, transition, track_data, dt, s_index,
                             kernels=None):
    """One batched closed-loop step: B MPC solves + B plant steps.

    ``step(carries, states) -> (carries', next_states, actions, infos)``;
    ``track_data`` must be on the states' device.  ``kernels``: as
    ``make_mpc_step``'s.  ``step.kernels`` are the MPC step's kernel wrappers.
    """
    mpc_step = make_mpc_step(problem, solver_cfg, kernels)

    def step(carry, state):
        mc, action, info = mpc_step(carry, state)
        k = track_mod.curvature(track_data, state[:, s_index])
        return mc, transition(state, action, k, dt), action, info

    step.kernels = mpc_step.kernels
    return step


def initial_states(track_length: float, B: int, rng: np.random.Generator) -> np.ndarray:
    """The throughput bench's scenario drop for the dynamic car (bench.py's
    ``initial_states``, no obstacles): uniform s along the lap, ey in
    [-1, 1], Ux in [6, 14]; (B, 8) float64."""
    states = np.zeros((B, 8), np.float64)
    states[:, 4] = rng.uniform(0, float(track_length), B)
    states[:, 5] = rng.uniform(-1.0, 1.0, B)
    states[:, 0] = 6.0 + rng.uniform(0, 8, B)
    return states
