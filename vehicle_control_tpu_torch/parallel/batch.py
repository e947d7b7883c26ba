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


def initial_states(track_length: float, B: int, rng: np.random.Generator,
                   obstacles=None, ns: int = 8) -> np.ndarray:
    """The throughput bench's scenario drop (bench.py's ``initial_states``):
    uniform s along the lap, ey in [-1, 1], and the speed: for the dynamic
    car (``ns`` = 8) Ux in [6, 14] at fields (s, ey) = (4, 5); for the
    kinematic car (``ns`` = 6) v in [2, 8] at (2, 3); (B, ns) float64.  With
    ``obstacles`` (the track's (n_obs, 5) table: cx, cy, s, ey, radius),
    bench.py's ``avoid_obstacles``: a drop within radius + 2 of a disc's
    centre in the (s, ey) plane is an infeasible start, so those drops are
    drawn again, up to 50 rounds."""
    if ns not in (6, 8):
        raise ValueError(f"ns = {ns}: the dynamic car has 8 fields, the kinematic car 6")
    states = np.zeros((B, ns), np.float64)
    s_i, ey_i = (4, 5) if ns == 8 else (2, 3)
    s = rng.uniform(0, float(track_length), B)
    ey = rng.uniform(-1.0, 1.0, B)
    if obstacles is not None:
        obs = np.asarray(obstacles, np.float64)
        for _ in range(50):
            bad = np.zeros(B, bool)
            for o in obs:
                d = np.sqrt((s - o[2]) ** 2 + (ey - o[3]) ** 2)
                bad |= d < (o[4] + 2.0)
            if not bad.any():
                break
            s[bad] = rng.uniform(0, float(track_length), int(bad.sum()))
            ey[bad] = rng.uniform(-1.0, 1.0, int(bad.sum()))
    states[:, s_i] = s
    states[:, ey_i] = ey
    if ns == 8:
        states[:, 0] = 6.0 + rng.uniform(0, 8, B)
    else:
        states[:, 0] = 2.0 + rng.uniform(0, 6, B)
    return states
