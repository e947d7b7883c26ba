"""MPC steps and the stateful controllers (counterpart of
vehicle_control_tpu/controllers/mpc/controllers.py).

``step(carry, state) -> (carry', action, info)`` on a batch: the carry is
the warm start (previous predictions and AL multipliers), shifted one stage
forward after every solve; a lane whose solve diverged is reset to the
problem's cold-start guess.  The solver config's flags pick the kernels
(``_kernels``).  ``make_parity_step`` is the reference-parity step (the
unshifted warm start).  ``CascadedMPC``, ``SingleTrackMPC``,
``CascadedKinematicMPC`` and ``KinematicMPC`` give the reference's
``controller.command(state)`` API over a batch of one, on the whole-solve
route (``controller_solver_config``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from vehicle_control_tpu_torch.controllers.base import Controller
from vehicle_control_tpu_torch.controllers.mpc import problems
from vehicle_control_tpu_torch.controllers.mpc.problems import MPCProblem
from vehicle_control_tpu_torch.environment import track as track_mod
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, build_solver
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import BackwardKernelFM
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import DerivsKernelFM
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import LinesearchKernelFM
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM
from vehicle_control_tpu_torch.utils.device import DEFAULT_DEVICE, default_dtype


class MPCCarry(NamedTuple):
    """Warm-start state threaded between control steps."""

    X_pred: torch.Tensor  # (B, H, nz) previous predicted trajectory
    U_pred: torch.Tensor  # (B, H, nu) previous controls (solver scale)
    lam: torch.Tensor  # (B, H, nc) AL multipliers


class MPCInfo(NamedTuple):
    cost: torch.Tensor
    violation: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    X_pred: torch.Tensor  # (B, H, nz) predicted states


def _solver_config(cfg) -> ALILQRConfig:
    """Read optional solver hyper-parameters from the controller YAML."""
    s = cfg.get("solver", None) or {}
    return ALILQRConfig(
        n_outer=int(s.get("n_outer", 3)),
        n_inner=int(s.get("n_inner", 8)),
        n_polish=int(s.get("n_polish", 0)),
        polish_mu_boost=float(s.get("polish_mu_boost", 1.0)),
        n_alpha=int(s.get("n_alpha", 8)),
        mu0=float(s.get("mu0", 10.0)),
        mu_scale=float(s.get("mu_scale", 10.0)),
        tol_con=float(s.get("tol_con", 1e-3)),
        tol_cost=float(s.get("tol_cost", 1e-7)),
        recover_viol=float(s.get("recover_viol", 5.0)),
    )


def controller_solver_config(cfg) -> ALILQRConfig:
    """The controller YAML's budget (``_solver_config``) on the whole-solve
    route: kernel 3, one launch a solve, on the card; its plain version
    (``solve_plain``) on the CPU."""
    return dataclasses.replace(_solver_config(cfg), use_solve_kernel=True)


def _shift(a):
    """Receding-horizon shift one stage forward, repeating the last stage."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _kernels(problem: MPCProblem, solver_cfg: ALILQRConfig) -> dict:
    """The kernel wrappers the config's flags pick, as build_solver's keywords.

    ``use_solve_kernel``: kernel 3 alone; else ``use_derivs_kernel``: kernel 4
    (then the torch Riccati sweep) with kernel 1; else kernels 1 and 2.  The
    port has no autodiff route, so ``use_ls_kernel`` and
    ``use_backward_kernel`` pick nothing the default does not.
    """
    fam = problem.family
    if solver_cfg.use_solve_kernel:
        return dict(solve_kernel=SolveKernelFM(fam, solver_cfg))
    ls_kernel = LinesearchKernelFM(fam, solver_cfg.alphas())
    if solver_cfg.use_derivs_kernel:
        return dict(ls_kernel=ls_kernel, derivs_kernel=DerivsKernelFM(fam))
    return dict(ls_kernel=ls_kernel, backward_kernel=BackwardKernelFM(fam))


def make_mpc_step(problem: MPCProblem, solver_cfg: ALILQRConfig, kernels=None):
    """Build the batched per-control-step function.

    ``kernels``: the kernel wrappers as ``build_solver``'s keywords; by
    default those the config's flags pick (``_kernels``).  The returned
    ``step`` carries ``step.kernels``: the kernel wrappers it launches, whose
    ``launches`` count them.

    Warns, as the JAX package's step does, when the problem is not f32 and
    lives on a device where the kernels run (any but the CPU, whose tensors
    take the plain versions in their own dtype): the CUDA kernels compute in
    f32 and refuse other inputs.
    """
    if problem.u_scale.device.type != "cpu" and problem.u_scale.dtype != torch.float32:
        warnings.warn(
            "the CUDA kernels compute in float32 and refuse a "
            f"{problem.u_scale.dtype} problem on {problem.u_scale.device}; build the "
            "problem with dtype=torch.float32 for the card (the CPU runs the kernels' "
            "plain versions in any dtype)",
            stacklevel=2,
        )
    if kernels is None:
        kernels = _kernels(problem, solver_cfg)
    solve = build_solver(
        problem.fns, problem.horizon, solver_cfg, problem.u_lo, problem.u_hi, **kernels
    )

    def step(carry: MPCCarry, state):
        params, z0 = problem.init_horizon(state, carry.X_pred, carry.U_pred)
        sol = solve(params, z0, carry.U_pred, carry.lam)
        action = sol.U[:, 0] * problem.u_scale[0]
        new_carry = MPCCarry(_shift(sol.X), _shift(sol.U), _shift(sol.lam))
        if solver_cfg.recover_viol > 0.0:
            # a diverged lane would poison its warm start for good: reset it
            # to the cold-start guess and command that guess's first control
            broken = (
                ~torch.isfinite(sol.cost)
                | ~torch.isfinite(sol.violation)
                | (sol.violation > solver_cfg.recover_viol)
            )
            Xw, Uw = problem.warm_start(state)
            lane = broken[:, None, None]
            new_carry = MPCCarry(
                torch.where(lane, Xw.to(sol.X.dtype), new_carry.X_pred),
                torch.where(lane, Uw.to(sol.U.dtype), new_carry.U_pred),
                torch.where(lane, 0.0, new_carry.lam),
            )
            action = torch.where(broken[:, None], Uw[:, 0] * problem.u_scale[0], action)
        info = MPCInfo(sol.cost, sol.violation, sol.converged, sol.iterations, sol.X)
        return new_carry, action, info

    step.kernels = tuple(kernels.values())
    return step


def parity_solver_config(n_outer=12, n_inner=40, n_polish=12) -> ALILQRConfig:
    """Solve-to-optimality configuration for reference-parity measurement:
    large fixed iteration counts with per-lane convergence freezing and tight
    tolerances (the reference solves every step to IPOPT's tolerance).
    Offline use only."""
    return ALILQRConfig(
        n_outer=n_outer,
        n_inner=n_inner,
        n_polish=n_polish,
        n_alpha=12,
        mu_max=1e10,
        tol_con=1e-8,
        tol_cost=1e-12,
        recover_viol=0.0,
    )


def make_parity_step(problem: MPCProblem, solver_cfg=None):
    """The parity-measurement step: like :func:`make_mpc_step` but with the
    reference's UNSHIFTED warm start (the previous solution seeds the next
    solve as it is) and no recovery.  The kernels are those the config's
    flags pick: for the parity config kernels 1 and 2 (their plain versions
    on the CPU)."""
    cfg = solver_cfg or parity_solver_config()
    kernels = _kernels(problem, cfg)
    solve = build_solver(problem.fns, problem.horizon, cfg, problem.u_lo, problem.u_hi,
                         **kernels)

    def step(carry: MPCCarry, state):
        params, z0 = problem.init_horizon(state, carry.X_pred, carry.U_pred)
        sol = solve(params, z0, carry.U_pred, carry.lam)
        action = sol.U[:, 0] * problem.u_scale[0]
        info = MPCInfo(sol.cost, sol.violation, sol.converged, sol.iterations, sol.X)
        return MPCCarry(sol.X, sol.U, sol.lam), action, info

    step.kernels = tuple(kernels.values())
    return step


def initial_carry(problem: MPCProblem, dtype=None) -> MPCCarry:
    """The standing-start warm start of one scenario: (H, ...) tensors."""
    X0, U0 = problem.initial_prediction()
    if dtype is not None:
        X0, U0 = X0.to(dtype), U0.to(dtype)
    return MPCCarry(X0, U0, X0.new_zeros(problem.horizon, problem.nc))


class _MPCBase(Controller):
    """Stateful wrapper over a batch of one: the reference Controller API
    (command, state_prediction, action_prediction, reset)."""

    def __init__(self, problem: MPCProblem, cfg, track):
        super().__init__()
        self.config = cfg
        self.track = track
        self.problem = problem
        self.dtype, self.device = problem.u_scale.dtype, problem.u_scale.device
        self._track_data = track.data.to(self.device, self.dtype)
        self._step = make_mpc_step(problem, controller_solver_config(cfg))
        self.reset()
        self.last_info: MPCInfo | None = None

    def command(self, state):
        """One control step: the first optimal action (physical units), (nu,)."""
        state = torch.as_tensor(state, dtype=self.dtype, device=self.device).reshape(-1)
        state = state[: self.problem.ns_model]
        pad = self.problem.nz - 2 - state.shape[0]
        if pad > 0:
            state = torch.cat([state, state.new_zeros(pad)])
        self._carry, action, info = self._step(self._carry, state[None])
        self.last_info = info
        return action[0]

    @property
    def state_prediction(self):
        """(H, ns_model) predicted physical states."""
        return self._carry.X_pred[0, :, : self.problem.ns_model]

    @property
    def action_prediction(self):
        """(H, nu) predicted physical actions."""
        return self._carry.U_pred[0] * self.problem.u_scale

    def reset(self):
        self._carry = MPCCarry(*(a[None] for a in initial_carry(self.problem)))


class CascadedMPC(_MPCBase):
    """Single-track + point-mass cascaded MPC (``cascaded.yaml``).  On the
    card in f32 unless the caller asks for another device or dtype."""

    def __init__(self, car_config, track, cfg, dtype=None, device=DEFAULT_DEVICE):
        dtype = dtype or default_dtype(device)
        problem = problems.build_cascaded_problem(car_config, track, cfg, "pm", dtype, device)
        super().__init__(problem, cfg, track)
        self.N = int(cfg["horizon"])

    def get_state_prediction(self):
        """Global-frame (x, y, psi) of the predicted trajectory, (H, 3): the
        single-track rows' (s, ey, epsi) are fields 4-6, the point-mass
        rows' 1-3."""
        X, N = self._carry.X_pred[0], self.N
        rows = [(X[:N, 4], X[:N, 5], X[:N, 6])]
        if self.problem.horizon > N:
            rows.append((X[N:, 1], X[N:, 2], X[N:, 3]))
        xs, ys, psis = (torch.cat(c) for c in zip(*(
            track_mod.rel2glob(self._track_data, *r) for r in rows)))
        return torch.stack([xs, ys, psis], dim=-1)


class SingleTrackMPC(CascadedMPC):
    """Single-track-only MPC: the ``singletrack.yaml`` (M = 0) configuration
    of CascadedMPC."""


class CascadedKinematicMPC(_MPCBase):
    """Single-track + kinematic-tail cascaded MPC (``cascaded_kinematic.yaml``,
    ``tail="kc"``).  On the card in f32 unless the caller asks for another
    device or dtype."""

    def __init__(self, car_config, track, cfg, dtype=None, device=DEFAULT_DEVICE):
        dtype = dtype or default_dtype(device)
        problem = problems.build_cascaded_problem(car_config, track, cfg, "kc", dtype, device)
        super().__init__(problem, cfg, track)
        self.N = int(cfg["horizon"])

    def get_state_prediction(self):
        """Global-frame (x, y, psi) of the predicted trajectory, (H, 3): the
        single-track rows' (s, ey, epsi) are fields 4-6, the kinematic
        rows' 2-4."""
        X, N = self._carry.X_pred[0], self.N
        rows = [(X[:N, 4], X[:N, 5], X[:N, 6])]
        if self.problem.horizon > N:
            rows.append((X[N:, 2], X[N:, 3], X[N:, 4]))
        xs, ys, psis = (torch.cat(c) for c in zip(*(
            track_mod.rel2glob(self._track_data, *r) for r in rows)))
        return torch.stack([xs, ys, psis], dim=-1)


class KinematicMPC(_MPCBase):
    """Pure kinematic-bicycle MPC (``kinematic.yaml``).  On the card in f32
    unless the caller asks for another device or dtype."""

    def __init__(self, car_config, track, cfg, dtype=None, device=DEFAULT_DEVICE):
        dtype = dtype or default_dtype(device)
        problem = problems.build_kinematic_problem(car_config, track, cfg, dtype, device)
        super().__init__(problem, cfg, track)

    def _frenet_indices(self):
        return 2, 3, 4

    def get_state_prediction(self):
        """Global-frame (x, y, psi) of the predicted trajectory, (H, 3)."""
        X = self.state_prediction
        s, ey, epsi = (X[:, i] for i in self._frenet_indices())
        return torch.stack(track_mod.rel2glob(self._track_data, s, ey, epsi), dim=-1)
