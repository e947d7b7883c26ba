"""The MPC step (counterpart of vehicle_control_tpu/controllers/mpc/controllers.py).

``step(carry, state) -> (carry', action, info)`` on a batch: the carry is
the warm start (previous predictions and AL multipliers), shifted one stage
forward after every solve; a lane whose solve diverged is reset to the
problem's cold-start guess.  The solver config's flags pick the kernels
(``_kernels``).  The stateful ``_MPCBase`` wrappers are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vehicle_control_tpu_torch.controllers.mpc.problems import MPCProblem
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, build_solver
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import BackwardKernelFM
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import DerivsKernelFM
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import LinesearchKernelFM
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import SolveKernelFM


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
    """
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


def initial_carry(problem: MPCProblem, dtype=None) -> MPCCarry:
    """The standing-start warm start of one scenario: (H, ...) tensors."""
    X0, U0 = problem.initial_prediction()
    if dtype is not None:
        X0, U0 = X0.to(dtype), U0.to(dtype)
    return MPCCarry(X0, U0, X0.new_zeros(problem.horizon, problem.nc))
