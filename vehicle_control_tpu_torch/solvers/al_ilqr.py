"""Augmented-Lagrangian iLQR, batch-first (counterpart of
vehicle_control_tpu/solvers/al_ilqr.py).

The outer loop updates PHR multipliers, the inner iLQR loop takes a backward
pass, costs every line-search candidate at once (kernel 1), picks per lane
the largest step that passes Armijo on the quadratic model, and re-rolls
that candidate in PyTorch.  The backward pass is kernel 2 (derivatives +
Riccati in one launch) or, on the derivatives route, kernel 4 (stage
derivatives) followed by the torch Riccati sweep.  Every scenario is a
lane: ``mu``, ``rho``, ``done`` and the accepted-step count are (B,)
tensors and every update is masked per lane.  Iteration counts are fixed;
nothing exits early.

With a whole-solve kernel (kernel 3, ``solve_kernel_fm``) the solve is one
call to it and none of the loop above runs in torch.  Iteration traces and
the parallel Riccati are not ported yet.

Problem form (all shapes static, stage index n a Python int):

    minimize   sum_n  stage_cost(n, z_n, u_n, params)
    subject to z_{n+1} = dynamics(n, z_n, u_n, params)     n = 0..H-2
               constraints(n, z_n, u_n, params) <= 0       n = 0..H-1
               z_0 fixed
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from vehicle_control_tpu_torch.solvers.riccati import riccati_from_derivs


class OCPFunctions(NamedTuple):
    """Batched problem callbacks: each takes the stage index ``n`` (int), the
    augmented state ``z`` (B, nz), the control ``u`` (B, nu) and the
    parameters."""

    dynamics: Callable  # -> z_next (B, nz)
    stage_cost: Callable  # -> (B,)
    constraints: Callable  # -> (B, nc), c <= 0 feasible


@dataclasses.dataclass(frozen=True)
class ALILQRConfig:
    """Solver hyper-parameters (the JAX package's defaults)."""

    n_outer: int = 4  # augmented-Lagrangian multiplier updates
    n_inner: int = 10  # iLQR iterations per outer loop
    n_polish: int = 0  # iLQR iterations after the final multiplier update
    polish_mu_boost: float = 1.0  # penalty factor for the polish phase
    n_alpha: int = 8  # parallel line-search candidates
    alpha_min: float = 1e-3  # smallest candidate step
    mu0: float = 10.0  # initial penalty
    mu_scale: float = 10.0  # penalty growth per outer iteration
    mu_max: float = 1e8
    rho0: float = 1e-6  # initial LM regularization
    rho_scale: float = 10.0
    rho_min: float = 1e-8
    rho_max: float = 1e10
    tol_cost: float = 1e-7  # relative cost-decrease convergence tol
    tol_con: float = 1e-4  # constraint-violation tolerance
    armijo: float = 1e-4
    # kernel routes, read by make_mpc_step (the port has no autodiff route:
    # with none of them set it takes kernels 1 + 2)
    use_ls_kernel: bool = False  # line-search costs kernel
    use_derivs_kernel: bool = False  # stage-derivatives kernel + torch Riccati
    use_backward_kernel: bool = False  # fused derivatives + Riccati kernel
    use_solve_kernel: bool = False  # the whole solve in one kernel launch
    ls_fast_path: bool = False  # solve kernel: sweep alpha=1 first and the
    # rest of the ladder only where it fails Armijo (bitwise-identical)
    early_exit: bool = True  # solve kernel: a lane leaves the inner loop
    # once it is done (bitwise-identical: every later update is masked)
    recover_viol: float = 5.0  # make_mpc_step's per-lane reset threshold (0: off)

    def alphas(self):
        """Line-search candidates: geometric ladder from 1 down to alpha_min."""
        return [self.alpha_min ** (i / (self.n_alpha - 1)) for i in range(self.n_alpha)]

    def mu_schedule(self):
        """The penalty of each outer iteration, then the polish phase's."""
        mus, mu = [], self.mu0
        for _ in range(self.n_outer):
            mus.append(mu)
            mu = min(mu * self.mu_scale, self.mu_max)
        return mus + [min(mu * self.polish_mu_boost, self.mu_max)]


class Solution(NamedTuple):
    X: torch.Tensor  # (B, H, nz) state trajectory
    U: torch.Tensor  # (B, H, nu) control trajectory
    lam: torch.Tensor  # (B, H, nc) final AL multipliers
    cost: torch.Tensor  # (B,) raw objective (no penalty)
    violation: torch.Tensor  # (B,) max constraint violation
    converged: torch.Tensor  # (B,) bool
    iterations: torch.Tensor  # (B,) int32 accepted inner steps


def _al_penalty(c, lam, mu):
    """PHR penalty per lane: c, lam (B, nc); mu (B,)."""
    lam_hat = torch.clamp_min(lam + mu[:, None] * c, 0.0)
    return ((lam_hat**2).sum(-1) - (lam**2).sum(-1)) / (2.0 * mu)


def _n_constraints(fns: OCPFunctions, z0, U, params) -> int:
    return fns.constraints(0, z0, U[:, 0], params).shape[-1]


def rollout(fns: OCPFunctions, params, z0, U):
    """Open-loop rollout of U (B, H, nu) from z0 (B, nz); returns (X, cost)."""
    z, total, Xs = z0, 0.0, []
    for n in range(U.shape[1]):
        Xs.append(z)
        total = total + fns.stage_cost(n, z, U[:, n], params)
        z = fns.dynamics(n, z, U[:, n], params)
    return torch.stack(Xs, 1), total


def build_solver(fns: OCPFunctions, horizon: int, config: ALILQRConfig, u_lo, u_hi,
                 ls_kernel=None, backward_kernel=None, derivs_kernel=None,
                 solve_kernel=None):
    """Return ``solve(params, z0, U_init, lam_init) -> Solution``.

    ``u_lo``/``u_hi`` (H, nu): control boxes projected in every rollout;
    ``params`` carries ``curvature`` and ``ds`` (B, H).  The kernels'
    wrappers:

    * ``solve_kernel(z0, U_init, lam_init, curv, ds) -> (X, U, lam, cost,
      violation, converged, iterations)``: the whole solve; with it no other
      kernel is used;
    * else ``ls_kernel(Xref, Uref, kff, Kfb, lam, mu, curv, ds, z0) -> (A,
      B)`` with either ``derivs_kernel(X, U, lam, mu, curv, ds) -> (g, Hw,
      J)`` (then the torch Riccati sweep) or ``backward_kernel(X, U, lam,
      mu, rho, curv, ds) -> (kff, Kfb, dV1, dV2, fail)``.
    """
    cfg = config
    H = horizon
    alpha_list = cfg.alphas()

    if solve_kernel is not None:

        def solve_in_one_launch(params, z0, U_init, lam_init=None):
            if lam_init is None:
                nc = _n_constraints(fns, z0, U_init, params)
                lam_init = U_init.new_zeros(U_init.shape[0], H, nc)
            return Solution(*solve_kernel(z0, U_init, lam_init, params.curvature, params.ds))

        return solve_in_one_launch
    if ls_kernel is None or (derivs_kernel is None) == (backward_kernel is None):
        raise ValueError("give a solve kernel, or a line-search kernel with one of the "
                         "derivatives and backward kernels")

    def backward_pass(X, U, lam, mu, rho, params):
        if backward_kernel is not None:
            return backward_kernel(X, U, lam, mu, rho, params.curvature, params.ds)
        g, Hw, Jm = derivs_kernel(X, U, lam, mu, params.curvature, params.ds)
        return riccati_from_derivs(X.shape[-1], g, Hw, Jm, rho)

    def clamp_u(n, u):
        return torch.clamp(u, u_lo[n], u_hi[n])

    def stage_al(n, z, u, lam_n, mu, params):
        return fns.stage_cost(n, z, u, params) + _al_penalty(
            fns.constraints(n, z, u, params), lam_n, mu
        )

    def total_al_cost(X, U, lam, mu, params):
        acc = 0.0
        for n in range(H):
            acc = acc + stage_al(n, X[:, n], U[:, n], lam[:, n], mu, params)
        return acc

    def all_constraints(X, U, params):
        return torch.stack([fns.constraints(n, X[:, n], U[:, n], params) for n in range(H)], 1)

    def forward(alpha, Xref, Uref, kffs, Kfbs, lam, mu, params, z0):
        """Closed-loop rollout of one candidate per lane, alpha (B,)."""
        z, acc, Xs, Us = z0, 0.0, [], []
        for n in range(H):
            fb = (Kfbs[:, n] @ (z - Xref[:, n]).unsqueeze(-1)).squeeze(-1)
            u = clamp_u(n, Uref[:, n] + alpha[:, None] * kffs[:, n] + fb)
            acc = acc + stage_al(n, z, u, lam[:, n], mu, params)
            Xs.append(z)
            Us.append(u)
            z = fns.dynamics(n, z, u, params)
        X, U = torch.stack(Xs, 1), torch.stack(Us, 1)
        # reject divergent rollouts even if their cost happens to be finite
        diverged = ~torch.isfinite(X).all(-1).all(-1) | (X.abs().amax((1, 2)) > 1e7)
        return X, U, torch.where(torch.isfinite(acc) & ~diverged, acc, torch.inf)

    def inner_step(state, lam, mu, params, z0):
        X, U, cost_al, rho, done, n_acc = state
        alphas = torch.as_tensor(alpha_list, dtype=U.dtype, device=U.device)
        kffs, Kfbs, dV1, dV2, bp_fail = backward_pass(X, U, lam, mu, rho, params)
        costs = ls_kernel(X, U, kffs, Kfbs, lam, mu, params.curvature, params.ds, z0).T
        expected = -(alphas * dV1[:, None] + alphas**2 * dV2[:, None])
        improvement = cost_al[:, None] - costs
        # Armijo on the quadratic model, unless the model's predicted
        # decrease exceeds the whole current cost (garbage expansion): then
        # plain descent is accepted
        model_sane = expected <= torch.abs(cost_al)[:, None] + 1.0
        ok = (~model_sane) | (improvement > cfg.armijo * torch.clamp_min(expected, 0.0))
        ok = ok & torch.isfinite(costs) & (improvement > 0.0) & (~bp_fail)[:, None]
        any_ok = ok.any(-1)
        # the largest accepted step (alphas descend); 0 where none is accepted
        steps = torch.arange(len(alpha_list), device=U.device)
        idx = torch.where(ok, steps, len(alpha_list)).amin(-1)
        idx = torch.where(any_ok, idx, 0)
        alpha_sel = alphas[idx]
        # the kernel gives costs only: re-roll the selected candidate
        Xs, Us, cost_sel = forward(alpha_sel, X, U, kffs, Kfbs, lam, mu, params, z0)
        lane = any_ok[:, None, None]
        X_new = torch.where(lane, Xs, X)
        U_new = torch.where(lane, Us, U)
        cost_new = torch.where(any_ok, cost_sel, cost_al)
        # asymmetric LM schedule: climb fast on failure, relax slowly
        rho_new = torch.where(
            any_ok,
            torch.clamp_min(rho / cfg.rho_scale, cfg.rho_min),
            torch.clamp_max(torch.clamp_min(rho, cfg.rho0) * cfg.rho_scale**2, cfg.rho_max),
        )
        rel_impr = (cost_al - cost_new) / (torch.abs(cost_al) + 1e-12)
        converged_now = any_ok & (rel_impr < cfg.tol_cost) & (alpha_sel >= 0.99)
        small_grad = (~bp_fail) & (-dV1 < cfg.tol_cost * (torch.abs(cost_al) + 1.0))
        stuck = (~any_ok) & (rho >= cfg.rho_max)
        done_new = done | converged_now | small_grad | stuck
        # a lane that is done keeps its results (the work still runs)
        frozen = done[:, None, None]
        X = torch.where(frozen, X, X_new)
        U = torch.where(frozen, U, U_new)
        cost_al = torch.where(done, cost_al, cost_new)
        rho = torch.where(done, rho, rho_new)
        n_acc = n_acc + (~(done | ~any_ok)).to(n_acc.dtype)
        return X, U, cost_al, rho, done_new, n_acc

    def inner_loop(X, U, lam, mu, rho, n_acc, params, z0, iters):
        cost_al = total_al_cost(X, U, lam, mu, params)
        done = torch.zeros_like(cost_al, dtype=torch.bool)
        state = (X, U, cost_al, rho, done, n_acc)
        for _ in range(iters):
            state = inner_step(state, lam, mu, params, z0)
        X, U, _, rho, _, n_acc = state
        return X, U, rho, n_acc

    def solve(params, z0, U_init, lam_init=None):
        B = z0.shape[0]
        kw = dict(dtype=U_init.dtype, device=U_init.device)
        if lam_init is None:
            lam_init = torch.zeros(B, H, _n_constraints(fns, z0, U_init, params), **kw)
        lam = lam_init
        mu = torch.full((B,), cfg.mu0, **kw)
        rho = torch.full((B,), cfg.rho0, **kw)
        n_acc = torch.zeros(B, dtype=torch.int32, device=U_init.device)
        U = torch.clamp(U_init, u_lo, u_hi)
        X, _ = rollout(fns, params, z0, U)
        # a divergent warm-start rollout must not poison the derivatives
        X = torch.nan_to_num(X, nan=0.0, posinf=1e6, neginf=-1e6)
        for _ in range(cfg.n_outer):
            X, U, rho, n_acc = inner_loop(X, U, lam, mu, rho, n_acc, params, z0, cfg.n_inner)
            lam = torch.clamp_min(lam + mu[:, None, None] * all_constraints(X, U, params), 0.0)
            mu = torch.clamp_max(mu * cfg.mu_scale, cfg.mu_max)
        if cfg.n_polish > 0:
            # optimize against the final multipliers, optionally boosted
            mu_p = torch.clamp_max(mu * cfg.polish_mu_boost, cfg.mu_max)
            X, U, rho, n_acc = inner_loop(X, U, lam, mu_p, rho, n_acc, params, z0, cfg.n_polish)
        cost = sum(fns.stage_cost(n, X[:, n], U[:, n], params) for n in range(H))
        violation = torch.clamp_min(all_constraints(X, U, params).amax((1, 2)), 0.0)
        converged = (violation < cfg.tol_con) & torch.isfinite(cost)
        return Solution(X, U, lam, cost, violation, converged, n_acc)

    return solve
