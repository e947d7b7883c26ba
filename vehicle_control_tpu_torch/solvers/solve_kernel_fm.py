"""The whole AL-iLQR solve in one launch: kernel 3 of the port (counterpart
of vehicle_control_tpu/solvers/solve_kernel_fm.py).

Per scenario: clamp U, a warm rollout, the outer augmented-Lagrangian loop
(an AL cost sweep, then inner iterations of backward pass, line search over
the whole step ladder, Armijo selection, re-roll of the chosen step and the
rho/done/accepted-count updates; then the multiplier update and the
penalty growth), the polish phase at the boosted penalty, and the final raw
cost, violation and converged flag.  Outputs: X (B, H, NZ), U (B, H, NU),
lam (B, H, NC), cost, violation, converged (bool) and iterations (int32),
each (B,).

:func:`solve_plain` follows the TPU kernel's semantics where they differ
from ``al_ilqr.build_solver``'s loop: the warm rollout stores
``nan_to_num(z)`` but steps the raw z; a candidate is rejected when a *next*
state is non-finite or reaches |z| >= 1e7; the accepted cost is the chosen
candidate's sweep sum, not a recomputation; the re-roll writes X and U only
where a step was accepted on a lane not yet done.  ``early_exit`` (leave the
inner loop once every lane is done) and ``ls_fast_path`` (cost the rest of
the ladder only where alpha=1 fails Armijo on a live lane) change no output
bit: every update after a lane is done is masked, and a lane that accepts
alpha=1 never reads the other candidates' costs.

:class:`SolveKernelFM` launches the CUDA kernel (``csrc/solve_fm.cu``) on
CUDA tensors and runs :func:`solve_plain` on CPU tensors; any other input
raises.
"""

from __future__ import annotations

import ctypes

import torch

from vehicle_control_tpu_torch.solvers import cuda_lib
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import (
    feedback_controls,
    linesearch_costs_plain,
)


def _fields(X, U, n):
    return tuple(X[:, n].unbind(-1)) + tuple(U[:, n].unbind(-1))


def _stage_constraints(family, n, wf):
    """(B, NC): the family's constraints at stage n, constants broadcast."""
    c = family.constraints(n, wf)
    return torch.stack([ci if isinstance(ci, torch.Tensor) else torch.full_like(wf[0], ci)
                        for ci in c], -1)


def solve_plain(family, cfg, z0, U_init, lam_init, curv, ds, trace=False):
    """The plain PyTorch version of kernel 3 (see the module docstring).

    With ``trace`` a dict follows the seven outputs: ``first_alpha`` (B,),
    the step accepted in the lane's first inner iteration (0 where none
    was), and ``inner_runs`` (B,), the inner iterations the lane ran (those
    after it was done only without ``early_exit``).
    """
    NZ, NU, H = family.NZ, family.NU, family.H
    B = z0.shape[0]
    kw = dict(dtype=z0.dtype, device=z0.device)
    alphas = cfg.alphas()
    A = len(alphas)
    al = torch.tensor(alphas, **kw)[:, None]
    al2 = torch.tensor([a * a for a in alphas], **kw)[:, None]
    ds_read = lambda i: ds[:, i]  # noqa: E731

    U = torch.stack([torch.stack([torch.clamp(U_init[:, n, j], *family.u_box(n, j))
                                  for j in range(NU)], -1) for n in range(H)], 1)
    lam = lam_init.clone()
    X = torch.empty(B, H, NZ, **kw)
    z = list(z0.unbind(-1))
    for n in range(H):  # warm rollout: store nan_to_num(z), step the raw z
        X[:, n] = torch.nan_to_num(torch.stack(z, -1), nan=0.0, posinf=1e6, neginf=-1e6)
        z = list(family.dyn(n, tuple(z) + tuple(U[:, n].unbind(-1)), curv[:, n], ds_read))

    rho = torch.full((B,), cfg.rho0, **kw)
    n_acc = torch.zeros(B, dtype=torch.int32, device=z0.device)
    runs = torch.zeros(B, dtype=torch.int32, device=z0.device)
    first_alpha = None

    def reroll(alpha_sel, upd, kff, Kfb):
        """Roll the chosen step; write X and U on the lanes in ``upd``."""
        z = list(z0.unbind(-1))
        lane = upd[:, None]
        for n in range(H):
            u = feedback_controls(family, n, z, alpha_sel, X, U, kff, Kfb)
            wf = tuple(z) + tuple(u)
            nxt = family.dyn(n, wf, curv[:, n], ds_read)
            X[:, n] = torch.where(lane, torch.stack(z, -1), X[:, n])
            U[:, n] = torch.where(lane, torch.stack(u, -1), U[:, n])
            z = list(nxt)

    def armijo_ok(a, costs_a, cost_al, dV1, dV2, fail):
        expected = -(al[a] * dV1 + al2[a] * dV2)
        improvement = cost_al - costs_a
        model_sane = expected <= torch.abs(cost_al) + 1.0
        ok = (~model_sane) | (improvement > cfg.armijo * torch.clamp_min(expected, 0.0))
        return ok & torch.isfinite(costs_a) & (improvement > 0.0) & ~fail

    def run_inner(mu_val, length):
        nonlocal rho, n_acc, runs, first_alpha
        mu = torch.full((B,), mu_val, **kw)
        cost_al = torch.zeros(B, **kw)
        for n in range(H):
            cost_al = cost_al + family.al_cost(n, _fields(X, U, n), lambda j: lam[:, n, j], mu,
                                               curv[:, n], ds_read)
        done = torch.zeros(B, dtype=torch.bool, device=z0.device)
        for _ in range(length):
            if cfg.early_exit and bool(done.all()):
                break
            runs = runs + (~done if cfg.early_exit else torch.ones_like(done)).to(runs.dtype)
            kff, Kfb, dV1, dV2, fail = backward_plain(family, X, U, lam, mu, rho, curv, ds)
            ls_args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
            costs = linesearch_costs_plain(family, alphas[:1], *ls_args)
            if A > 1:
                need = True
                if cfg.ls_fast_path:
                    ok0 = armijo_ok(0, costs[0], cost_al, dV1, dV2, fail)
                    need = bool((~ok0 & ~done).any())
                rest = (linesearch_costs_plain(family, alphas[1:], *ls_args) if need
                        else torch.full((A - 1, B), torch.inf, **kw))
                costs = torch.cat([costs, rest])
            ok = torch.stack([armijo_ok(a, costs[a], cost_al, dV1, dV2, fail) for a in range(A)])
            any_ok = ok.any(0)
            # the largest accepted step (alphas descend); alphas[0] where none is
            idx = torch.where(ok, torch.arange(A, device=z0.device)[:, None], A).amin(0)
            idx = torch.where(any_ok, idx, 0)
            alpha_sel = al[idx, 0]
            cost_sel = costs.gather(0, idx[None])[0]
            upd = any_ok & ~done
            reroll(alpha_sel, upd, kff, Kfb)
            cost_new = torch.where(any_ok, cost_sel, cost_al)
            rho_new = torch.where(
                any_ok,
                torch.clamp_min(rho / cfg.rho_scale, cfg.rho_min),
                torch.clamp_max(torch.clamp_min(rho, cfg.rho0) * cfg.rho_scale * cfg.rho_scale,
                                cfg.rho_max),
            )
            rel_impr = (cost_al - cost_new) / (torch.abs(cost_al) + 1e-12)
            converged_now = any_ok & (rel_impr < cfg.tol_cost) & (alpha_sel >= 0.99)
            small_grad = ~fail & (-dV1 < cfg.tol_cost * (torch.abs(cost_al) + 1.0))
            stuck = ~any_ok & (rho >= cfg.rho_max)
            if first_alpha is None:
                first_alpha = torch.where(any_ok, alpha_sel, 0.0)
            cost_al = torch.where(done, cost_al, cost_new)
            rho = torch.where(done, rho, rho_new)
            n_acc = n_acc + (~done & any_ok).to(n_acc.dtype)
            done = done | converged_now | small_grad | stuck

    mus = cfg.mu_schedule()
    for k in range(cfg.n_outer):
        run_inner(mus[k], cfg.n_inner)
        mu = torch.full((B,), mus[k], **kw)
        for n in range(H):  # multiplier update at this outer iteration's mu
            c = _stage_constraints(family, n, _fields(X, U, n))
            lam[:, n] = torch.clamp_min(lam[:, n] + mu[:, None] * c, 0.0)
    if cfg.n_polish > 0:
        run_inner(mus[-1], cfg.n_polish)

    cost = torch.zeros(B, **kw)
    viol = torch.zeros(B, **kw)
    for n in range(H):
        wf = _fields(X, U, n)
        cost = cost + family.stage_cost(n, wf, curv[:, n], ds_read)
        viol = torch.maximum(viol, _stage_constraints(family, n, wf).amax(-1))
    viol = torch.clamp_min(viol, 0.0)
    converged = (viol < cfg.tol_con) & torch.isfinite(cost)
    out = (X, U, lam, cost, viol, converged, n_acc)
    if not trace:
        return out
    if first_alpha is None:
        first_alpha = torch.zeros(B, **kw)
    return out + (dict(first_alpha=first_alpha, inner_runs=runs),)


class SolveKernelFM:
    """The whole solve for one family and solver configuration.

    ``launches`` counts the CUDA launches; the plain path does not count.
    """

    def __init__(self, family, cfg):
        if family.NU != 2:
            raise ValueError("the closed-form Quu solve covers 2 controls")
        self.family = family
        self.cfg = cfg
        self.launches = 0
        self._params = cuda_lib.family_params(family)
        self._solve_cfg = cuda_lib.solve_config(cfg)

    def __call__(self, z0, U_init, lam_init, curv, ds, trace=False):
        if z0.device.type == "cpu":
            return solve_plain(self.family, self.cfg, z0, U_init, lam_init, curv, ds, trace)
        if z0.device.type != "cuda":
            raise ValueError(f"no solve kernel for device {z0.device}")
        f = self.family
        B, H, NZ, NU, NC = z0.shape[0], f.H, f.NZ, f.NU, f.NC
        ins = dict(z0=z0, U_init=U_init, lam_init=lam_init, curv=curv, ds=ds)
        shapes = dict(z0=(B, NZ), U_init=(B, H, NU), lam_init=(B, H, NC), curv=(B, H),
                      ds=(B, H))
        cuda_lib.check_inputs(shapes, ins, z0.device)
        lib = cuda_lib.load_library()
        soas = [cuda_lib.soa(t) for t in ins.values()]
        kw = dict(dtype=torch.float32, device=z0.device)
        X = torch.empty(H, NZ, B, **kw)
        U = torch.empty(H, NU, B, **kw)
        lam = torch.empty(H, NC, B, **kw)
        kff = torch.empty(H, NU, B, **kw)  # scratch: the gains of the last backward pass
        kfb = torch.empty(H, NU, NZ, B, **kw)
        stats = torch.empty(cuda_lib.SOLVE_STATS, B, **kw)
        rc = lib.vct_solve_fm(
            self._params.ctypes.data, ctypes.addressof(self._solve_cfg),
            *[t.data_ptr() for t in soas], X.data_ptr(), U.data_ptr(), lam.data_ptr(),
            kff.data_ptr(), kfb.data_ptr(), stats.data_ptr(), B, H,
            torch.cuda.current_stream(z0.device).cuda_stream,
        )
        cuda_lib.check_launch(lib, rc, "solve_fm")
        self.launches += 1
        out = (
            X.movedim(-1, 0).contiguous(), U.movedim(-1, 0).contiguous(),
            lam.movedim(-1, 0).contiguous(), stats[0], stats[1], stats[2] > 0.5,
            stats[3].to(torch.int32),
        )
        if not trace:
            return out
        return out + (dict(first_alpha=stats[4], inner_runs=stats[5].to(torch.int32)),)
