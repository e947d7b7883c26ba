"""Field-wise single-track physics shared by the solver and its kernels
(counterpart of vehicle_control_tpu/solvers/fm_singletrack.py).

A state is a list of 8 per-field tensors (any common shape, e.g. (B,) or
(A, B)) or :class:`~..utils.jet.Jet`\\ s.  On tensors these functions give
values; on jets, exact derivatives.  ``csrc/singletrack.cuh`` transcribes
them for the CUDA kernels.

Where the JAX package writes the RK4 Jacobian out by hand
(``spatial_prime_jac`` / ``rk4_step_jac``), the port differentiates the one
``rk4_step`` expression with first-order jets: the same derivatives,
including the guards' conventions (clip ties at 0.5, the selected branch of
each where, |x|' = 1 at 0, the softplus floor's logistic slope), with no
second copy of the physics to keep in step.
"""

from __future__ import annotations

import torch

from vehicle_control_tpu_torch.models import dynamic_car as dc
from vehicle_control_tpu_torch.utils import jet as J
from vehicle_control_tpu_torch.utils.jet import Jet
from vehicle_control_tpu_torch.utils.math import arctan, safe_div, tan

FORCE_SCALE = 1000.0

# solver-side regularization of the spatial single-track dynamics: state
# clamps (Ux, delta, ey, epsi) and the softplus floor on s_dot
CLAMPS = {0: (1.0, 1e3), 3: (-1.0, 1.0), 5: (-8.0, 8.0), 6: (-1.3, 1.3)}
FLOOR, BETA = 0.3, 10.0


def _ones(x):
    return torch.ones_like(J.val(x))


def temporal_fields(x, Fx, wact, k, p):
    """The 8 d(state)/dt fields (models.dynamic_car.temporal_ode)."""
    Ux, Uy, r, delta, s, ey, epsi, t = x
    fxf = dc.Fx_f(Fx, p)
    fxr = dc.Fx_r(Fx, p)
    fyf = dc.Fy_f(Ux, Uy, r, delta, Fx, p)
    fyr = dc.Fy_r(Ux, Uy, r, delta, Fx, p)
    Fd = dc.drag(Ux, p)
    cd = J.cos(delta)
    sd = J.sin(delta)
    Ux_dot = (fxf * cd - fyf * sd + fxr - Fd) / p.m + r * Uy
    Uy_dot = (fyf * cd + fxf * sd + fyr) / p.m - r * Ux
    r_dot = (p.a * (fyf * cd + fxf * sd) - p.b * fyr) / p.Izz
    s_dot = (Ux * J.cos(epsi) - Uy * J.sin(epsi)) / (1.0 - k * ey)
    ey_dot = Ux * J.sin(epsi) + Uy * J.cos(epsi)
    epsi_dot = r - k * s_dot
    return [Ux_dot, Uy_dot, r_dot, wact, s_dot, ey_dot, epsi_dot, _ones(s_dot)]


def spatial_prime(x, Fx, wact, k, p):
    """d(state)/ds of the clamped state, with the softplus-floored 1/s_dot."""
    x = list(x)
    for i, (lo, hi) in CLAMPS.items():
        x[i] = J.clip(x[i], lo, hi)
    xdot = temporal_fields(x, Fx, wact, k, p)
    s_dot = xdot[4]
    inv = 1.0 / (FLOOR + J.softplus0(BETA * (s_dot - FLOOR)) / BETA)
    return [
        xdot[0] * inv,
        xdot[1] * inv,
        xdot[2] * inv,
        xdot[3] * inv,
        _ones(s_dot),
        xdot[5] * inv,
        xdot[6] * inv,
        inv,
    ]


def rk4_step(x, Fx, wact, k, h, p):
    k1 = spatial_prime(x, Fx, wact, k, p)
    k2 = spatial_prime([a + 0.5 * h * b for a, b in zip(x, k1)], Fx, wact, k, p)
    k3 = spatial_prime([a + 0.5 * h * b for a, b in zip(x, k2)], Fx, wact, k, p)
    k4 = spatial_prime([a + h * b for a, b in zip(x, k3)], Fx, wact, k, p)
    return [
        a + h * (b1 + 2.0 * b2 + 2.0 * b3 + b4) / 6.0
        for a, b1, b2, b3, b4 in zip(x, k1, k2, k3, k4)
    ]


def _clipg(x, lo, hi):
    """d(clip(x, lo, hi))/dx with JAX's 0.5-at-tie convention (min o max)."""
    m = torch.clamp_min(x, lo)
    gl = (x > lo).to(x.dtype) + 0.5 * (x == lo).to(x.dtype)
    gh = (m < hi).to(x.dtype) + 0.5 * (m == hi).to(x.dtype)
    return gl * gh


def dcol(x, c):
    """Column c of a jet's first derivatives; zero for a constant field."""
    if isinstance(x, Jet):
        return x.d[..., c]
    return torch.zeros_like(x)


def spatial_prime_jac(x, Fx, wact, k, p):
    """``spatial_prime`` and its dense Jacobian.

    Returns ``(prime, Jm)``: ``Jm`` is (..., 8, 10), rows the 8 primes,
    columns the 8 (unclamped) state fields, then Fx, then wact.
    """
    seeds = Jet.seed(list(x) + [Fx, wact])
    prime = spatial_prime(seeds[:8], seeds[8], seeds[9], k, p)
    vals = [J.val(q) for q in prime]
    Jm = torch.stack(
        [torch.stack([dcol(q, c) + 0.0 * vals[0] for c in range(10)], -1) for q in prime], -2
    )
    return vals, Jm


# tangent columns of rk4_step_jac: Ux, Uy, r, delta, ey, epsi (state fields
# 0, 1, 2, 3, 5, 6), then Fx and wact; s and t are structurally trivial
RK4_COLS = (0, 1, 2, 3, 5, 6)


def rk4_step_jac(x, Fx, wact, k, h, p):
    """``rk4_step`` and its tangent columns.

    Returns ``(next8, T)``: ``T`` is (..., 8, 8) with ``T[..., i, c]`` =
    d(next_i)/d(column c), columns ``(Ux, Uy, r, delta, ey, epsi, Fx, wact)``
    as in the JAX package.
    """
    seeds = Jet.seed([x[i] for i in RK4_COLS] + [Fx, wact])
    xs = list(x)
    for c, i in enumerate(RK4_COLS):
        xs[i] = seeds[c]
    nxt = rk4_step(xs, seeds[6], seeds[7], k, h, p)
    vals = [J.val(q) for q in nxt]
    T = torch.stack(
        [torch.stack([dcol(q, c) + 0.0 * vals[0] for c in range(8)], -1) for q in nxt], -2
    )
    return vals, T


# -- costs and constraints ----------------------------------------------------


def boundary_fields(ey, dsn, wb, lo, hi):
    """Soft road-bound penalty (problems._boundary)."""
    eyv = J.val(ey)
    below = J.where(eyv < lo, (ey - lo) ** 2, 0.0)
    above = J.where(eyv > hi, (ey - hi) ** 2, 0.0)
    return wb * dsn * (below + above)


def slip_penalty_fields(x, Fx, p, w_slip):
    """Soft slip-angle penalty (problems._slip_penalty)."""
    Ux, Uy, r, delta = x[0], x[1], x[2], x[3]
    ta_f = J.abs(tan(dc.alpha_f(Ux, Uy, r, delta, p)))
    tam_f = tan(dc.alphamod_f(Fx, Ux, p))
    ta_r = J.abs(tan(dc.alpha_r(Ux, Uy, r, delta, p)))
    tam_r = tan(dc.alphamod_r(Fx, Ux, p))
    return w_slip * (
        J.where(J.val(ta_f) >= J.val(tam_f), (ta_f - tam_f) ** 2, 0.0)
        + J.where(J.val(ta_r) >= J.val(tam_r), (ta_r - tam_r) ** 2, 0.0)
    )


def st_running_cost_fields(n, x, Fx, wact, Fx_prev, dsn, ds_prev, p, w, cs, N):
    """Single-track running cost at stage n (problems.st_cost, no obstacles)."""
    ey = x[5]
    cost = boundary_fields(ey, dsn, w["boundary"], cs["ey_min"], cs["ey_max"])
    cost = cost + w["deviation_st"] * dsn * ey**2
    cost = cost + w["w"] * wact**2
    cost = cost + slip_penalty_fields(x, Fx, p, w["slip"])
    if 1 <= n < N:  # Fx slew against the previous action
        cost = cost + (w["Fx"] / ds_prev) * (Fx - Fx_prev) ** 2
    return cost


def term_cost_fields(speed, ey, epsi, t, w, cs):
    """Terminal cost folded into stage H-1 (problems.term_cost), on the
    fields of the model that is live there."""
    over = J.where(J.val(speed) >= cs["max_speed"], (speed - cs["max_speed"]) ** 2, 0.0)
    return w["speed"] * over + w["time"] * t + w["ey"] * ey**2 + w["epsi"] * epsi**2


def seam_fields(x, Fx, p):
    """The handoff from the single-track state to the point mass at stage
    N-1 (problems.build_cascaded_problem's seam): V, s, ey, beta + epsi, t
    and the lateral-force stash Fy_f + Fy_r that the switching cost reads.
    ``x`` is the raw (unclamped) state, ``Fx`` the stage's drive force in N."""
    Ux, Uy, r, delta, s, ey, epsi, t = x
    V = J.sqrt(Ux**2 + Uy**2)
    beta = arctan(safe_div(Uy, Ux))
    fy_tot = dc.Fy_f(Ux, Uy, r, delta, Fx, p) + dc.Fy_r(Ux, Uy, r, delta, Fx, p)
    return [V, s, ey, beta + epsi, t, fy_tot]


def constraint_fields(x, Fx, wact, p, ci, cs):
    """The 10 single-track stage constraints, c <= 0 feasible
    (problems._st_constraints): Ux floor, delta box (2), engine power,
    w box (2), friction front (2), friction rear (2); forces in kN."""
    fs = 1.0 / FORCE_SCALE
    Ux, Uy, r, delta, s, ey, epsi, t = x
    bound_f = p.mu_f * dc.Fz_f(Ux, Fx, p) * J.cos(dc.alpha_f(Ux, Uy, r, delta, p))
    bound_r = p.mu_r * dc.Fz_r(Ux, Fx, p) * J.cos(dc.alpha_r(Ux, Uy, r, delta, p))
    fxf = dc.Fx_f(Fx, p)
    fxr = dc.Fx_r(Fx, p)
    return [
        cs["Ux_min"] - Ux,
        delta - cs["delta_max"],
        cs["delta_min"] - delta,
        (Fx - p.Peng / J.maximum(Ux, 1.0)) * fs,
        wact - ci["w_max"],
        ci["w_min"] - wact,
        (fxf - bound_f) * fs,
        (-fxf - bound_f) * fs,
        (fxr - bound_r) * fs,
        (-fxr - bound_r) * fs,
    ]


def al_penalty_fields(cons, lam_read, mu, rows=None):
    """PHR penalty sum_j (max(0, lam_j + mu c_j)^2 - lam_j^2) / (2 mu)."""
    acc = 0.0
    for j in range(len(cons)) if rows is None else rows:
        lam_j = lam_read(j)
        lam_hat = J.maximum(0.0, lam_j + mu * cons[j])
        acc = acc + (lam_hat**2 - lam_j**2)
    return acc / (2.0 * mu)
