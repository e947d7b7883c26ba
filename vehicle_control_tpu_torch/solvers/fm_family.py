"""Field-wise problem family (counterpart of vehicle_control_tpu/solvers/fm_family.py).

A family is the one source of the AL stage cost, the dynamics and the
control boxes that the solver, the kernels' plain versions and the CUDA
kernels (``csrc/singletrack.cuh``, ``csrc/kc_cascade.cuh``) compute.  Fields
are per-scenario tensors; the stage index ``n`` is a Python int, so every
stage-switched branch resolves when the closure runs.

``build_cascaded_family`` has three tails.  ``tail="none"`` is the
single-track family (``configs/controllers/singletrack.yaml``, H = N
stages).  ``tail="pm"`` is the paper's cascade
(``configs/controllers/cascaded.yaml``): N single-track stages, then M
point-mass stages, H = N + M.  The solver state is one padded z = [x(8),
u_prev(2)] whose fields change meaning at the seam: stages n < N carry the
single-track state (Ux, Uy, r, delta, s, ey, epsi, t) and the RK4 step;
stage N-1 hands off to the point mass (``fm_singletrack.seam_fields``) and
stashes the total lateral force in z[5]; stages n >= N carry (V, s, ey,
epsi, t) and an explicit Euler step.  Control 1 is the steer rate w before
N and the lateral force Fy in kN from N on.  With ``cfg["obstacles"]`` the
track's discs add a barrier cost, sum_i w dsn / max(dist_i - (r_i + 0.1),
OBSTACLE_EPS) over the (s, ey) distance to each disc's centre, to every
stage: on (z[4], z[5]) at the single-track stages (the seam's included), on
(z[1], z[2]) at the point-mass stages.  It is a cost term, not a
constraint row.

``tail="kc"`` is the single-track + kinematic-bicycle cascade
(``configs/controllers/cascaded_kinematic.yaml``): N single-track stages,
then K = ``horizon_kc`` kinematic stages, H = N + K.  The seam N-1 maps the
single-track state to (v, delta, s, ey, epsi, t) = (V, delta, s, ey, beta +
epsi, t) and stashes in z[6] and z[7] the acceleration magnitude a_final
that the previous controls give (``kc_seam_fields``) and the previous steer
rate; the switching cost at N holds the tail's first (a, w) against them.
The tail stages carry the kinematic bicycle's regularized Euler step
(``kc_prime`` at floor 0.3, beta 10, v in [0.5, 1e3]) with the steering
stop at the tail's delta bounds; control 0 is the acceleration a in
units of FORCE_SCALE, control 1 the steer rate w throughout.  Its obstacle
barrier (the JAX package's ``_obstacles_kc``) is not ported: the kc tail
with obstacles raises.  ``build_kinematic_family`` is the pure kinematic
bicycle (``configs/controllers/kinematic.yaml``): its own state, its
explicit Euler step and closed-form stage derivatives (see its docstring).

``stage_derivs`` is the hand-derived twin of the JAX package's restructured
exact derivatives, with no autograd in it:

* the full AL-cost gradient from first-order jets over the 12 stage
  variables (JAX: one reverse-mode pass), at every stage;
* single-track stages n < N-1 (JAX ``_st_fast``): the dynamics Jacobian
  from first-order jets over the 8 columns the RK4 step reads, chained
  through the steering stop; the nonquadratic Hessian block over (Ux, Uy,
  r, delta, u_Fx) - the slip penalty plus the PHR penalty of constraint
  rows 3, 6, 7, 8 and 9 - from second-order jets; every other Hessian entry
  in closed form;
* the seam n = N-1 (JAX takes its generic forward-over-reverse path here):
  the cost and constraints are a single-track stage's, so the gradient and
  Hessian are too; the Jacobian comes from first-order jets through the
  seam map over (Ux, Uy, r, delta, u_Fx), plus the unit columns of s, ey,
  epsi and t.  The kc seam reads the previous controls instead of u: its
  jets run over (Ux, Uy, r, delta, z[8]) through the temporal ODE, a_final's
  partials are chained by hand, and the w stash's column z[9] is a unit
  column;
* point-mass stages n >= N (JAX ``_tail_fast``): the Jacobian from
  first-order jets through the Euler step over (V, ey, epsi, u_Fx, u_Fy),
  plus the unit columns of s and t; the Hessian in closed form (boundary,
  deviation, the V floor, the engine-power row, the Fx/Fy slew, the
  switching cost at n = N and the terminal cost);
* kinematic tail stages n >= N (JAX ``_tail_fast``): the Jacobian from
  ``kc_prime_jacobian`` at the tail's regularization through the steering
  stop, the s and t columns unit columns, the stash rows stash_next = u; the
  Hessian in closed form (boundary, deviation, w, the box rows, the a-slew,
  the switching cost at n = N and the terminal cost).

With obstacles, the barrier's gradient comes with the rest of the gradient's
jets, and its 2x2 (s, ey) Hessian block from second-order jets over (s, ey)
(JAX: a small forward-over-reverse pass); the dynamics never read s, so the
Jacobian's s column stays a unit column.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vehicle_control_tpu_torch.models import dynamic_car as dc
from vehicle_control_tpu_torch.solvers import fm_singletrack as fm
from vehicle_control_tpu_torch.utils import jet as J
from vehicle_control_tpu_torch.utils.jet import Jet
from vehicle_control_tpu_torch.utils.math import arctan, safe_div, tan

FORCE_SCALE = fm.FORCE_SCALE
NONQUAD_ROWS = (3, 6, 7, 8, 9)  # constraint rows in the nonquadratic block
VIDX = (0, 1, 2, 3, 10)  # its variables: Ux, Uy, r, delta, u_Fx; the seam map reads the same
PM_COLS = (0, 2, 3, 10, 11)  # what the point-mass Euler step reads: V, ey, epsi, u_Fx, u_Fy
# point-mass regularization (problems.build_cascaded_problem's tail): the
# clamps V >= 0.5, |ey| <= 8, |epsi| <= 1.3, then the softplus-floored 1/s_dot
PM_CLAMPS = {0: (0.5, 1e3), 2: (-8.0, 8.0), 3: (-1.3, 1.3)}
TAIL_BOX = (-25.0, 25.0)  # Fy box in kN on the point-mass stages
OBSTACLE_EPS = 1e-2  # the floor of the obstacle barrier's denominator
# the kc tail's regularization (problems.build_cascaded_problem's kc tail):
# the clamps v in [0.5, 1e3], |delta| <= 1, |ey| <= 8, |epsi| <= 1.2, the
# floor 0.3 and beta 10 of the single-track stages
KC_TAIL_CLAMPS = {0: (0.5, 1e3), 1: (-1.0, 1.0), 3: (-8.0, 8.0), 4: (-1.2, 1.2)}
KC_TAIL_FLOOR, KC_TAIL_BETA = 0.3, 10.0
KC_SEAM_COLS = (0, 1, 2, 3, 8)  # what a_final reads: Ux, Uy, r, delta, the Fx stash


class FMFamily(NamedTuple):
    """Solver-facing problem family.

    ``wf`` everywhere is the tuple of NZ state fields followed by NU control
    fields (solver units); ``lam_read(j)`` and ``ds_read(i)`` read multiplier
    and arc-step fields; ``kv`` is the stage curvature field.  ``N`` is the
    number of single-track stages (``H`` for ``tail="none"``), or the running
    stages of the kinematic family (``tail="kinematic"``, H = N + 1).
    """

    NZ: int
    NU: int
    NC: int
    H: int
    N: int
    tail: str
    al_cost: Callable  # (n, wf, lam_read, mu, kv, ds_read) -> cost field
    dyn: Callable  # (n, wf, kv, ds_read) -> tuple of NZ next-state fields
    u_box: Callable  # (n, j) -> (lo, hi) clamp bounds, solver units
    stage_cost: Callable  # (n, wf, kv, ds_read) -> raw cost (no penalty)
    constraints: Callable  # (n, wf) -> list of NC fields (c <= 0 feasible)
    # (n, wf, lam, mu, kv, ds_read) -> (g (..., NW), Hw (..., NW, NW),
    # J (..., NZ, NW)): Hw unsymmetrized, Hw[r, c] = d2L/dw_r dw_c
    stage_derivs: Callable
    params: object  # dc.DynamicCarParams, or KinematicCarParams for the kinematic family
    weights: dict
    input_constraints: dict
    state_constraints: dict
    tail_constraints: dict | None  # state_pm_constraints ("pm"), state_kc_constraints ("kc")
    obstacles: tuple  # the barrier's discs, (s, ey, r) each; () without obstacles


def _active(x, dtype):
    """The curvature factor of a PHR row, max(0, x)^2 / (2 mu) with x =
    lam + mu c, along its constraint: 1 where x > 0, 0 where x < 0 and, at
    the tie x = 0, the 0.5 x 0.5 = 0.25 that JAX's autodiff of the max gives
    (and the second-order jets of the nonquadratic block give).  A control
    clamped onto its box with a zero multiplier sits on that tie."""
    return (x > 0.0).to(dtype) + 0.25 * (x == 0.0).to(dtype)


def pm_prime(x5, Fx, Fy, k, p):
    """Point-mass d(state)/ds of the clamped state (V, s, ey, epsi, t), with
    the softplus-floored 1/s_dot; forces in N."""
    x5 = list(x5)
    for i, (lo, hi) in PM_CLAMPS.items():
        x5[i] = J.clip(x5[i], lo, hi)
    V, s, ey, epsi, t = x5
    V_dot = (Fx - (p.Frr + p.Cd * V**2)) / p.m
    s_dot = (V * J.cos(epsi)) / (1.0 - k * ey)
    ey_dot = V * J.sin(epsi)
    V_safe = J.where(torch.abs(J.val(V)) > 1e-3, V, 1e-3)
    epsi_dot = Fy / (p.m * V_safe) - k * s_dot
    inv = 1.0 / (fm.FLOOR + J.softplus0(fm.BETA * (s_dot - fm.FLOOR)) / fm.BETA)
    return [V_dot * inv, torch.ones_like(J.val(s_dot)), ey_dot * inv, epsi_dot * inv, inv]


def pm_step(x5, Fx, Fy, k, h, p):
    """Explicit Euler step of ``pm_prime`` from the raw state."""
    return [a + h * b for a, b in zip(x5, pm_prime(x5, Fx, Fy, k, p))]


def _obstacle_rows(track_data, on: bool) -> tuple:
    """The track's discs as Python floats (s, ey, r), or () when off."""
    if not on:
        return ()
    if track_data is None:
        raise ValueError("obstacles need the track's data (track_data)")
    obs = track_data.obstacles.detach().cpu().double().numpy()
    return tuple((float(o[2]), float(o[3]), float(o[4])) for o in obs)


def _obstacles_std(rows, s, ey, dsn, w_obs):
    """The obstacle barrier, sum over the discs in table order of
    w dsn / max(dist - (r + 0.1), OBSTACLE_EPS); (r + 0.1) is formed in
    Python floats."""
    acc = torch.zeros_like(J.val(s))
    for so, eo, ro in rows:
        dist = J.sqrt((s - so) ** 2 + (ey - eo) ** 2)
        den = J.maximum(dist - (ro + 0.1), OBSTACLE_EPS)
        acc = acc + w_obs * dsn / den
    return acc


def _norm2(a, b):
    """sqrt(a^2 + b^2); on jets the partials chained by hand, (a a' + b b') /
    sqrt(a^2 + b^2), and 0 where the norm is 0 (the subgradient of a norm at
    its kink: JAX's autodiff of jnp.sqrt there gives inf x 0 = NaN)."""
    if not isinstance(a, Jet) and not isinstance(b, Jet):
        return torch.sqrt(a**2 + b**2)
    av, bv = J.val(a), J.val(b)
    r = torch.sqrt(av**2 + bv**2)
    live = r > 0.0
    inv = torch.where(live, 1.0 / torch.where(live, r, 1.0), 0.0)
    d = J._parts(a)[0] * (av * inv).unsqueeze(-1) + J._parts(b)[0] * (bv * inv).unsqueeze(-1)
    return Jet(r, d)


def kc_seam_fields(x, Fx_prev, w_prev, p):
    """The handoff from the single-track state to the kinematic tail at stage
    N-1 (problems.build_cascaded_problem's kc seam): v = V, delta, s, ey, the
    heading beta + epsi, t, then the stashes the switching cost reads: the
    acceleration magnitude a_final = |(Ux', Uy')| of the temporal ODE at the
    raw state under the previous controls (Fx_prev in N, w_prev), and w_prev."""
    Ux, Uy, r, delta, s, ey, epsi, t = x
    V = J.sqrt(Ux**2 + Uy**2)
    beta = arctan(safe_div(Uy, Ux))
    xdot = fm.temporal_fields(x, Fx_prev, w_prev, 0.0, p)
    return [V, delta, s, ey, beta + epsi, t, _norm2(xdot[0], xdot[1]), w_prev]


def build_cascaded_family(car_config, cfg, tail: str = "none", track_data=None) -> FMFamily:
    """Field-wise twin of problems.build_cascaded_problem (tail "none", "pm"
    or "kc"); with ``cfg["obstacles"]`` the barrier over the discs of
    ``track_data`` (a TrackData).  The kc tail with obstacles raises."""
    if tail not in ("none", "pm", "kc"):
        raise ValueError(f"tail={tail!r}: 'none', 'pm' or 'kc'")
    N = int(cfg["horizon"])
    M = int(cfg["horizon_pm"]) if tail == "pm" else int(cfg["horizon_kc"]) if tail == "kc" else 0
    if M == 0:
        tail = "none"
    pm, kc = tail == "pm", tail == "kc"
    if kc and bool(cfg.get("obstacles", False)):
        raise NotImplementedError(
            "the kc tail with obstacles (its own barrier, the JAX package's "
            "fm_family._obstacles_kc) is not ported: ROADMAP item 'The kc tail with obstacles'")
    p = dc.DynamicCarParams.from_config(car_config)
    H = N + M
    NZ, NU, NC = 10, 2, 10
    NW = NZ + NU
    w = {k: float(v) for k, v in cfg["cost_weights"].items()}
    ci = {k: float(v) for k, v in cfg["input_constraints"].items()}
    cs = {k: float(v) for k, v in cfg["state_constraints"].items()}
    ct = None
    if pm:
        ct = {k: float(v) for k, v in cfg["state_pm_constraints"].items()}
    elif kc:
        ct = {k: float(v) for k, v in cfg["state_kc_constraints"].items()}
        l_kc = float(car_config["car"]["l"])
        K = int(cfg["horizon_kc"])
        a_box = (ci["a_min"] / FORCE_SCALE, ci["a_max"] / FORCE_SCALE)  # a in units of FS
    rows = _obstacle_rows(track_data, bool(cfg.get("obstacles", False)))
    w_obs = w.get("obstacles", 0.0)
    FS = FORCE_SCALE
    fs = 1.0 / FS

    def split(n, wf):
        """(z, Fx, u1, Fx_prev, u1_prev) in physical units: on the point-mass
        tail u1 is w before N and Fy (kN in the solver) from N on, the
        previous u1 in kN from N+1 on; on the kc tail Fx is the acceleration
        a from N on and u1 is w throughout."""
        z, u = wf[:NZ], wf[NZ:]
        u1 = u[1] * FS if pm and n >= N else u[1]
        u1_prev = z[9] * FS if pm and n >= N + 1 else z[9]
        return z, u[0] * FS, u1, z[8] * FS, u1_prev

    def a_slew_on(n):
        # JAX's traced mask as written: the reference's k < K - 1 on the
        # global stage index, so live only where K >= N + 2
        return n >= N + 1 and n - 1 < K - 1

    def stage_cost(n, wf, kv, ds_read):
        z, Fx, u1, Fx_prev, u1_prev = split(n, wf)
        dsn, ds_prev = ds_read(n), ds_read(max(n - 1, 0))
        if n < N:
            cost = fm.st_running_cost_fields(
                n, z[:8], Fx, u1, Fx_prev, dsn, ds_prev, p, w, cs, N
            )
            if rows:
                cost = cost + _obstacles_std(rows, z[4], z[5], dsn, w_obs)
        elif kc:
            ey = z[3]
            cost = fm.boundary_fields(ey, dsn, w["boundary"], ct["ey_min"], ct["ey_max"])
            cost = cost + w["deviation_kc"] * dsn * ey**2
            cost = cost + w["w_kc"] * u1**2
            if a_slew_on(n):  # the a-slew against the previous action (no ds factor)
                cost = cost + w["a"] * (Fx - Fx_prev) ** 2
            if n == N:  # switching cost against the seam's stashed a_final and w_prev
                cost = cost + (w["Fy"] / ds_read(min(N, H - 1))) * (
                    (z[6] - Fx) ** 2 + (z[7] - u1) ** 2
                )
        else:
            ey = z[2]
            cost = fm.boundary_fields(ey, dsn, w["boundary"], ct["ey_min"], ct["ey_max"])
            cost = cost + w["deviation_pm"] * dsn * ey**2
            if n >= N + 1:  # Fx/Fy slew against the previous action
                cost = cost + ((w["Fx"] / ds_prev) * (Fx - Fx_prev) ** 2
                               + (w["Fy"] / ds_prev) * (u1 - u1_prev) ** 2)
            if rows:  # the point mass reads the same weight (not obstacles_pm)
                cost = cost + _obstacles_std(rows, z[1], ey, dsn, w_obs)
            if n == N:  # switching cost against the seam's stashed lateral force
                cost = cost + (w["switch_F"] / ds_read(N - 1)) * (
                    (Fx - Fx_prev) ** 2 + (u1 - z[5]) ** 2
                )
        if n == H - 1:
            if pm:
                cost = cost + fm.term_cost_fields(z[0], z[2], z[3], z[4], w, cs)
            elif kc:
                cost = cost + fm.term_cost_fields(z[0], z[3], z[4], z[5], w, cs)
            else:
                cost = cost + fm.term_cost_fields(z[0], z[5], z[6], z[7], w, cs)
        return cost

    def constraints(n, wf):
        z, Fx, u1, _, _ = split(n, wf)
        if n >= N and kc:  # kinematic tail: v floor, steering box, a and w boxes, padding
            v, delta = z[0], z[1]
            return [ct["v_min"] - v, delta - ct["delta_max"], ct["delta_min"] - delta,
                    Fx - ci["a_max"], ci["a_min"] - Fx, u1 - ci["w_max"],
                    ci["w_min"] - u1] + [-1.0] * 3
        if n >= N:  # point mass: speed floor, engine power, padding
            V = z[0]
            return [ct["V_min"] - V, (Fx - p.Peng / J.maximum(V, 1.0)) * fs] + [-1.0] * 8
        c = fm.constraint_fields(z[:8], Fx, u1, p, ci, cs)
        if n == 0:
            # the state-only rows (speed floor, steering box) are undecidable
            # at the fixed stage-0 state (problems._mask_stage0_state_rows)
            c[:3] = [-1.0, -1.0, -1.0]
        return c

    def al_cost(n, wf, lam_read, mu, kv, ds_read):
        return stage_cost(n, wf, kv, ds_read) + fm.al_penalty_fields(
            constraints(n, wf), lam_read, mu
        )

    def kc_tail_step(x6, a, w_act, kv, h):
        """The kinematic tail's Euler step with the steering stop."""
        prime = kc_prime(x6, a, w_act, kv, l_kc, KC_TAIL_FLOOR, KC_TAIL_BETA, KC_TAIL_CLAMPS)
        nxt = [x + h * q for x, q in zip(x6, prime)]
        nxt[1] = J.clip(nxt[1], ct["delta_min"], ct["delta_max"])
        return nxt

    def dyn(n, wf, kv, ds_read):
        z, Fx, u1, Fx_prev, u1_prev = split(n, wf)
        dsn = ds_read(n)
        if n < N - 1 or tail == "none":
            nxt = fm.rk4_step(z[:8], Fx, u1, kv, dsn, p)
            # steering stop on the integrated delta (problems._sat_col)
            nxt[3] = J.clip(nxt[3], cs["delta_min"], cs["delta_max"])
        elif n == N - 1 and pm:
            seam = fm.seam_fields(z[:8], Fx, p)
            nxt = seam + [torch.zeros_like(J.val(seam[0]))] * 2
        elif n == N - 1:  # kc: the previous controls give a_final
            nxt = kc_seam_fields(z[:8], Fx_prev, u1_prev, p)
            nxt[7] = nxt[7] + torch.zeros_like(J.val(nxt[0]))
        elif pm:
            nxt = pm_step(z[:5], Fx, u1, kv, dsn, p)
            nxt = nxt + [torch.zeros_like(J.val(nxt[0]))] * 3
        else:
            nxt = kc_tail_step(z[:6], Fx, u1, kv, dsn)
            nxt = nxt + [torch.zeros_like(J.val(nxt[0]))] * 2
        return tuple(nxt) + (wf[NZ], wf[NZ + 1])

    def u_box(n, j):
        if j == 0:
            return a_box if kc and n >= N else (-30.0, 60.0)  # Fx in kN (brake, drive); a
        if pm and n >= N:
            return TAIL_BOX
        return ci["w_min"], ci["w_max"]

    def _jac(cols, nxt, ones, zero):
        """(..., NZ, NW) from per-column jets of the next state: ``cols`` maps
        a stage variable to its seed index; ``ones`` lists the (row,
        variable) unit entries (the identity columns and the stash rows)."""
        Jm = zero.new_zeros(zero.shape + (NZ, NW))
        for i, c in cols.items():
            for r, q in enumerate(nxt):
                Jm[..., r, i] = fm.dcol(q, c) + zero
        for r, i in ones:
            Jm[..., r, i] = 1.0
        return Jm

    def _obstacle_block(Hw, i_s, i_ey, s, ey, dsn):
        """Add the barrier's 2x2 Hessian block on (s, ey) at (i_s, i_ey)."""
        if not rows:
            return
        se = Jet.seed([s, ey], second=True)
        h = _obstacles_std(rows, se[0], se[1], dsn, w_obs).h
        idx = torch.tensor((i_s, i_ey), device=Hw.device)
        Hw[..., idx[:, None], idx[None, :]] += h.expand(Hw.shape[:-2] + (2, 2))

    def _st_hessian(n, wf, lam, mu, dsn, ds_prev, zero):
        """Hessian of a single-track stage's AL cost (stages n < N)."""
        s5 = Jet.seed([wf[i] for i in VIDX], second=True)
        xq = list(s5[:4]) + list(wf[4:8])
        Fxq = s5[4] * FS
        cq = fm.constraint_fields(xq, Fxq, wf[NZ + 1], p, ci, cs)
        block = fm.slip_penalty_fields(xq, Fxq, p, w["slip"]) + fm.al_penalty_fields(
            cq, lambda j: lam[j], mu, rows=NONQUAD_ROWS
        )
        Hw = zero.new_zeros(zero.shape + (NW, NW))
        idx = torch.tensor(VIDX, device=zero.device)
        Hw[..., idx[:, None], idx[None, :]] = block.h.expand(zero.shape + (5, 5))

        # closed-form quadratic / piecewise-quadratic entries
        c_all = constraints(n, wf)

        def act(j):
            return _active(lam[j] + mu * c_all[j], zero.dtype)

        keep = 0.0 if n == 0 else 1.0
        termf = 1.0 if n == H - 1 else 0.0
        Ux, ey = wf[0], wf[5]
        Hw[..., 0, 0] += mu * act(0) * keep + termf * (2.0 * w["speed"]) * (
            Ux >= cs["max_speed"]
        ).to(zero.dtype)
        Hw[..., 3, 3] += mu * (act(1) + act(2)) * keep
        Hw[..., NZ + 1, NZ + 1] = 2.0 * w["w"] + mu * (act(4) + act(5)) + zero
        blo = (ey < cs["ey_min"]).to(zero.dtype)
        bhi = (ey > cs["ey_max"]).to(zero.dtype)
        Hw[..., 5, 5] += (
            2.0 * w["boundary"] * dsn * (blo + bhi)
            + 2.0 * w["deviation_st"] * dsn
            + termf * (2.0 * w["ey"])
        )
        Hw[..., 6, 6] = termf * (2.0 * w["epsi"]) + zero
        if 1 <= n < N:  # Fx slew against the previous action (FS units)
            coef = (2.0 * w["Fx"] / ds_prev) * (FS * FS) + zero
            Hw[..., 8, 8] += coef
            Hw[..., 8, NZ] -= coef
            Hw[..., NZ, 8] -= coef
            Hw[..., NZ, NZ] += coef
        _obstacle_block(Hw, 4, 5, wf[4], wf[5], dsn)
        return Hw

    def _tail_hessian(n, wf, lam, mu, dsn, ds_prev, ds_seam, zero):
        """Hessian of a point-mass stage's AL cost (stages n >= N), closed form."""
        c_all = constraints(n, wf)

        def act(j):
            return _active(lam[j] + mu * c_all[j], zero.dtype)

        Hw = zero.new_zeros(zero.shape + (NW, NW))
        V, ey = wf[0], wf[2]
        blo = (ey < ct["ey_min"]).to(zero.dtype)
        bhi = (ey > ct["ey_max"]).to(zero.dtype)
        Hw[..., 2, 2] = 2.0 * w["boundary"] * dsn * (blo + bhi) + 2.0 * w["deviation_pm"] * dsn
        # constraint rows: 0 the V floor (linear), 1 the engine power
        Hw[..., 0, 0] += mu * act(0)
        Vm = torch.clamp_min(V, 1.0)
        liveV = (V > 1.0).to(zero.dtype) + 0.5 * (V == 1.0).to(zero.dtype)  # max's tie rule
        gV = fs * p.Peng / (Vm * Vm) * liveV  # d c1 / dV; d c1 / du_Fx = 1
        lam_hat1 = torch.clamp_min(lam[1] + mu * c_all[1], 0.0)
        a1 = mu * act(1)
        Hw[..., 0, 0] += a1 * gV * gV + lam_hat1 * (-2.0 * fs * p.Peng / (Vm * Vm * Vm)) * liveV
        Hw[..., 0, NZ] += a1 * gV
        Hw[..., NZ, 0] += a1 * gV
        Hw[..., NZ, NZ] += a1
        if n >= N + 1:  # Fx/Fy slew (both previous actions in kN)
            for zi, ui, wk in ((8, NZ, "Fx"), (9, NZ + 1, "Fy")):
                coef = (2.0 * w[wk] / ds_prev) * (FS * FS)
                Hw[..., zi, zi] += coef
                Hw[..., zi, ui] -= coef
                Hw[..., ui, zi] -= coef
                Hw[..., ui, ui] += coef
        if n == N:  # switching cost: Fx against the stash, Fy against z[5]
            cw = 2.0 * w["switch_F"] / ds_seam
            Hw[..., NZ, NZ] += cw * (FS * FS)
            Hw[..., NZ, 8] -= cw * (FS * FS)
            Hw[..., 8, NZ] -= cw * (FS * FS)
            Hw[..., 8, 8] += cw * (FS * FS)
            Hw[..., NZ + 1, NZ + 1] += cw * (FS * FS)
            Hw[..., NZ + 1, 5] -= cw * FS
            Hw[..., 5, NZ + 1] -= cw * FS
            Hw[..., 5, 5] += cw
        if n == H - 1:  # terminal cost on the point-mass fields
            Hw[..., 0, 0] += (2.0 * w["speed"]) * (V >= cs["max_speed"]).to(zero.dtype)
            Hw[..., 2, 2] += 2.0 * w["ey"]
            Hw[..., 3, 3] += 2.0 * w["epsi"]
        _obstacle_block(Hw, 1, 2, wf[1], wf[2], dsn)
        return Hw

    def _kc_tail_hessian(n, wf, lam, mu, dsn, ds_switch, zero):
        """Hessian of a kinematic tail stage's AL cost (stages n >= N), closed
        form: every term is linear, quadratic or a hinge in the fields."""
        c_all = constraints(n, wf)

        def act(j):
            return _active(lam[j] + mu * c_all[j], zero.dtype)

        Hw = zero.new_zeros(zero.shape + (NW, NW))
        v, ey = wf[0], wf[3]
        blo = (ey < ct["ey_min"]).to(zero.dtype)
        bhi = (ey > ct["ey_max"]).to(zero.dtype)
        Hw[..., 3, 3] = 2.0 * w["boundary"] * dsn * (blo + bhi) + 2.0 * w["deviation_kc"] * dsn
        Hw[..., NZ + 1, NZ + 1] = 2.0 * w["w_kc"] + mu * (act(5) + act(6)) + zero
        # the box rows: 0 the v floor, 1-2 the steering box, 3-4 a (d c / du_a = FS)
        Hw[..., 0, 0] += mu * act(0)
        Hw[..., 1, 1] += mu * (act(1) + act(2))
        Hw[..., NZ, NZ] += mu * (act(3) + act(4)) * (FS * FS)
        if a_slew_on(n):
            coef = (2.0 * w["a"]) * (FS * FS)
            Hw[..., 8, 8] += coef
            Hw[..., 8, NZ] -= coef
            Hw[..., NZ, 8] -= coef
            Hw[..., NZ, NZ] += coef
        if n == N:  # switching cost: a against z[6] (a_final), w against z[7]
            cw = 2.0 * w["Fy"] / ds_switch
            Hw[..., 6, 6] += cw
            Hw[..., 6, NZ] -= cw * FS
            Hw[..., NZ, 6] -= cw * FS
            Hw[..., NZ, NZ] += cw * (FS * FS)
            Hw[..., 7, 7] += cw
            Hw[..., 7, NZ + 1] -= cw
            Hw[..., NZ + 1, 7] -= cw
            Hw[..., NZ + 1, NZ + 1] += cw
        if n == H - 1:  # terminal cost on the kinematic fields
            Hw[..., 0, 0] += (2.0 * w["speed"]) * (v >= cs["max_speed"]).to(zero.dtype)
            Hw[..., 3, 3] += 2.0 * w["ey"]
            Hw[..., 4, 4] += 2.0 * w["epsi"]
        return Hw

    def _kc_tail_jacobian(wf, kv, h, zero):
        """The kinematic tail's Euler-step Jacobian (..., NZ, NW):
        ``kc_prime_jacobian`` at the tail's regularization, row 1 through the
        steering stop, a = u_a FS; s and t pass through (unit columns), the
        stash rows stash_next = u, rows 6 and 7 (zeroed) none."""
        Jm = zero.new_zeros(zero.shape + (NZ, NW))
        for i in range(6):
            Jm[..., i, i] = 1.0
        Jm[..., 8, NZ] = 1.0
        Jm[..., 9, NZ + 1] = 1.0
        prime, D = kc_prime_jacobian(list(wf[:6]), wf[NZ] * FS, wf[NZ + 1], kv, l_kc,
                                     KC_TAIL_FLOOR, KC_TAIL_BETA, KC_TAIL_CLAMPS)
        cols = {c: c for c in KC_PRIME_COLS}
        cols.update(a=NZ, w=NZ + 1)
        for (r, c), dv in D.items():
            Jm[..., r, cols[c]] += h * dv * (FS if c == "a" else 1.0)
        nxt1 = wf[1] + h * prime[1]
        stop = J._tie_weight(nxt1, ct["delta_min"]) * J._tie_weight(
            ct["delta_max"], J._vmax(nxt1, ct["delta_min"]))
        Jm[..., 1, :] *= stop.unsqueeze(-1) + 0.0 * zero.unsqueeze(-1)
        return Jm

    def stage_derivs(n, wf, lam, mu, kv, ds_read):
        ref = wf[0]
        for f in tuple(wf[1:]) + (kv, mu):
            ref = ref + 0.0 * f  # common broadcast shape of every input
        zero = torch.zeros_like(ref)
        dsn = ds_read(n)
        ds_prev = ds_read(max(n - 1, 0))

        # gradient of the full AL cost: first-order jets over all 12 inputs
        L = al_cost(n, Jet.seed(list(wf)), lambda j: lam[j], mu, kv, ds_read)
        g = L.d + zero.unsqueeze(-1)
        stash = ((8, NZ), (9, NZ + 1))  # stash_next = u

        if n >= N and kc:  # kinematic tail: the Euler step's closed-form Jacobian
            Jm = _kc_tail_jacobian(wf, kv, dsn, zero)
            return g, _kc_tail_hessian(n, wf, lam, mu, dsn, ds_read(min(N, H - 1)), zero), Jm

        if n >= N:  # point mass: jets through the Euler step
            seeds = Jet.seed([wf[i] for i in PM_COLS])
            x5 = [seeds[0], wf[1], seeds[1], seeds[2], wf[4]]
            nxt = pm_step(x5, seeds[3] * FS, seeds[4] * FS, kv, dsn, p)
            # s_next = s + ds, t_next = t + ds / s_dot_eff
            Jm = _jac({i: c for c, i in enumerate(PM_COLS)}, nxt, ((1, 1), (4, 4)) + stash, zero)
            return g, _tail_hessian(n, wf, lam, mu, dsn, ds_prev, ds_read(N - 1), zero), Jm

        if n == N - 1 and pm:  # the seam: jets through the handoff map
            seeds = Jet.seed([wf[i] for i in VIDX])
            seam = fm.seam_fields(list(seeds[:4]) + list(wf[4:8]), seeds[4] * FS, p)
            # s, ey and t pass through; epsi adds to beta
            Jm = _jac({i: c for c, i in enumerate(VIDX)}, seam,
                      ((1, 4), (2, 5), (3, 6), (4, 7)) + stash, zero)
        elif n == N - 1 and kc:
            # the kc seam reads the stash, not u: jets over (Ux, Uy, r, delta,
            # z[8]) through the temporal ODE give a_final's partials; s, ey
            # and t pass through, epsi adds to beta, w_prev = z[9] is the
            # next w stash
            seeds = Jet.seed([wf[i] for i in KC_SEAM_COLS])
            seam = kc_seam_fields(list(seeds[:4]) + list(wf[4:8]), seeds[4] * FS, wf[9], p)
            Jm = _jac({i: c for c, i in enumerate(KC_SEAM_COLS)}, seam,
                      ((2, 4), (3, 5), (4, 6), (5, 7), (7, 9)) + stash, zero)
        else:  # single track: jets over (Ux, Uy, r, delta, ey, epsi, u_Fx, w)
            seeds = Jet.seed([wf[i] for i in fm.RK4_COLS] + [wf[NZ], wf[NZ + 1]])
            x8 = list(wf[:8])
            for c, i in enumerate(fm.RK4_COLS):
                x8[i] = seeds[c]
            nxt = fm.rk4_step(x8, seeds[6] * FS, seeds[7], kv, dsn, p)
            nxt[3] = J.clip(nxt[3], cs["delta_min"], cs["delta_max"])
            cols = {i: c for c, i in enumerate(fm.RK4_COLS + (NZ, NZ + 1))}
            # s_next = s + ds, t_next = t + ds / s_dot; the stash is never read
            Jm = _jac(cols, nxt, ((4, 4), (7, 7)) + stash, zero)
        return g, _st_hessian(n, wf, lam, mu, dsn, ds_prev, zero), Jm

    return FMFamily(
        NZ=NZ, NU=NU, NC=NC, H=H, N=N, tail=tail, al_cost=al_cost, dyn=dyn, u_box=u_box,
        stage_cost=stage_cost, constraints=constraints, stage_derivs=stage_derivs,
        params=p, weights=w, input_constraints=ci, state_constraints=cs, tail_constraints=ct,
        obstacles=rows,
    )


# -- the pure kinematic family ---------------------------------------------------------

# The kinematic bicycle's regularized spatial step (problems.
# _regularized_spatial): the clamps of delta, ey and epsi, then the
# softplus-floored 1/s_dot.  The pure kinematic family's (problems.
# build_kinematic_problem): |delta| <= 1, |ey| <= 8, |epsi| <= 1.2, a floor
# far below the 0.1 m/s standing start and a sharp beta; the kc tail's
# differ (JAX: fm_family._kc_prime's arguments).
KIN_CLAMPS = {1: (-1.0, 1.0), 3: (-8.0, 8.0), 4: (-1.2, 1.2)}
KIN_FLOOR, KIN_BETA = 0.02, 50.0
KC_PRIME_COLS = (0, 1, 3, 4)  # the state fields kc_prime reads: v, delta, ey, epsi


def kc_prime(x6, a, w, k, l, floor=KIN_FLOOR, beta=KIN_BETA, clamps=KIN_CLAMPS):
    """Kinematic-bicycle d(state)/ds of the clamped state (v, delta, s, ey,
    epsi, t), with the softplus-floored 1/s_dot (the JAX package's
    fm_family._kc_prime; ``clamps`` maps a field to its (lo, hi))."""
    x6 = list(x6)
    for i, (lo, hi) in clamps.items():
        x6[i] = J.clip(x6[i], lo, hi)
    v, delta, s, ey, epsi, t = x6
    s_dot = (v * torch.cos(epsi)) / (1.0 - ey * k)
    ey_dot = v * torch.sin(epsi)
    epsi_dot = v * tan(delta) / l - s_dot * k
    inv = 1.0 / (floor + J.softplus0(beta * (s_dot - floor)) / beta)
    return [a * inv, w * inv, torch.ones_like(s_dot), ey_dot * inv, epsi_dot * inv, inv]


def kc_prime_jacobian(x6, a, w, k, l, floor=KIN_FLOOR, beta=KIN_BETA, clamps=KIN_CLAMPS):
    """``kc_prime`` and its partials in closed form: (prime, D), D[r][c] the
    partial of prime field r over the state fields c of KC_PRIME_COLS, then
    "a" and "w" (a dict; absent entries are zero).  The clamps' partials
    take JAX's tie rule (half at a bound), the softplus floor's slope is
    exp(y - softplus(y)) as JAX's logaddexp gives it."""
    cg = {i: J._tie_weight(x6[i], lo) * J._tie_weight(hi, J._vmax(x6[i], lo))
          for i, (lo, hi) in clamps.items()}
    v, delta, ey, epsi = (J.clip(x6[i], *clamps[i]) if i in clamps else x6[i]
                          for i in (0, 1, 3, 4))
    cg0 = cg.get(0, 1.0)  # the kc tail clamps v, the kinematic family not
    ce, se = torch.cos(epsi), torch.sin(epsi)
    den = 1.0 - ey * k
    s_dot = (v * ce) / den
    ey_dot = v * se
    td = tan(delta)
    epsi_dot = v * td / l - s_dot * k
    y = beta * (s_dot - floor)
    sp = J.softplus0(y)
    inv = 1.0 / (floor + sp / beta)
    dinv = -(inv * inv) * torch.exp(y - sp)  # d inv / d s_dot
    # s_dot, ey_dot and epsi_dot over (v, delta, ey, epsi)
    dsd = {0: cg0 * (ce / den), 3: cg[3] * (s_dot * k / den), 4: cg[4] * (-(v * se) / den)}
    dey = {0: cg0 * se, 4: cg[4] * (v * ce)}
    dep = {0: cg0 * (td / l) - k * dsd[0], 1: cg[1] * (v * (1.0 + td * td) / l),
           3: -k * dsd[3], 4: -k * dsd[4]}
    prime = [a * inv, w * inv, torch.ones_like(s_dot), ey_dot * inv, epsi_dot * inv, inv]
    D = {(0, "a"): inv, (1, "w"): inv}
    for c, ds_c in dsd.items():
        tinv = dinv * ds_c
        D[(0, c)] = a * tinv
        D[(1, c)] = w * tinv
        D[(5, c)] = tinv
        D[(3, c)] = dey.get(c, 0.0) * inv + ey_dot * tinv
        D[(4, c)] = dep[c] * inv + epsi_dot * tinv
    D[(4, 1)] = dep[1] * inv
    return prime, D


def build_kinematic_family(car_config, cfg, track_data=None) -> FMFamily:
    """Field-wise twin of problems.build_kinematic_problem: the pure
    kinematic bicycle (``configs/controllers/kinematic.yaml``), H = N + 1
    stages.  The solver state is z = [v, delta, s, ey, epsi, t, a_prev,
    w_prev] (NZ = 8), the controls (a, w) in physical units (NU = 2).  The
    running stages n < N carry the boundary, deviation and w costs, the
    a-slew against z[6] on 1 <= n < N and, with ``cfg["obstacles"]``, the
    barrier on (s, ey) = (z[2], z[3]); seven linear box rows (v floor, the
    steering box, the a and w boxes; the state rows masked at n = 0) and
    three padding rows; the regularized explicit Euler step with the
    steering stop.  Stage N carries the terminal cost (the speed hinge v >=
    v_max, time, ey^2, epsi^2), no constraint and holds its state.

    ``stage_derivs`` is in closed form: every cost and constraint row is
    linear, quadratic or a hinge in the fields but the barrier, whose
    gradient and (s, ey) Hessian block come from second-order jets over (s,
    ey); the Euler step's Jacobian is ``kc_prime_jacobian`` chained through
    the steering stop.  The JAX package differentiates this family by
    generic autodiff (``stage_derivs_cols``, no fast path)."""
    from vehicle_control_tpu_torch.models import kinematic_car as kc

    p = kc.KinematicCarParams.from_config(car_config)
    l = p.l
    N = int(cfg["horizon"])
    H = N + 1
    NZ, NU, NC = 8, 2, 10
    NW = NZ + NU
    w = {k: float(v) for k, v in cfg["cost_weights"].items()}
    ci = {k: float(v) for k, v in cfg["input_constraints"].items()}
    cs = {k: float(v) for k, v in cfg["state_constraints"].items()}
    rows = _obstacle_rows(track_data, bool(cfg.get("obstacles", False)))
    w_obs = w.get("obstacles", 0.0)
    # the linear rows: (row, field, slope) of c = slope * field + const
    box_rows = ((0, 0, -1.0), (1, 1, 1.0), (2, 1, -1.0), (3, NZ, 1.0), (4, NZ, -1.0),
                (5, NZ + 1, 1.0), (6, NZ + 1, -1.0))

    def stage_cost(n, wf, kv, ds_read):
        v, delta, s, ey, epsi, t = wf[:6]
        if n >= N:  # terminal
            over = torch.where(v >= cs["v_max"], (v - cs["v_max"]) ** 2, 0.0)
            return w["v"] * over + w["time"] * t + w["ey"] * ey**2 + w["epsi"] * epsi**2
        a_act, w_act = wf[NZ], wf[NZ + 1]
        dsn = ds_read(n)
        cost = fm.boundary_fields(ey, dsn, w["boundary"], cs["ey_min"], cs["ey_max"])
        cost = cost + w["deviation"] * dsn * ey**2
        cost = cost + w["w"] * w_act**2
        if n >= 1:  # a-slew against the previous action (no ds factor)
            cost = cost + w["a"] * (a_act - wf[6]) ** 2
        if rows:
            cost = cost + _obstacles_std(rows, s, ey, dsn, w_obs)
        return cost

    def constraints(n, wf):
        if n >= N:
            return [-1.0] * NC
        v, delta, a_act, w_act = wf[0], wf[1], wf[NZ], wf[NZ + 1]
        c = [cs["v_min"] - v, delta - cs["delta_max"], cs["delta_min"] - delta,
             a_act - ci["a_max"], ci["a_min"] - a_act, w_act - ci["w_max"],
             ci["w_min"] - w_act] + [-1.0] * 3
        if n == 0:
            # the state-only rows are undecidable at the fixed stage-0 state
            # (problems._mask_stage0_state_rows)
            c[:3] = [-1.0, -1.0, -1.0]
        return c

    def al_cost(n, wf, lam_read, mu, kv, ds_read):
        return stage_cost(n, wf, kv, ds_read) + fm.al_penalty_fields(
            constraints(n, wf), lam_read, mu
        )

    def dyn(n, wf, kv, ds_read):
        x6 = list(wf[:6])
        if n < N:
            h = ds_read(n)
            prime = kc_prime(x6, wf[NZ], wf[NZ + 1], kv, l)
            x6 = [x + h * q for x, q in zip(x6, prime)]
            # steering stop on the integrated delta (problems._sat_col)
            x6[1] = J.clip(x6[1], cs["delta_min"], cs["delta_max"])
        return tuple(x6) + (wf[NZ], wf[NZ + 1])

    def u_box(n, j):
        if j == 0:
            return ci["a_min"], ci["a_max"]
        return ci["w_min"], ci["w_max"]

    def stage_derivs(n, wf, lam, mu, kv, ds_read):
        ref = wf[0]
        for f in tuple(wf[1:]) + (kv, mu):
            ref = ref + 0.0 * f  # common broadcast shape of every input
        zero = torch.zeros_like(ref)
        dt = zero.dtype
        g = zero.new_zeros(zero.shape + (NW,))
        Hw = zero.new_zeros(zero.shape + (NW, NW))
        Jm = zero.new_zeros(zero.shape + (NZ, NW))
        for i in range(6):
            Jm[..., i, i] = 1.0
        Jm[..., 6, NZ] = 1.0  # stash_next = u
        Jm[..., 7, NZ + 1] = 1.0
        v, ey, epsi = wf[0], wf[3], wf[4]
        if n >= N:  # terminal: the speed hinge, time, ey^2, epsi^2; the state held
            live = (v >= cs["v_max"]).to(dt)
            g[..., 0] = w["v"] * (2.0 * (v - cs["v_max"])) * live + zero
            g[..., 3] = w["ey"] * (2.0 * ey) + zero
            g[..., 4] = w["epsi"] * (2.0 * epsi) + zero
            g[..., 5] = w["time"] + zero
            Hw[..., 0, 0] = (2.0 * w["v"]) * live + zero
            Hw[..., 3, 3] = 2.0 * w["ey"] + zero
            Hw[..., 4, 4] = 2.0 * w["epsi"] + zero
            return g, Hw, Jm
        dsn = ds_read(n)
        # the linear rows: slope max(0, lam + mu c) and curvature mu * active
        c_all = constraints(n, wf)
        for r, i, sl in box_rows:
            if n == 0 and r < 3:
                continue
            x = lam[r] + mu * c_all[r]
            g[..., i] += sl * torch.clamp_min(x, 0.0)
            Hw[..., i, i] += mu * _active(x, dt)
        blo, bhi = (ey < cs["ey_min"]).to(dt), (ey > cs["ey_max"]).to(dt)
        g[..., 3] += (w["boundary"] * dsn * (blo * (2.0 * (ey - cs["ey_min"]))
                                            + bhi * (2.0 * (ey - cs["ey_max"])))
                      + (w["deviation"] * dsn) * (2.0 * ey))
        Hw[..., 3, 3] += 2.0 * w["boundary"] * dsn * (blo + bhi) + 2.0 * w["deviation"] * dsn
        g[..., NZ + 1] += w["w"] * (2.0 * wf[NZ + 1])
        Hw[..., NZ + 1, NZ + 1] += 2.0 * w["w"]
        if n >= 1:  # the a-slew
            slew = w["a"] * (2.0 * (wf[NZ] - wf[6]))
            g[..., NZ] += slew
            g[..., 6] -= slew
            for r, c, sgn in ((NZ, NZ, 1.0), (6, 6, 1.0), (NZ, 6, -1.0), (6, NZ, -1.0)):
                Hw[..., r, c] += sgn * (2.0 * w["a"])
        if rows:  # the barrier's gradient and (s, ey) block from second-order jets
            se = Jet.seed([wf[2], ey], second=True)
            bar = _obstacles_std(rows, se[0], se[1], dsn, w_obs)
            g[..., 2:4] += bar.d.expand(zero.shape + (2,))
            Hw[..., 2:4, 2:4] += bar.h.expand(zero.shape + (2, 2))
        # the Euler step's Jacobian, row 1 through the steering stop
        h = dsn
        prime, D = kc_prime_jacobian(list(wf[:6]), wf[NZ], wf[NZ + 1], kv, l)
        stop = J._tie_weight(wf[1] + h * prime[1], cs["delta_min"]) * J._tie_weight(
            cs["delta_max"], J._vmax(wf[1] + h * prime[1], cs["delta_min"]))
        cols = {c: c for c in KC_PRIME_COLS}
        cols.update(a=NZ, w=NZ + 1)
        for (r, c), dv in D.items():
            Jm[..., r, cols[c]] += h * dv
        Jm[..., 1, :] *= stop.unsqueeze(-1) + 0.0 * zero.unsqueeze(-1)
        return g, Hw, Jm

    return FMFamily(
        NZ=NZ, NU=NU, NC=NC, H=H, N=N, tail="kinematic", al_cost=al_cost, dyn=dyn, u_box=u_box,
        stage_cost=stage_cost, constraints=constraints, stage_derivs=stage_derivs,
        params=p, weights=w, input_constraints=ci, state_constraints=cs, tail_constraints=None,
        obstacles=rows,
    )
