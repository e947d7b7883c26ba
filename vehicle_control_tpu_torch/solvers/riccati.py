"""Riccati backward sweep over the block-tridiagonal KKT system
(counterpart of vehicle_control_tpu/solvers/riccati.py), batch-first.

The 2-control case solves Quu + rho*I in closed form per lane; a lane whose
regularized Quu is not positive definite (a <= 0 or det <= 0) is flagged in
``fail`` and its step is computed with det replaced by 1, as in JAX.
"""

from __future__ import annotations

import torch


def solve2x2(a, b, d, r0, r1):
    """Solve [[a, b], [b, d]] x = r per lane; r0/r1 may carry trailing dims.
    Returns (x0, x1, bad)."""
    det = a * d - b * b
    bad = (a <= 0.0) | (det <= 0.0)
    inv_det = torch.where(bad, 1.0, 1.0 / torch.where(bad, 1.0, det))
    while inv_det.dim() < r0.dim():
        a, b, d, inv_det = (t.unsqueeze(-1) for t in (a, b, d, inv_det))
    x0 = (d * r0 - b * r1) * inv_det
    x1 = (a * r1 - b * r0) * inv_det
    return x0, x1, bad


def riccati_backward(lz, lu, lzz, luz, luu, A, B, rho):
    """Backward Riccati sweep.

    Args (batch-first, stage axis second):
      lz (Bt, H, nx), lu (Bt, H, 2): cost gradients
      lzz (Bt, H, nx, nx), luz (Bt, H, 2, nx), luu (Bt, H, 2, 2): Hessian blocks
      A (Bt, H, nx, nx), B (Bt, H, nx, 2): dynamics Jacobians
      rho (Bt,): Levenberg-Marquardt regularization added to Quu

    Returns (kff (Bt, H, 2), Kfb (Bt, H, 2, nx), dV1 (Bt,), dV2 (Bt,),
    fail (Bt,) bool).
    """
    Bt, H, nx = lz.shape
    nu = lu.shape[-1]
    if nu != 2:
        raise NotImplementedError("the closed-form Quu solve covers 2 controls")
    Vx = lz.new_zeros(Bt, nx)
    Vxx = lz.new_zeros(Bt, nx, nx)
    dV1 = lz.new_zeros(Bt)
    dV2 = lz.new_zeros(Bt)
    fail = torch.zeros(Bt, dtype=torch.bool, device=lz.device)
    kffs = lz.new_empty(Bt, H, nu)
    Kfbs = lz.new_empty(Bt, H, nu, nx)
    eye = torch.eye(nu, dtype=lz.dtype, device=lz.device)
    for n in reversed(range(H)):
        An, Bn = A[:, n], B[:, n]
        At, Bnt = An.transpose(-1, -2), Bn.transpose(-1, -2)
        Qx = lz[:, n] + (At @ Vx.unsqueeze(-1)).squeeze(-1)
        Qu = lu[:, n] + (Bnt @ Vx.unsqueeze(-1)).squeeze(-1)
        VxxA = Vxx @ An
        Qxx = lzz[:, n] + At @ VxxA
        Qux = luz[:, n] + Bnt @ VxxA
        Quu = luu[:, n] + Bnt @ (Vxx @ Bn)
        Quu = 0.5 * (Quu + Quu.transpose(-1, -2)) + rho[:, None, None] * eye
        rhs = torch.cat([Qu.unsqueeze(-1), Qux], dim=-1)  # (Bt, 2, 1 + nx)
        x0, x1, bad = solve2x2(Quu[:, 0, 0], Quu[:, 0, 1], Quu[:, 1, 1], rhs[:, 0], rhs[:, 1])
        sol = torch.stack([x0, x1], dim=1)
        kff = -sol[:, :, 0]
        Kfb = -sol[:, :, 1:]
        kffs[:, n] = kff
        Kfbs[:, n] = Kfb
        Kt = Kfb.transpose(-1, -2)
        Quuk = (Quu @ kff.unsqueeze(-1)).squeeze(-1)
        Quxt = Qux.transpose(-1, -2)
        Vx = (
            Qx
            + (Kt @ Quuk.unsqueeze(-1)).squeeze(-1)
            + (Kt @ Qu.unsqueeze(-1)).squeeze(-1)
            + (Quxt @ kff.unsqueeze(-1)).squeeze(-1)
        )
        Vxx = Qxx + Kt @ (Quu @ Kfb) + Kt @ Qux + Quxt @ Kfb
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        dV1 = dV1 + (kff * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (kff * Quuk).sum(-1)
        fail = fail | bad
    return kffs, Kfbs, dV1, dV2, fail


def riccati_from_derivs(nz, g, Hw, Jm, rho):
    """The sweep over stage derivatives as the derivatives kernels give them:
    g (Bt, H, nw), Hw (Bt, H, nw, nw) unsymmetrized, Jm (Bt, H, nz, nw),
    with w = (z (nz), u); the Hessian is symmetrized and split into blocks."""
    Hw = 0.5 * (Hw + Hw.transpose(-1, -2))
    return riccati_backward(
        g[..., :nz], g[..., nz:], Hw[..., :nz, :nz], Hw[..., nz:, :nz],
        Hw[..., nz:, nz:], Jm[..., :nz], Jm[..., nz:], rho,
    )
