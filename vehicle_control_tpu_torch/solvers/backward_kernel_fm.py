"""Fused backward pass: kernel 2 of the port (counterpart of
vehicle_control_tpu/solvers/backward_kernel_fm.py).

At every stage, from the last to the first: the hand-derived AL-cost
gradient, symmetrized Hessian and dynamics Jacobian of the family
(``FMFamily.stage_derivs``), consumed at once by the Riccati step with the
closed-form 2x2 solve of Quu + rho*I.  Outputs: kff (B, H, 2),
Kfb (B, H, 2, NZ), dV1 (B,), dV2 (B,) and the PD-failure flag (B,) bool.

:class:`BackwardKernelFM` launches the CUDA kernel (``csrc/backward_fm.cu``)
on CUDA tensors and runs :func:`backward_plain` on CPU tensors; any other
input raises.
"""

from __future__ import annotations

import torch

from vehicle_control_tpu_torch.solvers import cuda_lib
from vehicle_control_tpu_torch.solvers.riccati import riccati_from_derivs


def stage_derivatives(family, X, U, lam, mu, curv, ds):
    """Per-stage (g (B,H,NW), Hw (B,H,NW,NW) unsymmetrized, J (B,H,NZ,NW))."""
    gs, Hs, Js = [], [], []
    for n in range(family.H):
        wf = tuple(X[:, n].unbind(-1)) + tuple(U[:, n].unbind(-1))
        g, Hw, Jm = family.stage_derivs(
            n, wf, list(lam[:, n].unbind(-1)), mu, curv[:, n], lambda i: ds[:, i]
        )
        gs.append(g)
        Hs.append(Hw)
        Js.append(Jm)
    return torch.stack(gs, 1), torch.stack(Hs, 1), torch.stack(Js, 1)


def backward_plain(family, X, U, lam, mu, rho, curv, ds):
    """The plain PyTorch version of kernel 2: stage derivatives, then Riccati."""
    g, Hw, Jm = stage_derivatives(family, X, U, lam, mu, curv, ds)
    return riccati_from_derivs(family.NZ, g, Hw, Jm, rho)


class BackwardKernelFM:
    """Fused derivatives + Riccati for one family.

    ``launches`` counts the CUDA launches; the plain path does not count.
    """

    def __init__(self, family):
        if family.NU != 2:
            raise ValueError("the closed-form Quu solve covers 2 controls")
        self.family = family
        self.launches = 0
        self._params = cuda_lib.family_params(family)
        self._entry = cuda_lib.entry(family, "vct_backward_fm")  # the family's instantiation

    def __call__(self, X, U, lam, mu, rho, curv, ds):
        if X.device.type == "cpu":
            return backward_plain(self.family, X, U, lam, mu, rho, curv, ds)
        if X.device.type != "cuda":
            raise ValueError(f"no backward kernel for device {X.device}")
        f = self.family
        B, H, NZ, NU, NC = X.shape[0], f.H, f.NZ, f.NU, f.NC
        ins = dict(X=X, U=U, lam=lam, mu=mu, rho=rho, curv=curv, ds=ds)
        shapes = dict(X=(B, H, NZ), U=(B, H, NU), lam=(B, H, NC), mu=(B,), rho=(B,),
                      curv=(B, H), ds=(B, H))
        cuda_lib.check_inputs(shapes, ins, X.device)
        lib = cuda_lib.load_library()
        soas = [cuda_lib.soa(t) for t in ins.values()]
        kw = dict(dtype=torch.float32, device=X.device)
        kff = torch.empty(H, NU, B, **kw)
        kfb = torch.empty(H, NU, NZ, B, **kw)
        dv = torch.empty(2, B, **kw)
        fail = torch.empty(B, **kw)
        rc = getattr(lib, self._entry)(
            self._params.ctypes.data, *[t.data_ptr() for t in soas],
            kff.data_ptr(), kfb.data_ptr(), dv.data_ptr(), fail.data_ptr(), B, H,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
        cuda_lib.check_launch(lib, rc, self._entry)
        self.launches += 1
        return (
            kff.movedim(-1, 0).contiguous(), kfb.movedim(-1, 0).contiguous(),
            dv[0], dv[1], fail > 0.5,
        )
