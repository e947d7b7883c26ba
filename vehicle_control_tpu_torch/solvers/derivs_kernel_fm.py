"""Per-stage derivatives: kernel 4 of the port (counterpart of
vehicle_control_tpu/solvers/derivs_kernel_fm.py).

For every (stage, scenario), the quantities the Riccati sweep consumes, over
w = (z (NZ), u (NU)): the AL-cost gradient g (B, H, NW), the unsymmetrized
Hessian Hw (B, H, NW, NW) with Hw[r, c] = d2L/dw_r dw_c, and the dynamics
Jacobian J (B, H, NZ, NW).  The solver symmetrizes Hw
(``riccati.riccati_from_derivs``).

:class:`DerivsKernelFM` launches the CUDA kernel (``csrc/derivs_fm.cu``) on
CUDA tensors and runs :func:`derivs_plain` on CPU tensors; any other input
raises.
"""

from __future__ import annotations

import torch

from vehicle_control_tpu_torch.solvers import cuda_lib
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import stage_derivatives


def derivs_plain(family, X, U, lam, mu, curv, ds):
    """The plain PyTorch version of kernel 4: the family's hand-derived stage
    derivatives at every stage, (g, Hw, J)."""
    return stage_derivatives(family, X, U, lam, mu, curv, ds)


class DerivsKernelFM:
    """Stage derivatives for one family.

    ``launches`` counts the CUDA launches; the plain path does not count.
    """

    def __init__(self, family):
        self.family = family
        self.launches = 0
        self._params = cuda_lib.family_params(family)
        self._entry = cuda_lib.entry(family, "vct_derivs_fm")  # the family's instantiation

    def __call__(self, X, U, lam, mu, curv, ds):
        if X.device.type == "cpu":
            return derivs_plain(self.family, X, U, lam, mu, curv, ds)
        if X.device.type != "cuda":
            raise ValueError(f"no derivatives kernel for device {X.device}")
        f = self.family
        B, H, NZ, NU, NC = X.shape[0], f.H, f.NZ, f.NU, f.NC
        NW = NZ + NU
        ins = dict(X=X, U=U, lam=lam, mu=mu, curv=curv, ds=ds)
        shapes = dict(X=(B, H, NZ), U=(B, H, NU), lam=(B, H, NC), mu=(B,), curv=(B, H),
                      ds=(B, H))
        cuda_lib.check_inputs(shapes, ins, X.device)
        soas = [cuda_lib.soa(t) for t in ins.values()]
        kw = dict(dtype=torch.float32, device=X.device)
        outs = (torch.empty(H, NW, B, **kw), torch.empty(H, NW, NW, B, **kw),
                torch.empty(H, NZ, NW, B, **kw))
        self.launch(soas, outs)
        return tuple(t.movedim(-1, 0).contiguous() for t in outs)

    def launch(self, soas, outs):
        """The kernel alone: inputs already in its layout (x, u, lam, mu,
        curv, ds as ``cuda_lib.soa`` gives them), outputs (g, hw, jm) of
        shapes (H, NW, B), (H, NW, NW, B), (H, NZ, NW, B), allocated."""
        lib = cuda_lib.load_library()
        B, H = soas[3].shape[0], self.family.H
        rc = getattr(lib, self._entry)(
            self._params.ctypes.data, *[t.data_ptr() for t in soas],
            *[t.data_ptr() for t in outs], B, H,
            torch.cuda.current_stream(soas[0].device).cuda_stream,
        )
        cuda_lib.check_launch(lib, rc, self._entry)
        self.launches += 1
