"""Line-search costs: kernel 1 of the port (counterpart of
vehicle_control_tpu/solvers/rollout_kernel_fm.py).

For each of A step sizes and each scenario, a closed-loop rollout
``u = clip(Uref + alpha*kff + Kfb (z - Xref), u_box)`` sums the family's AL
stage cost and steps its dynamics; a rollout whose next state goes
non-finite or reaches |z| >= 1e7 costs +inf.  Output: costs (A, B).

:class:`LinesearchKernelFM` launches the CUDA kernel (``csrc/rollout_fm.cu``)
on CUDA tensors and runs :func:`linesearch_costs_plain` on CPU tensors; any
other input raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vehicle_control_tpu_torch.solvers import cuda_lib


def feedback_controls(family, n, z, alpha, Xref, Uref, kffs, Kfbs):
    """u = clip(Uref + alpha*kff + Kfb (z - Xref), u_box) at stage n: the
    closed-loop law of the line search and of the re-roll of its choice.
    ``z`` is the list of NZ state fields; ``alpha`` broadcasts against them."""
    dz = [z[i] - Xref[:, n, i] for i in range(family.NZ)]
    u = []
    for j in range(family.NU):
        fb = dz[0] * Kfbs[:, n, j, 0]
        for i in range(1, family.NZ):
            fb = fb + dz[i] * Kfbs[:, n, j, i]
        lo, hi = family.u_box(n, j)
        u.append(torch.clamp(Uref[:, n, j] + alpha * kffs[:, n, j] + fb, lo, hi))
    return u


def linesearch_costs_plain(family, alphas, Xref, Uref, kffs, Kfbs, lam, mu, curv, ds, z0):
    """The plain PyTorch version of kernel 1, batched over (A, B)."""
    al = torch.as_tensor(list(alphas), dtype=Xref.dtype, device=Xref.device)[:, None]
    z = [z0[:, i] + 0.0 * al for i in range(family.NZ)]  # (A, B) fields
    acc = torch.zeros_like(z[0])
    for n in range(family.H):
        u = feedback_controls(family, n, z, al, Xref, Uref, kffs, Kfbs)
        wf = tuple(z) + tuple(u)
        kv = curv[:, n]
        ds_read = lambda i: ds[:, i]  # noqa: E731
        cost = family.al_cost(n, wf, lambda j: lam[:, n, j], mu, kv, ds_read)
        z = list(family.dyn(n, wf, kv, ds_read))
        finite = torch.ones_like(acc, dtype=torch.bool)
        for f in z:
            finite &= torch.isfinite(f) & (torch.abs(f) < 1e7)
        acc = torch.where(finite, acc + cost, torch.inf)
    return torch.where(torch.isfinite(acc), acc, torch.inf)


class LinesearchKernelFM:
    """Line-search costs for one family and step-size ladder.

    ``launches`` counts the CUDA launches; the plain path does not count.
    """

    _entry = "vct_linesearch_fm"  # the kernel's C entry point
    _layout = staticmethod(cuda_lib.soa)  # (B, ...) input -> the layout it reads

    def __init__(self, family, alphas):
        if not 1 <= len(alphas) <= cuda_lib.MAX_ALPHA:
            raise ValueError(f"1..{cuda_lib.MAX_ALPHA} step sizes, got {len(alphas)}")
        self.family = family
        self.alphas = [float(a) for a in alphas]
        self.launches = 0
        self._params = cuda_lib.family_params(family)
        self._alphas = np.asarray(self.alphas, np.float32)

    def __call__(self, Xref, Uref, kffs, Kfbs, lam, mu, curv, ds, z0):
        if Xref.device.type == "cpu":
            return linesearch_costs_plain(
                self.family, self.alphas, Xref, Uref, kffs, Kfbs, lam, mu, curv, ds, z0
            )
        if Xref.device.type != "cuda":
            raise ValueError(f"no line-search kernel for device {Xref.device}")
        f = self.family
        B, H, A = Xref.shape[0], f.H, len(self.alphas)
        NZ, NU, NC = f.NZ, f.NU, f.NC
        ins = dict(Xref=Xref, Uref=Uref, kffs=kffs, Kfbs=Kfbs, lam=lam, mu=mu,
                   curv=curv, ds=ds, z0=z0)
        shapes = dict(Xref=(B, H, NZ), Uref=(B, H, NU), kffs=(B, H, NU),
                      Kfbs=(B, H, NU, NZ), lam=(B, H, NC), mu=(B,), curv=(B, H),
                      ds=(B, H), z0=(B, NZ))
        cuda_lib.check_inputs(shapes, ins, Xref.device)
        laid = [self._layout(t) for t in ins.values()]
        costs = torch.empty(A, B, dtype=torch.float32, device=Xref.device)
        self.launch(laid, costs)
        return costs

    def launch(self, laid, costs):
        """The kernel alone: inputs already in its layout (``_layout`` of
        Xref, Uref, kffs, Kfbs, lam, mu, curv, ds, z0), costs (A, B) allocated."""
        lib = cuda_lib.load_library()
        B, H = costs.shape[1], self.family.H
        rc = getattr(lib, self._entry)(
            self._params.ctypes.data, self._alphas.ctypes.data, len(self.alphas),
            *[t.data_ptr() for t in laid], costs.data_ptr(), B, H,
            torch.cuda.current_stream(costs.device).cuda_stream,
        )
        cuda_lib.check_launch(lib, rc, self._entry)
        self.launches += 1
