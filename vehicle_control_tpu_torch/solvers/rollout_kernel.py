"""Line-search costs in the array-of-structs layout: kernel 5 of the port
(counterpart of vehicle_control_tpu/solvers/rollout_kernel.py).

It computes what kernel 1 (``rollout_kernel_fm``) computes - the AL cost of
every step size's closed-loop rollout, with the next-state guard and the
per-stage control boxes - from the field-last inputs as the solver holds
them: Xref (B, H, NZ), Uref and kff (B, H, NU), Kfb (B, H, NU, NZ), lam
(B, H, NC), mu (B,), curv and ds (B, H), z0 (B, NZ).  One thread per
(step size, scenario) reads its own scenario's contiguous records, so
neighbouring threads read addresses H*F*4 bytes apart: this is the layout
half of the ablation whose other half is kernel 1's struct-of-arrays
(stage, field, scenario).  Like the JAX package's, it sits on no route of
the solver.

Its plain version is kernel 1's, :func:`linesearch_costs_plain`, on the
same numbers.  :class:`LinesearchKernelAoS` launches the CUDA kernel
(``csrc/rollout_aos.cu``) on CUDA tensors and runs the plain version on CPU
tensors; any other input raises.
"""

from __future__ import annotations

from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import LinesearchKernelFM


class LinesearchKernelAoS(LinesearchKernelFM):
    """Line-search costs for one family and step-size ladder, read in place
    from the (B, H, F) tensors (checked contiguous, as kernel 1's inputs are).

    ``launches`` counts the CUDA launches; the plain path does not count.
    """

    _kernel = "vct_linesearch_aos"
    _layout = staticmethod(lambda t: t)
