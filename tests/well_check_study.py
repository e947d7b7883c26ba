"""Check (i) of ``chip_smoke.py`` on the obstacle cascade, on the CPU, with
kernel 3's host build as the second f32 version.

On the inputs ``chip_smoke.warm_inputs`` makes (``initial_states`` seed 0
clear of the discs, their aligned carries, one closed-loop step of the plain
whole solve, the next solve's inputs) at ``--lanes`` lanes, it runs one
outer x one inner iteration at rho0 = RHO_WELL (``chip_smoke.well_config``)
in float32 by kernel 3's lane body built with g++ (``csrc/host_driver.cpp``,
as tests/test_torch_host_kernels.py builds it) and by the plain version
(``solve_plain``), and in float64 by the plain version.  It prints the
lanes beyond SOLVE_TOL of each other, those where the f64 witness on the
lane's own inputs gives the plain version (the kernel's error against f64
more than 4x the plain f32 version's), and for each of them both f32
versions' mean, median and largest error against f64 on the lane's inputs
and ULP_COPIES copies of them one ulp apart (``chip_smoke.copies_side``'s
rule: the kernel's mean at most 4x the plain version's).

    JAX_PLATFORMS=cpu python tests/well_check_study.py [--lanes 512]

About 8 minutes at 512 lanes on 8 CPU threads (the plain whole solve of the
warm-up step takes most of it); needs g++.
"""

import argparse
import ctypes
import os
import shutil
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import chip_smoke  # noqa: E402
import test_torch_host_kernels as hk  # noqa: E402
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain  # noqa: E402


class _CpuEvent:
    """Stands in for torch.cuda.Event in ``chip_smoke.PlainSolve`` on the CPU."""

    def __init__(self, **_):
        pass

    def record(self):
        pass

    def elapsed_time(self, _):
        return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=512)
    args = ap.parse_args()
    torch.set_num_threads(8)
    chip_smoke.B = args.lanes
    torch.cuda.Event, torch.cuda.synchronize = _CpuEvent, lambda *a, **k: None
    env = chip_smoke.make_env(torch.device("cpu"))
    problem, budget, cfg, _, _ = chip_smoke.family_problem("cascaded_obstacles", env)
    fam = problem.family
    t0 = time.time()
    w = chip_smoke.warm_inputs("cascaded_obstacles", problem, cfg, env)
    print(f"warm inputs {time.time() - t0:.0f} s", flush=True)
    sv_args = tuple(w[k] for k in ("z0", "U_init", "lam", "curv", "ds"))
    well = chip_smoke.well_config(budget)
    lib = ctypes.CDLL(hk._build_all(shutil.which("g++"))["team4"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vct_host_solve.argtypes = [P, P] + [P] * 11 + [I, I]

    def kernel(*ins):
        hk.B = ins[0].shape[0]
        return hk.host_solve(lib, fam, well, *ins)

    def plain(*ins):
        return solve_plain(fam, well, *ins, trace=True)

    got, ref = kernel(*sv_args), plain(*sv_args)
    ref64 = plain(*(t.double() for t in sv_args))
    same = got[7]["first_alpha"] == ref[7]["first_alpha"]
    err = chip_smoke.solve_errors(got, ref)
    kern64, plain64 = chip_smoke.solve_errors(got, ref64), chip_smoke.solve_errors(ref, ref64)
    disputed = same & ~(err <= chip_smoke.SOLVE_TOL)
    factor = max(chip_smoke.QUANT_FACTOR.values())
    lost = (disputed & ~(kern64 <= factor * plain64 + chip_smoke.LS_FLOOR)).nonzero()[:, 0]
    print(f"lanes={args.lanes} same_step={int(same.sum())} disputed={int(disputed.sum())} "
          f"given_to_plain_on_the_inputs={len(lost)}")
    if not len(lost):
        return
    side, _ = chip_smoke.copies_side(lost, kernel, plain, chip_smoke.solve_errors, sv_args,
                                     chip_smoke.LS_FLOOR)
    ins = [torch.cat([t[lost], c]) for t, c in zip(sv_args, chip_smoke.ulp_copies(sv_args, lost))]
    d = plain(*(t.double() for t in ins))
    n = len(lost)
    ek = chip_smoke.solve_errors(kernel(*ins), d).reshape(-1, n)
    ep = chip_smoke.solve_errors(plain(*ins), d).reshape(-1, n)
    for i, lane in enumerate(lost.tolist()):
        a, b = ek[:, i], ep[:, i]
        print(f"lane {lane}: on its inputs kernel/plain vs f64 {kern64[lane]:.3g}/"
              f"{plain64[lane]:.3g}; on {len(a)} copies mean {a.mean():.3g}/{b.mean():.3g} "
              f"median {a.median():.3g}/{b.median():.3g} max {a.max():.3g}/{b.max():.3g}; "
              f"copies_side={bool(side[i])}")


if __name__ == "__main__":
    main()
