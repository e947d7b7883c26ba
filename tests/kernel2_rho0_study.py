"""How far kernel 2's gains at the solver's rho0 sit from f64, against the
plain version's, on the CPU, with and without FMA contraction.

The inputs are those of ``chip_smoke.py``'s kernel-2 check at rho0: the drops
(``initial_states`` seed 0, the first ``--lanes`` of ``chip_smoke.B``) with
their aligned carries, one closed-loop step whose solve is the plain whole
solve at the main path's budget, and the next solve's inputs with its first
backward pass's X (as ``chip_smoke.warm_inputs``, whose CUDA timing this
skips).  It runs the plain backward pass (``backward_plain``) in float32 and
float64, and kernel 2's lane body built with g++ (``csrc/host_driver.cpp``,
as tests/test_torch_host_kernels.py builds it) three ways: with g++'s
defaults, with FMA contraction (``-mfma -ffp-contract=fast``) and without
(``-ffp-contract=off``).  For every float32 version it prints
``chip_smoke.lane_errors`` against float64 at chip_smoke's quantiles, per
output (kff, Kfb, dV1, dV2), on the lanes finite in all of them.

    JAX_PLATFORMS=cpu python tests/kernel2_rho0_study.py [--family singletrack] [--lanes 512]

About a minute for the single track at 512 lanes (the plain step takes most).
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import chip_smoke  # noqa: E402
from vehicle_control_tpu_torch.parallel.batch import (  # noqa: E402
    aligned_carry,
    initial_states,
    make_batched_racing_step,
)
from vehicle_control_tpu_torch.solvers.al_ilqr import rollout  # noqa: E402
from vehicle_control_tpu_torch.solvers import cuda_lib  # noqa: E402
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain  # noqa: E402
from vehicle_control_tpu_torch.solvers.riccati import riccati_from_derivs  # noqa: E402
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain  # noqa: E402

BUILDS = {"gxx_default": (), "fma": ("-O2", "-mfma", "-ffp-contract=fast"),
          "no_fma": ("-O2", "-mfma", "-ffp-contract=off")}
QUANTILES = (*chip_smoke.QUANT_FACTOR, 0.999, 1.0)
OUTPUTS = ("kff", "Kfb", "dV1", "dV2")


def check_inputs(label, lanes):
    """(family, kernel 2's inputs at the solver's rho0 on ``lanes`` lanes)."""
    env = chip_smoke.make_env(torch.device("cpu"))
    problem, _, cfg, _, _ = chip_smoke.family_problem(label, env)
    plain = lambda *a: solve_plain(problem.family, cfg, *a)[:7]  # noqa: E731
    step = make_batched_racing_step(problem, cfg, env["transition"], env["tdata"],
                                    chip_smoke.DT, 4, kernels=dict(solve_kernel=plain))
    states = torch.as_tensor(initial_states(env["track"].length, chip_smoke.B,
                                            np.random.default_rng(0)), dtype=torch.float32)
    states = states[:lanes]
    carry1, states1, _, _ = step(aligned_carry(problem, states), states)
    params, z0 = problem.init_horizon(states1, carry1.X_pred, carry1.U_pred)
    U = torch.clamp(carry1.U_pred, problem.u_lo, problem.u_hi).contiguous()
    X = torch.nan_to_num(rollout(problem.fns, params, z0, U)[0], nan=0.0, posinf=1e6,
                         neginf=-1e6).contiguous()
    mu = torch.full((lanes,), cfg.mu0)
    rho = torch.full((lanes,), cfg.rho0)
    return problem.family, (X, U, carry1.lam.contiguous(), mu, rho,
                            params.curvature.contiguous(), params.ds.contiguous())


def host_lib(flags):
    """The host build of the lane bodies with these extra g++ flags."""
    path, cmd = cuda_lib.host_library(flags)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([shutil.which("g++"), *cmd, "-o", path], check=True)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vct_host_backward.argtypes = [P] + [P] * 11 + [I, I]
    lib.vct_host_derivs.argtypes = [P] * 10 + [I, I]
    return lib


def host_backward(fam, args, flags):
    """Kernel 2's host build on ``args``."""
    import test_torch_host_kernels as hk

    hk.B = args[0].shape[0]
    return hk.host_backward(host_lib(flags), fam, *args)


def host_derivs_plain_riccati(fam, args):
    """Kernel 4's host build (g++'s defaults) for the stage derivatives, the
    plain Riccati sweep on them: which half of kernel 2 moves the gains."""
    import test_torch_host_kernels as hk

    X, U, lam, mu, rho, curv, ds = args
    hk.B = X.shape[0]
    g, Hw, Jm = hk.host_derivs(host_lib(()), fam, X, U, lam, mu, curv, ds)
    return riccati_from_derivs(fam.NZ, g, Hw, Jm, rho)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="singletrack",
                    choices=[f for f, v in chip_smoke.FAMILIES.items() if v[1] != "kinematic"])
    ap.add_argument("--lanes", type=int, default=512)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.time()
    fam, ins = check_inputs(args.family, args.lanes)
    print(f"inputs: {time.time() - t0:.1f} s, {args.lanes} lanes", flush=True)
    ref64 = backward_plain(fam, *(t.double() for t in ins))
    runs = {"plain32": backward_plain(fam, *ins)}
    if shutil.which("g++"):
        for name, flags in BUILDS.items():
            runs[name] = host_backward(fam, ins, flags)
        runs["host_derivs+plain_riccati"] = host_derivs_plain_riccati(fam, ins)
    ok = chip_smoke.finite_lanes(list(ref64[:4]))
    for out in runs.values():
        ok &= chip_smoke.finite_lanes(list(out[:4]))
    print(f"lanes finite in every version: {int(ok.sum())} of {args.lanes}")
    for i, key in enumerate(OUTPUTS):
        for name, out in runs.items():
            err = chip_smoke.lane_errors(out[i][ok], ref64[i][ok])
            qs = " ".join(f"q{q:g}:{torch.quantile(err, q).item():.3e}" for q in QUANTILES)
            print(f"{key} {name}: {qs}", flush=True)


if __name__ == "__main__":
    main()
