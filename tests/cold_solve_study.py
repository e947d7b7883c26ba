"""How far f32 versions of the whole solve part on the cold first solve of
``chip_smoke.py``'s check (ii), on the CPU.

The inputs are those of the first solve of the closed-loop step that
``chip_smoke.warm_inputs`` takes (``initial_states`` seed 0 at B = 4096,
their aligned carries, the step's horizon set-up), cut to the first
``--lanes`` lanes, for one family at ``chip_smoke.py``'s horizon and budget.
It runs, in float32 unless named:

* ``plain32``, ``plain64``: the plain whole solve (``solve_plain``);
* ``plain32_ulp``: the same on inputs whose first state field is moved up
  by one float32 ulp;
* ``host32``: kernel 3's lane body built with g++ (``csrc/host_driver.cpp``,
  as tests/test_torch_host_kernels.py builds it; skipped without g++);
* ``jax32``, ``jax64``: the JAX package's XLA solver (``build_solver``,
  ``jit(vmap)``; x64 off, then on);

and prints ``chip_smoke.solve_numbers`` (converged flags, flips, cost
median, iterations) for every pair.

    JAX_PLATFORMS=cpu python tests/cold_solve_study.py [--family singletrack] [--lanes 256]

About 3 minutes for the single track at 256 lanes on 4 CPU threads.
"""

import argparse
import ctypes
import os
import shutil
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
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain  # noqa: E402


class _Inputs(Exception):
    pass


def first_solve_inputs(label, lanes):
    """(problem, solver config, chip_smoke's environment, the first solve's
    inputs on ``lanes`` lanes)."""
    env = chip_smoke.make_env(torch.device("cpu"))
    problem, budget, cfg, _, _ = chip_smoke.family_problem(label, env)

    def capture(*args):
        raise _Inputs(tuple(t.contiguous() for t in args))

    step = make_batched_racing_step(problem, cfg, env["transition"], env["tdata"],
                                    chip_smoke.DT, 4, kernels=dict(solve_kernel=capture))
    states = torch.as_tensor(initial_states(env["track"].length, chip_smoke.B,
                                            np.random.default_rng(0)), dtype=torch.float32)
    states = states[:lanes]
    try:
        step(aligned_carry(problem, states), states)
    except _Inputs as e:
        return problem, cfg, env, e.args[0]
    raise RuntimeError("the step never called its solve")


def host_solve(fam, cfg, ins):
    """Kernel 3's host build, or None without g++."""
    import test_torch_host_kernels as hk

    if shutil.which("g++") is None:
        return None
    lib = ctypes.CDLL(hk._build_all(shutil.which("g++"))["team4"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vct_host_solve.argtypes = [P, P] + [P] * 11 + [I, I]
    hk.B = ins[0].shape[0]
    return hk.host_solve(lib, fam, cfg, *ins)


def jax_solves(label, problem, cfg, env, ins):
    """{'jax32': ..., 'jax64': ...}: the JAX package's XLA solver on the same
    inputs, as (converged, cost, iterations) tensors at indices 5, 3, 6."""
    import jax
    import jax.numpy as jnp

    from vehicle_control_tpu.controllers.mpc import problems as jproblems
    from vehicle_control_tpu.environment.track import Track
    from vehicle_control_tpu.solvers import ALILQRConfig
    from vehicle_control_tpu.solvers.al_ilqr import build_solver
    from vehicle_control_tpu.utils.config import load_config

    ctrl_yaml, tail, horizon, budget = chip_smoke.FAMILIES[label]
    ctrl = dict(load_config(f"{env['root']}/configs/controllers/{ctrl_yaml}"), obstacles=False,
                **horizon)
    track = Track(load_config(f"{env['root']}/configs/environment/ippodromo.yaml"))
    out = {}
    for name, x64 in (("jax32", False), ("jax64", True)):
        jax.config.update("jax_enable_x64", x64)
        dt = jnp.float64 if x64 else jnp.float32
        jprob = jproblems.build_cascaded_problem(env["car"], track, ctrl, tail, dt)
        solve = build_solver(jprob.fns, jprob.horizon, ALILQRConfig(**budget), jprob.u_lo,
                             jprob.u_hi)
        z0, U, lam, curv, ds = (jnp.asarray(t.double().numpy(), dt) for t in ins)
        ref = jax.jit(jax.vmap(solve))(jproblems.HorizonParams(curv, ds), z0, U, lam)
        row = [None] * 7
        row[3] = torch.as_tensor(np.array(ref.cost, np.float64))
        row[5] = torch.as_tensor(np.array(ref.converged))
        row[6] = torch.as_tensor(np.array(ref.iterations, np.int32))
        out[name] = tuple(row)
    jax.config.update("jax_enable_x64", False)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="singletrack", choices=list(chip_smoke.FAMILIES))
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    problem, cfg, env, ins = first_solve_inputs(args.family, args.lanes)
    fam = problem.family
    z0_ulp = ins[0].clone()
    z0_ulp[:, 0] = torch.nextafter(z0_ulp[:, 0], torch.full_like(z0_ulp[:, 0], torch.inf))
    runs = {
        "plain32": lambda: solve_plain(fam, cfg, *ins),
        "plain64": lambda: solve_plain(fam, cfg, *(t.double() for t in ins)),
        "plain32_ulp": lambda: solve_plain(fam, cfg, z0_ulp, *ins[1:]),
        "host32": lambda: host_solve(fam, cfg, ins),
    }
    res = {}
    for name, fn in runs.items():
        t0 = time.time()
        out = fn()
        if out is not None:
            res[name] = out
            print(f"{name}: {time.time() - t0:.1f} s, converged {out[5].float().mean():.4f}",
                  flush=True)
    if not args.no_jax:
        res.update(jax_solves(args.family, problem, cfg, env, ins))
    names = list(res)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            n = chip_smoke.solve_numbers(res[a], res[b])
            print(f"{a} vs {b}: " + " ".join(f"{k}={v:.4g}" for k, v in n.items()), flush=True)


if __name__ == "__main__":
    main()
