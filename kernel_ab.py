"""Kernels 2 and 3 of the port against other builds of themselves, in turns,
on one NVIDIA GPU.

Builds, all at once, the port's kernel library (``csrc/``: a team of 4
threads per scenario) and two variants of kernels 2 and 3 from the same
sources, which differ only in nvcc flags: teams of 8 (``-DVCT_TEAM=8``) and
no FMA contraction (``-fmad=false``).  With
``--baseline DIR`` it also builds the two kernels from the ``solve_fm.cu``
and ``backward_fm.cu`` in DIR (for example an earlier commit's ``csrc/``,
unpacked into an ignored folder), which must take the same C arguments.

Then, for the single-track family and the cascade at ``chip_smoke.py``'s
shapes and budgets, on the same warm-started inputs
(``chip_smoke.warm_inputs``), it times one launch of every build's kernel 3
(the main path's budget) and kernel 2 (at the solver's rho0) with CUDA
events, the builds in turns (forward order, then backward, ``--reps``
rounds), and reports the median and the two modes of each
(``chip_smoke.time_modes``), whether each build gives the
port's outputs bit for bit, how far from them the others' lie, and each
build's distance from the plain version in ``chip_smoke.py``'s check (i)
(one outer x one inner iteration at rho0 = 1).

    python3 kernel_ab.py [--baseline DIR] [--reps 10] [--out FILE]

Prints the card's ``nvidia-smi`` name and power limit, one line per build
and family, and a JSON line of all numbers (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke

def _flags(*extra):
    from vehicle_control_tpu_torch.solvers.cuda_lib import NVCC_FLAGS

    return NVCC_FLAGS + extra


VARIANTS = {  # build -> its nvcc flags (the port's library is "team4")
    "team8": lambda: _flags("-DVCT_TEAM=8"),
    "team4_no_fma": lambda: _flags("-fmad=false"),
}
TEAM_SOURCES = ("solve_fm.cu", "backward_fm.cu")


def load(path, team):
    """A build's library; ``team``: it reports its launch shape."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    names = ("vct_solve_fm", "vct_backward_fm")
    if team:
        names += ("vct_solve_fm_info", "vct_backward_fm_info")
    return cuda_lib.declare(ctypes.CDLL(path), names)


def build_all(baseline):
    """{build: (library path, seconds)}, the builds run side by side."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    jobs = {"team4": dict()}
    team_srcs = [os.path.join(cuda_lib.CSRC, s) for s in TEAM_SOURCES]
    jobs.update({k: dict(sources=team_srcs, flags=v()) for k, v in VARIANTS.items()})
    if baseline:
        jobs["baseline"] = dict(sources=[os.path.join(baseline, s) for s in TEAM_SOURCES])

    def timed(kw):
        t0 = time.perf_counter()
        return cuda_lib.build_library(**kw), time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, kw) for k, kw in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def lane_err(a, b):
    """chip_smoke.lane_errors of (..., B) tensors."""
    return chip_smoke.lane_errors(a.movedim(-1, 0), b.movedim(-1, 0))


def same_bits(outs, ref):
    return all(chip_smoke.same_bits(a, b) for a, b in zip(outs, ref))


def modes(times):
    """chip_smoke.time_modes as 'count x median' of each mode, fastest first."""
    return "/".join(f"{len(m)}x{statistics.median(m):.3f}" for m in chip_smoke.time_modes(times))


def run_family(label, env, libs, reps):
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain

    problem, budget, cfg, main_step, shape = chip_smoke.family_problem(label, env)
    fam, H, dev = problem.family, problem.family.H, env["dev"]
    w = chip_smoke.warm_inputs(problem, cfg, main_step, env)
    B, NZ, NU, NC = chip_smoke.B, fam.NZ, fam.NU, fam.NC
    params, scfg = cuda_lib.family_params(fam), cuda_lib.solve_config(cfg)
    rho = torch.full((B,), cfg.rho0, dtype=torch.float32, device=dev)
    sv_in = [cuda_lib.soa(w[k]) for k in ("z0", "U_init", "lam", "curv", "ds")]
    bw_in = [cuda_lib.soa(t) for t in (w["X"], w["U"], w["lam"], w["mu"], rho, w["curv"],
                                       w["ds"])]
    kw = dict(dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sv_out, bw_out, calls = {}, {}, {}
    for name, lib in libs.items():
        sv_out[name] = [torch.empty(s, **kw) for s in ((H, NZ, B), (H, NU, B), (H, NC, B),
                                                        (H, NU, B), (H, NU, NZ, B),
                                                        (cuda_lib.SOLVE_STATS, B))]
        bw_out[name] = [torch.empty(s, **kw)
                        for s in ((H, NU, B), (H, NU, NZ, B), (2, B), (B,))]
        sv_args, bw_args = sv_in + sv_out[name], bw_in + bw_out[name]

        def solve(lib=lib, args=sv_args, config=scfg):
            rc = lib.vct_solve_fm(params.ctypes.data, ctypes.addressof(config),
                                  *[t.data_ptr() for t in args], B, H, stream)
            if rc:
                raise RuntimeError(f"solve_fm: CUDA error {rc}")

        def backward(lib=lib, args=bw_args):
            rc = lib.vct_backward_fm(params.ctypes.data, *[t.data_ptr() for t in args], B, H,
                                     stream)
            if rc:
                raise RuntimeError(f"backward_fm: CUDA error {rc}")

        calls[name] = dict(solve=solve, backward=backward)
    names = list(libs)
    times = {(n, k): [] for n in names for k in ("solve", "backward")}
    for n in names:  # warm-up, and the outputs compared below
        calls[n]["solve"]()
        calls[n]["backward"]()
    torch.cuda.synchronize()
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            for k in ("solve", "backward"):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                calls[n][k]()
                end.record()
                torch.cuda.synchronize()
                times[n, k].append(start.elapsed_time(end))
    # chip_smoke's check (i) for every build: one iteration at rho0 = 1
    # against the plain version (the builds' outputs are overwritten)
    well = chip_smoke.well_config(budget)
    ref = solve_plain(fam, well, *(w[k] for k in ("z0", "U_init", "lam", "curv", "ds")),
                      trace=True)
    well_rows = {}
    for n in names:
        calls[n]["solve"](config=cuda_lib.solve_config(well))
        X, U, st = sv_out[n][0].movedim(-1, 0), sv_out[n][1].movedim(-1, 0), sv_out[n][5]
        same = st[4] == ref[7]["first_alpha"]
        well_rows[n] = dict(
            well_step_same=same.float().mean().item(),
            well_X_max=chip_smoke.lane_errors(X[same], ref[0][same]).max().item(),
            well_U_max=chip_smoke.lane_errors(U[same], ref[1][same]).max().item(),
            well_U_worst=chip_smoke.worst_entry(U[same], ref[1][same]))
        calls[n]["solve"]()  # the main path's budget again, for the comparisons below
    res = {}
    ref_sv, ref_bw = sv_out["team4"], bw_out["team4"]
    for n in names:
        sv, bw = sv_out[n], bw_out[n]
        row = dict(solve_ms=statistics.median(times[n, "solve"]),
                   backward_ms=statistics.median(times[n, "backward"]),
                   solve_modes=modes(times[n, "solve"]),
                   backward_modes=modes(times[n, "backward"]),
                   solve_ms_min=min(times[n, "solve"]),
                   backward_ms_min=min(times[n, "backward"]),
                   solve_bitwise=same_bits(sv[:3] + sv[5:], ref_sv[:3] + ref_sv[5:]),
                   backward_bitwise=same_bits(bw, ref_bw))
        if n != "team4":
            fin = torch.isfinite(ref_bw[0]).all(0).all(0) & torch.isfinite(bw[0]).all(0).all(0)
            row.update(
                solve_same_first_step=(sv[5][4] == ref_sv[5][4]).float().mean().item(),
                solve_converged=f"{sv[5][2].mean().item():.4f}/{ref_sv[5][2].mean().item():.4f}",
                solve_X_err_median=lane_err(sv[0], ref_sv[0]).median().item(),
                backward_fail_lanes=f"{int(bw[3].sum())}/{int(ref_bw[3].sum())}",
                backward_kfb_err_median=lane_err(bw[1][..., fin],
                                                 ref_bw[1][..., fin]).median().item(),
            )
        row.update(well_rows[n])
        res[n] = row
        chip_smoke.phase(f"{label}:{n}", **shape,
                         **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in row.items()})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a folder with solve_fm.cu and backward_fm.cu to compare")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from vehicle_control_tpu_torch.solvers import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(chip_smoke.DEVICE, 0)
    _, smi = chip_smoke.card_line()
    print(smi, flush=True)
    built = build_all(args.baseline)
    libs, builds = {}, {}
    for name, (path, seconds) in built.items():
        lib = cuda_lib.load_library() if name == "team4" else load(path, name != "baseline")
        libs[name] = lib
        info = {}
        if name != "baseline":
            info = {k: cuda_lib.launch_info(fn, chip_smoke.B) for k, fn in
                    (("solve", lib.vct_solve_fm_info), ("backward", lib.vct_backward_fm_info))}
        builds[name] = dict(build_s=seconds, library=os.path.basename(path), launch=info)
        chip_smoke.phase(f"build:{name}", seconds=f"{seconds:.1f}",
                         **{f"{k}_{f}": v for k, i in info.items() for f, v in i.items()
                            if f in ("team", "registers", "stack_bytes", "smem_bytes_per_block",
                                     "warps_per_sm")})
        chip_smoke.print_ptxas(path)
    env = chip_smoke.make_env(dev)
    families = {label: run_family(label, env, libs, args.reps) for label in chip_smoke.FAMILIES}
    line = json.dumps(dict(card=smi, reps=args.reps, builds=builds, families=families))
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
