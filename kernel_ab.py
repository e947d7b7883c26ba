"""The port's kernels against other builds of themselves, in turns, on one
NVIDIA GPU.

Builds, all at once, the port's kernel library (``csrc/``, "port") and
variants of some of its kernels from the same sources, which differ only in
nvcc flags (``VARIANTS``: teams of 8 and no FMA contraction for kernels 2
and 3).  With ``--baseline DIR`` it also builds every kernel from the
``.cu`` files in DIR (for example an earlier commit's ``csrc/``, unpacked
into an ignored folder), which must take the same C arguments.

Then, for the single-track family and the cascade at ``chip_smoke.py``'s
shapes and budgets, on the same warm-started inputs
(``chip_smoke.warm_inputs``, computed by no kernel), it times one launch of
each build's kernels with CUDA events: 3 (the whole solve, the main path's
budget), 2 (the backward pass at the solver's rho0), 4 (the stage
derivatives), 1 and 5 (the line search at rho0, under the plain backward
pass's gains), each on inputs already in its layout, the builds in turns
(forward order, then backward, ``--reps`` rounds) with the card's SM clock
sampled beside them (``chip_smoke.sampled_clocks``).  It reports each
build's median, minimum and timing modes with their clocks, whether its
kernels 1, 2, 3 and 5 give the port's outputs bit for bit (kernels 1 and 5
at both of ``chip_smoke.py``'s regularizations), kernel 4's largest
difference from the port's, and for kernel 3 each build's distance from the
plain version in ``chip_smoke.py``'s check (i) (one outer x one inner
iteration at rho0 = 1).

    python3 kernel_ab.py [--baseline DIR] [--variants team8,team4_no_fma] [--reps 10]
                         [--out FILE]

Prints the card's ``nvidia-smi`` name and power limit, one line per build
and family, and a JSON line of all numbers (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke

KERNELS = {  # kernel -> (C entry, source, launch-shape entry or None)
    "solve": ("vct_solve_fm", "solve_fm.cu", "vct_solve_fm_info"),
    "backward": ("vct_backward_fm", "backward_fm.cu", "vct_backward_fm_info"),
    "derivs": ("vct_derivs_fm", "derivs_fm.cu", "vct_derivs_fm_info"),
    "linesearch": ("vct_linesearch_fm", "rollout_fm.cu", "vct_linesearch_fm_info"),
    "aos": ("vct_linesearch_aos", "rollout_aos.cu", None),
}
VARIANTS = {  # build -> (its kernels, extra nvcc flags); the port's library is "port"
    "team8": (("solve", "backward"), ("-DVCT_TEAM=8",)),
    "team4_no_fma": (("solve", "backward"), ("-fmad=false",)),
}
_, _, _ST_HORIZON, _ST_BUDGET = chip_smoke.FAMILIES["singletrack"]
LAUNCH_SHAPE = {"derivs": (_ST_HORIZON["horizon"],),  # the printed launch shapes: H, A
                "linesearch": (_ST_BUDGET["n_alpha"],)}
CONDS = ("well", "rho0")  # kernels 1 and 5: rho = RHO_WELL and the solver's rho0


def build_all(baseline, variants):
    """{build: (library path, its kernels, seconds)}, the builds run side by side."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    jobs = {"port": (tuple(KERNELS), dict())}
    for name in variants:
        kernels, extra = VARIANTS[name]
        jobs[name] = (kernels, dict(sources=[os.path.join(cuda_lib.CSRC, KERNELS[k][1])
                                             for k in kernels],
                                    flags=cuda_lib.NVCC_FLAGS + extra))
    if baseline:
        sources = sorted(glob.glob(os.path.join(baseline, "*.cu")))
        have = {os.path.basename(s) for s in sources}
        jobs["baseline"] = (tuple(k for k, v in KERNELS.items() if v[1] in have),
                            dict(sources=sources))

    def timed(kw):
        t0 = time.perf_counter()
        return cuda_lib.build_library(**kw), time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, kw) for k, (_, kw) in jobs.items()}
        return {k: (f.result()[0], jobs[k][0], f.result()[1]) for k, f in futures.items()}


def load(path, kernels):
    """A build's library with its kernels' entries (and launch-shape entries
    where it has them) declared."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    lib = ctypes.CDLL(path)
    names = [KERNELS[k][0] for k in kernels]
    names += [KERNELS[k][2] for k in kernels if KERNELS[k][2] and hasattr(lib, KERNELS[k][2])]
    return cuda_lib.declare(lib, names)


def modes(times):
    """chip_smoke.time_modes as 'count x median' of each mode, fastest first."""
    return "/".join(f"{len(m)}x{statistics.median(m):.3f}" for m in chip_smoke.time_modes(times))


def ccall(lib, entry, *args):
    """lib.entry(*args); raise on a CUDA error."""
    rc = getattr(lib, entry)(*args)
    if rc:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def max_diff(a, b):
    """The largest |a - b| over the entries finite in both, and whether the
    non-finite entries agree."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    same_nonfinite = torch.equal(torch.isfinite(a), torch.isfinite(b))
    return (a[fin] - b[fin]).abs().max().item(), same_nonfinite


def run_family(label, env, libs, reps):
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain

    problem, budget, cfg, _, shape = chip_smoke.family_problem(label, env)
    fam, H, dev = problem.family, problem.family.H, env["dev"]
    w = chip_smoke.warm_inputs(problem, cfg, env)
    B, NZ, NU, NC = chip_smoke.B, fam.NZ, fam.NU, fam.NC
    NW, A = NZ + NU, len(cfg.alphas())
    params, scfg = cuda_lib.family_params(fam), cuda_lib.solve_config(cfg)
    alphas = np.asarray(cfg.alphas(), np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    rho0 = torch.full((B,), cfg.rho0, **f32)
    sv_in = [cuda_lib.soa(w[k]) for k in ("z0", "U_init", "lam", "curv", "ds")]
    bw_in = [cuda_lib.soa(t) for t in (w["X"], w["U"], w["lam"], w["mu"], rho0, w["curv"],
                                       w["ds"])]
    dv_in = [cuda_lib.soa(w[k]) for k in ("X", "U", "lam", "mu", "curv", "ds")]
    ls_in, aos_in = {}, {}
    for cond, rho_v in zip(CONDS, (chip_smoke.RHO_WELL, cfg.rho0)):
        rho = torch.full((B,), rho_v, **f32)
        kff, kfb = backward_plain(fam, w["X"], w["U"], w["lam"], w["mu"], rho, w["curv"],
                                  w["ds"])[:2]
        ins = (w["X"], w["U"], kff, kfb, w["lam"], w["mu"], w["curv"], w["ds"], w["z0"])
        ls_in[cond] = [cuda_lib.soa(t) for t in ins]
        aos_in[cond] = [t.contiguous() for t in ins]
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs, calls = {}, {}
    for name, (lib, kernels) in libs.items():
        o = outs[name] = dict(
            solve=[torch.empty(s, **f32) for s in ((H, NZ, B), (H, NU, B), (H, NC, B),
                                                  (H, NU, B), (H, NU, NZ, B),
                                                  (cuda_lib.SOLVE_STATS, B))],
            backward=[torch.empty(s, **f32) for s in ((H, NU, B), (H, NU, NZ, B), (2, B), (B,))],
            derivs=[torch.empty(s, **f32) for s in ((H, NW, B), (H, NW, NW, B), (H, NZ, NW, B))],
            linesearch={c: torch.empty(A, B, **f32) for c in CONDS},
            aos={c: torch.empty(A, B, **f32) for c in CONDS})

        table = dict(
            solve=lambda config=scfg, o=o, lib=lib: ccall(
                lib, "vct_solve_fm", params.ctypes.data, ctypes.addressof(config),
                *ptrs(sv_in + o["solve"]), B, H, stream),
            backward=lambda o=o, lib=lib: ccall(lib, "vct_backward_fm", params.ctypes.data,
                                                *ptrs(bw_in + o["backward"]), B, H, stream),
            derivs=lambda o=o, lib=lib: ccall(lib, "vct_derivs_fm", params.ctypes.data,
                                              *ptrs(dv_in + o["derivs"]), B, H, stream),
            linesearch=lambda cond="rho0", o=o, lib=lib: ccall(
                lib, "vct_linesearch_fm", params.ctypes.data, alphas.ctypes.data, A,
                *ptrs(ls_in[cond] + [o["linesearch"][cond]]), B, H, stream),
            aos=lambda cond="rho0", o=o, lib=lib: ccall(
                lib, "vct_linesearch_aos", params.ctypes.data, alphas.ctypes.data, A,
                *ptrs(aos_in[cond] + [o["aos"][cond]]), B, H, stream),
        )
        calls[name] = {k: table[k] for k in kernels}
    names = list(libs)
    for n in names:  # warm-up, and the outputs compared below
        for k, fn in calls[n].items():
            fn()
            if k in ("linesearch", "aos"):
                fn(cond="well")
    torch.cuda.synchronize()
    runs = {(n, k): [] for n in names for k in calls[n]}
    with chip_smoke.sampled_clocks() as clocks:
        for r in range(reps):
            for k in KERNELS:
                for n in (names if r % 2 == 0 else names[::-1]):
                    if k not in calls[n]:
                        continue
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0 = time.time()
                    start.record()
                    calls[n][k]()
                    end.record()
                    torch.cuda.synchronize()
                    runs[n, k].append((t0, time.time(), start.elapsed_time(end)))
    # chip_smoke's check (i) for every build of kernel 3: one iteration at
    # rho0 = 1 against the plain version (the builds' outputs are overwritten)
    well = chip_smoke.well_config(budget)
    ref = solve_plain(fam, well, *(w[k] for k in ("z0", "U_init", "lam", "curv", "ds")),
                      trace=True)
    well_rows = {}
    for n in names:
        if "solve" not in calls[n]:
            continue
        calls[n]["solve"](config=cuda_lib.solve_config(well))
        o = outs[n]["solve"]
        X, U, st = o[0].movedim(-1, 0), o[1].movedim(-1, 0), o[5]
        same = st[4] == ref[7]["first_alpha"]
        well_rows[n] = dict(
            well_step_same=same.float().mean().item(),
            well_X_max=chip_smoke.lane_errors(X[same], ref[0][same]).max().item(),
            well_U_max=chip_smoke.lane_errors(U[same], ref[1][same]).max().item(),
            well_U_worst=chip_smoke.worst_entry(U[same], ref[1][same]))
        calls[n]["solve"]()  # the main path's budget again, for the comparisons below
    torch.cuda.synchronize()
    res, port = {}, outs["port"]
    for n in names:
        o, row = outs[n], {}
        for k in calls[n]:
            ms = [t for _, _, t in runs[n, k]]
            row.update({f"{k}_ms": statistics.median(ms), f"{k}_ms_min": min(ms),
                        f"{k}_modes": modes(ms)})
            row.update({f"{k}_{m}": v for m, v in
                        chip_smoke.clock_modes(runs[n, k], clocks).items()})
        if "solve" in calls[n]:
            sv, ref_sv = o["solve"], port["solve"]
            row["solve_bitwise"] = all(chip_smoke.same_bits(a, b) for a, b in
                                       zip(sv[:3] + sv[5:], ref_sv[:3] + ref_sv[5:]))
            row["solve_converged"] = (f"{sv[5][2].mean().item():.4f}/"
                                      f"{ref_sv[5][2].mean().item():.4f}")
            row.update(well_rows[n])
        if "backward" in calls[n]:
            row["backward_bitwise"] = all(chip_smoke.same_bits(a, b) for a, b in
                                          zip(o["backward"], port["backward"]))
            row["backward_fail_lanes"] = (f"{int(o['backward'][3].sum())}/"
                                          f"{int(port['backward'][3].sum())}")
        if "derivs" in calls[n]:
            diffs = [max_diff(a, b) for a, b in zip(o["derivs"], port["derivs"])]
            row["derivs_max_abs_diff"] = max(d for d, _ in diffs)
            row["derivs_same_nonfinite"] = all(s for _, s in diffs)
        for k in ("linesearch", "aos"):
            if k in calls[n]:
                for c in CONDS:
                    row[f"{k}_{c}_bitwise"] = chip_smoke.same_bits(o[k][c], port[k][c])
        res[n] = row
        chip_smoke.phase(f"{label}:{n}", **shape,
                         **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in row.items()})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="a folder with an earlier build's .cu sources to compare")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated builds of {sorted(VARIANTS)}, or '' for none")
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
    variants = [v for v in args.variants.split(",") if v]
    built = build_all(args.baseline, variants)
    libs, builds = {}, {}
    for name, (path, kernels, seconds) in built.items():
        lib = load(path, kernels)
        libs[name] = (lib, kernels)
        info = {}
        for k in kernels:
            entry = KERNELS[k][2]
            if entry and hasattr(lib, entry):
                info[k] = cuda_lib.launch_info(getattr(lib, entry), chip_smoke.B,
                                               *LAUNCH_SHAPE.get(k, ()))
        builds[name] = dict(build_s=seconds, library=os.path.basename(path), kernels=kernels,
                            launch=info)
        chip_smoke.phase(f"build:{name}", seconds=f"{seconds:.1f}",
                         **{f"{k}_{f}": v for k, i in info.items() for f, v in i.items()
                            if f in ("registers", "stack_bytes", "smem_bytes_per_block",
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
