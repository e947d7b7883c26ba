"""The port's kernels against other builds of themselves, in turns, on one
NVIDIA GPU.

Builds, all at once, the port's kernel library (``csrc/``, "port") and
variants of some of its kernels from the same sources, which differ only in
nvcc flags (``VARIANTS``: teams of 8 and no FMA contraction for kernels 2
and 3).  With ``--baseline [NAME=]DIR`` (repeatable) it also builds every
kernel from the ``.cu`` files in DIR (for example an earlier commit's
``csrc/``, unpacked into an ignored folder), which must take the same C
arguments; each build's kernels are counted in its SASS (``sass_counts``:
f32 and all instructions of kernels 2-4, a static count over every stage
kind's code).

Then, for the families of ``chip_smoke.py`` (``--families``: the
single-track family, the cascade, the cascade with obstacles, the
kinematic family and the kc cascade, on each build's instantiation for the
family; a build from before that instantiation existed sits the family out) at its shapes
and budgets, on the same warm-started inputs
(``chip_smoke.warm_inputs``, computed by no kernel, each family's in a
process of its own beside the builds: ``chip_smoke.start_warm``), it times one launch of
each build's kernels with CUDA events: 3 (the whole solve, the main path's
budget), 2 (the backward pass at the solver's rho0), 4 (the stage
derivatives), 1 and 5 (the line search at rho0, under the plain backward
pass's gains), each on inputs already in its layout, the builds in turns
(forward order, then backward, ``--reps`` rounds) with the card's SM clock
sampled beside them (``chip_smoke.sampled_clocks``).  It reports each
build's median, minimum and timing modes with their clocks, whether its
kernels 1, 2, 3 and 5 give the port's outputs bit for bit (kernels 1 and 5
at both of ``chip_smoke.py``'s regularizations, and kernel 5 kernel 1's of
the same build), kernel 4's largest difference from the port's, and, as
the builds' derivatives need not round alike, each build's kernels 2 and 3
under ``chip_smoke.py``'s gates against the plain versions: kernel 2 at rho
= 1 (BW_TOL against the plain f32 version) and at the solver's rho0 (the
lane errors' quantiles against f64, beside the plain f32 version's, held
to QUANT_FACTOR), kernel 3 in check (i) (one outer x one inner iteration at
rho0 = 1) and check (ii) (the main path's budget on the cold first solve
against f64, ``solve_gates``).

    python3 kernel_ab.py [--baseline [NAME=]DIR ...] [--variants team8,team4_no_fma]
                         [--families singletrack,cascaded] [--reps 10] [--out FILE]

Prints the card's ``nvidia-smi`` name and power limit, one line per build
and family, and a JSON line of all numbers (also written to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
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
    "aos": ("vct_linesearch_aos", "rollout_aos.cu", "vct_linesearch_aos_info"),
}
VARIANTS = {  # build -> (its kernels, extra nvcc flags); the port's library is "port"
    "team8": (("solve", "backward"), ("-DVCT_TEAM=8",)),
    "team4_no_fma": (("solve", "backward"), ("-fmad=false",)),
}
_, _, _ST_HORIZON, _ST_BUDGET = chip_smoke.FAMILIES["singletrack"]
LAUNCH_SHAPE = {"derivs": (_ST_HORIZON["horizon"],),  # the printed launch shapes: H, A
                "linesearch": (_ST_BUDGET["n_alpha"],), "aos": (_ST_BUDGET["n_alpha"],)}
CONDS = ("well", "rho0")  # kernels 1 and 5: rho = RHO_WELL and the solver's rho0


def build_all(baselines, variants):
    """{build: (library path, its kernels, seconds)}, the builds run side by
    side; ``baselines``: {name: folder of .cu sources}."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    jobs = {"port": (tuple(KERNELS), dict())}
    for name in variants:
        kernels, extra = VARIANTS[name]
        jobs[name] = (kernels, dict(sources=[os.path.join(cuda_lib.CSRC, KERNELS[k][1])
                                             for k in kernels],
                                    flags=cuda_lib.NVCC_FLAGS + extra))
    for name, folder in baselines.items():
        sources = sorted(glob.glob(os.path.join(folder, "*.cu")))
        have = {os.path.basename(s) for s in sources}
        jobs[name] = (tuple(k for k, v in KERNELS.items() if v[1] in have),
                      dict(sources=sources))

    def timed(kw):
        t0 = time.perf_counter()
        return cuda_lib.build_library(**kw), time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, kw) for k, (_, kw) in jobs.items()}
        return {k: (f.result()[0], jobs[k][0], f.result()[1]) for k, f in futures.items()}


def load(path, kernels):
    """A build's library with its kernels' entries (and launch-shape entries,
    and the kinematic family's and the kc cascade's entries, where it has
    them) declared."""
    from vehicle_control_tpu_torch.solvers import cuda_lib

    lib = ctypes.CDLL(path)
    entries = [KERNELS[k][0] for k in kernels]
    infos = [KERNELS[k][2] for k in kernels if KERNELS[k][2]]
    other = [cuda_lib.suffixed(n, s) for n in entries + infos for s in ("_kin", "_kc")]
    return cuda_lib.declare(lib, entries + [n for n in infos + other if hasattr(lib, n)])


# the SASS opcodes counted as f32 operations (the FP32 pipe and the special
# function unit), and the kernels whose stage derivatives they count
F32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "MUFU", "FCHK", "FRND",
           "FSWZADD")
SASS_KERNELS = ("derivs_fm_kernel", "backward_fm_kernel", "solve_fm_kernel")


def sass_counts(lib_path):
    """{kernel: "f32 instructions/all instructions"}: a static count over the
    build's SASS (``cuobjdump -sass``; a kernel's non-inlined functions sit
    in its own code) of kernels 2-4; empty without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        for key in SASS_KERNELS:
            if key in name:
                # the kinematic family's and the kc cascade's instantiations
                key += "_kin" if "KinParams" in name else "_kc" if "KcParams" in name else ""
                ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                                 block)
                f32 = sum(1 for o in ops if o.split(".")[0] in F32_OPS)
                counts[key] = f"{f32}/{len(ops)}"
    return counts


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


def backward_gates(fam, w, rho0, libs, params, stream):
    """{build: row}: each build's kernel 2 under chip_smoke.py's gates
    (``chip_smoke.backward_gates``) at rho = RHO_WELL and at the solver's
    rho0, its rows and whether it passed each."""
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain

    H, NZ, NU = fam.H, fam.NZ, fam.NU
    B, f32 = chip_smoke.B, dict(dtype=torch.float32, device=rho0.device)
    base = (w["X"], w["U"], w["lam"], w["mu"])
    rhos = dict(well=torch.full((B,), chip_smoke.RHO_WELL, **f32), rho0=rho0)
    refs = {c: backward_plain(fam, *base, r, w["curv"], w["ds"]) for c, r in rhos.items()}
    refs64 = dict(well=None, rho0=backward_plain(
        fam, *(t.double() for t in base + (rho0, w["curv"], w["ds"]))))
    rows = {}
    for n, (lib, kernels) in libs.items():
        if "backward" not in kernels:
            continue
        row = {}
        for cond, rho in rhos.items():
            ins = [cuda_lib.soa(t) for t in base + (rho, w["curv"], w["ds"])]
            out = [torch.empty(s, **f32) for s in ((H, NU, B), (H, NU, NZ, B), (2, B), (B,))]
            ccall(lib, cuda_lib.entry(fam, "vct_backward_fm"), params.ctypes.data,
                  *ptrs(ins + out), B, H, stream)
            torch.cuda.synchronize()
            got = (out[0].movedim(-1, 0), out[1].movedim(-1, 0), out[2][0], out[2][1],
                   out[3] > 0.5)
            gate_rows, _, missed = chip_smoke.backward_gates(
                f"{n} kernel 2 ({cond})", got, refs[cond], refs64[cond])
            row.update({f"bw_{cond}_{k}": v for k, v in gate_rows.items()})
            row[f"bw_{cond}_pass"] = missed is None
        rows[n] = row
    return rows


def run_family(label, env, libs, reps):
    from vehicle_control_tpu_torch.solvers import cuda_lib
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
    from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain

    problem, budget, cfg, _, shape = chip_smoke.family_problem(label, env)
    fam, H, dev = problem.family, problem.family.H, env["dev"]
    w = chip_smoke.warm_of(label, env)
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
    entry = {k: cuda_lib.entry(fam, v[0]) for k, v in KERNELS.items()}  # the family's entries
    outs, calls = {}, {}
    for name, (lib, kernels) in libs.items():
        # a build from before the family's instantiation existed has no entry for it
        kernels = tuple(k for k in kernels if hasattr(lib, entry[k]))
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
                lib, entry["solve"], params.ctypes.data, ctypes.addressof(config),
                *ptrs(sv_in + o["solve"]), B, H, stream),
            backward=lambda o=o, lib=lib: ccall(lib, entry["backward"], params.ctypes.data,
                                                *ptrs(bw_in + o["backward"]), B, H, stream),
            derivs=lambda o=o, lib=lib: ccall(lib, entry["derivs"], params.ctypes.data,
                                              *ptrs(dv_in + o["derivs"]), B, H, stream),
            linesearch=lambda cond="rho0", o=o, lib=lib: ccall(
                lib, entry["linesearch"], params.ctypes.data, alphas.ctypes.data, A,
                *ptrs(ls_in[cond] + [o["linesearch"][cond]]), B, H, stream),
            aos=lambda cond="rho0", o=o, lib=lib: ccall(
                lib, entry["aos"], params.ctypes.data, alphas.ctypes.data, A,
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
    chip_smoke.warm_barrier(env)  # no other process on the card while timed
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
    # and check (ii): the main path's budget on the cold first solve against f64
    first_args, first_ref, _ = w["first"]
    first_in = [cuda_lib.soa(t) for t in first_args]
    first_64 = solve_plain(fam, cfg, *(t.double() for t in first_args), trace=True)
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
        ccall(libs[n][0], entry["solve"], params.ctypes.data, ctypes.addressof(scfg),
              *ptrs(first_in + o), B, H, stream)
        torch.cuda.synchronize()
        st = o[5]
        got = (None, None, None, st[0], st[1], st[2] > 0.5, st[3].to(torch.int32),
               dict(first_alpha=st[4], inner_runs=st[5].to(torch.int32)))
        rows, passed = chip_smoke.solve_gates(got, first_ref, first_64)
        well_rows[n].update(cold_gates_pass=bool(passed), cold_conv=rows["conv"],
                            cold_flips_vs_f64=rows["flips_vs_f64"],
                            cold_cost_median_vs_f64=rows["cost_median_vs_f64"])
        calls[n]["solve"]()  # the main path's budget again, for the comparisons below
    torch.cuda.synchronize()
    bw_rows = backward_gates(fam, w, rho0, {n: (libs[n][0], tuple(calls[n])) for n in names},
                             params, stream)
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
            row.update(bw_rows[n])
        if "derivs" in calls[n]:
            diffs = [max_diff(a, b) for a, b in zip(o["derivs"], port["derivs"])]
            row["derivs_max_abs_diff"] = max(d for d, _ in diffs)
            row["derivs_same_nonfinite"] = all(s for _, s in diffs)
        for k in ("linesearch", "aos"):
            if k in calls[n]:
                for c in CONDS:
                    row[f"{k}_{c}_bitwise"] = chip_smoke.same_bits(o[k][c], port[k][c])
        if "linesearch" in calls[n] and "aos" in calls[n]:
            row["aos_is_k1_bitwise"] = all(chip_smoke.same_bits(o["aos"][c], o["linesearch"][c])
                                           for c in CONDS)
        res[n] = row
        chip_smoke.phase(f"{label}:{n}", **shape,
                         **{k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in row.items()})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="[NAME=]DIR: a folder with an earlier build's .cu sources to compare "
                         "(repeatable; NAME defaults to 'baseline')")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated builds of {sorted(VARIANTS)}, or '' for none")
    ap.add_argument("--families", default=",".join(chip_smoke.FAMILIES),
                    help="comma-separated families of chip_smoke.FAMILIES (a baseline built "
                         "before a family existed computes another problem there)")
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
    baselines = dict(b.split("=", 1) if "=" in b else ("baseline", b) for b in args.baseline)
    labels = [label for label in args.families.split(",") if label]
    warm = chip_smoke.start_warm(labels)  # the families' inputs, beside the builds
    built = build_all(baselines, variants)
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
        builds[name]["sass"] = sass_counts(path)
        chip_smoke.phase(f"sass:{name}", **builds[name]["sass"])
    env = chip_smoke.make_env(dev)
    env["warm"] = warm
    families = {label: run_family(label, env, libs, args.reps) for label in labels}
    line = json.dumps(dict(card=smi, reps=args.reps, builds=builds, families=families))
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
