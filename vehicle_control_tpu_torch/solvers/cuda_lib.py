"""Build and load the hand-written CUDA kernels of ``csrc/``, and the
helpers their wrappers share: the parameter block, the struct-of-arrays
layout and the input checks.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes).  The library lands in ``build/kernels/`` at the
checkout's root under a name that carries the hash of the sources and
flags, so an edited source is rebuilt at its first use.  Nothing is built or
loaded when this module is imported.

Without ``--use_fast_math``: the kernels must match their plain PyTorch
versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from vehicle_control_tpu_torch.models.dynamic_car import _gcc
from vehicle_control_tpu_torch.utils.config import project_root

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
MAX_ALPHA = 16  # csrc/singletrack.cuh: MAX_ALPHA, the step sizes kernels 1 and 3 take
MAX_OUTER = 15  # csrc/solve_fm.cu: MAX_OUTER, the outer iterations kernel 3 takes
SOLVE_STATS = 6  # rows of kernel 3's per-lane outputs: cost, violation,
# converged, iterations, first accepted step, inner iterations run


class SolveConfig(ctypes.Structure):
    """Kernel 3's solver constants (csrc/solve_fm.cu: SolveConfig), f32 as
    the kernel computes; ``mus`` is the penalty of each outer iteration, then
    the polish phase's."""

    _fields_ = [
        ("n_outer", ctypes.c_int), ("n_inner", ctypes.c_int), ("n_polish", ctypes.c_int),
        ("n_alpha", ctypes.c_int), ("early_exit", ctypes.c_int), ("ls_fast_path", ctypes.c_int),
        ("alphas", ctypes.c_float * MAX_ALPHA), ("alphas2", ctypes.c_float * MAX_ALPHA),
        ("mus", ctypes.c_float * (MAX_OUTER + 1)),
        ("armijo", ctypes.c_float), ("tol_cost", ctypes.c_float), ("tol_con", ctypes.c_float),
        ("rho0", ctypes.c_float), ("rho_scale", ctypes.c_float), ("rho_min", ctypes.c_float),
        ("rho_max", ctypes.c_float),
    ]


def solve_config(cfg) -> SolveConfig:
    """Kernel 3's constants from an ALILQRConfig."""
    alphas = cfg.alphas()
    if not 1 <= len(alphas) <= MAX_ALPHA:
        raise ValueError(f"1..{MAX_ALPHA} step sizes, got {len(alphas)}")
    if not 0 <= cfg.n_outer <= MAX_OUTER:
        raise ValueError(f"0..{MAX_OUTER} outer iterations, got {cfg.n_outer}")
    mus = cfg.mu_schedule()
    pad = lambda v, n: v + [0.0] * (n - len(v))  # noqa: E731
    return SolveConfig(
        cfg.n_outer, cfg.n_inner, cfg.n_polish, len(alphas), int(cfg.early_exit),
        int(cfg.ls_fast_path),
        (ctypes.c_float * MAX_ALPHA)(*pad(alphas, MAX_ALPHA)),
        (ctypes.c_float * MAX_ALPHA)(*pad([a * a for a in alphas], MAX_ALPHA)),
        (ctypes.c_float * (MAX_OUTER + 1))(*pad(mus, MAX_OUTER + 1)),
        cfg.armijo, cfg.tol_cost, cfg.tol_con, cfg.rho0, cfg.rho_scale, cfg.rho_min,
        cfg.rho_max,
    )

# STParams field order (csrc/singletrack.cuh); every field is a float
PARAM_FIELDS = (
    # car
    "m", "Izz", "a", "b", "l", "h", "eps", "Peng", "Xdf", "Xdr", "Xbf", "Xbr",
    "Caf", "Car", "mu_f", "mu_r", "gcc", "Av2", "Cd", "Frr",
    # cost weights
    "w_time", "w_speed", "w_ey", "w_epsi", "w_w", "w_Fx", "w_dev", "w_boundary",
    "w_slip",
    # state and input constraints
    "Ux_min", "max_speed", "delta_min", "delta_max", "ey_min", "ey_max",
    "w_min", "w_max",
    # rollout control boxes (solver units)
    "u0_lo", "u0_hi", "u1_lo", "u1_hi",
    # the point-mass tail (zero for the single-track family): weights,
    # bounds and the Fy box of the point-mass stages
    "w_dev_pm", "w_Fy", "w_switch_F", "V_min", "ey_min_pm", "ey_max_pm",
    "u1_lo_pm", "u1_hi_pm",
    # the horizon's split: N single-track stages, pm = 1 for the tail
    "N", "pm",
)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def build_library(sources=None, flags=NVCC_FLAGS) -> str:
    """Compile ``csrc/*.cu`` (or the given ``.cu`` files, with the ``.cuh``
    beside them; other nvcc flags for measurements) unless a library for these
    sources and flags exists; return its path.  Each source compiles in its
    own ``nvcc``, all at once; the compilers' output (ptxas registers and
    spills) goes to a ``.log`` beside the library."""
    sources = sorted(sources or glob.glob(os.path.join(CSRC, "*.cu")))
    include = os.path.dirname(sources[0])
    headers = sorted(glob.glob(os.path.join(include, "*.cuh")))
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources + headers:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + fh.read())
    out_dir = os.path.join(project_root(), "build", "kernels")
    lib = os.path.join(out_dir, f"libvct_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src)[:-3] + ".o") for src in sources]
        jobs = []
        for src, obj in zip(sources, objs):
            cmd = [nvcc, *flags, "-I", include, "-c", "-o", obj, src]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-6000:]}")
        if not failed:
            so = os.path.join(tmp, "lib.so")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", so, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{(proc.stdout + proc.stderr)[-6000:]}")
        with open(lib[:-3] + ".log", "w") as fh:
            fh.write("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(so, lib)
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
# the library's C interface: name -> (argument types, result type)
SIGNATURES = {
    "vct_param_count": ([], _I),
    "vct_error_string": ([_I], ctypes.c_char_p),
    # (params, alphas, A, xref, uref, kff, kfb, lam, mu, curv, ds, z0, costs, B, H, stream)
    "vct_linesearch_fm": ([_P, _P, _I] + [_P] * 10 + [_I, _I, _P], _I),
    "vct_linesearch_aos": ([_P, _P, _I] + [_P] * 10 + [_I, _I, _P], _I),
    # (params, x, u, lam, mu, rho, curv, ds, kff, kfb, dv, fail, B, H, stream)
    "vct_backward_fm": ([_P] + [_P] * 11 + [_I, _I, _P], _I),
    # (params, cfg, z0, u0, lam0, curv, ds, x, u, lam, kff, kfb, stats, B, H, stream)
    "vct_solve_fm": ([_P, _P] + [_P] * 11 + [_I, _I, _P], _I),
    "vct_solve_config_size": ([], _I),
    # (params, x, u, lam, mu, curv, ds, g, hw, jm, B, H, stream)
    "vct_derivs_fm": ([_P] + [_P] * 9 + [_I, _I, _P], _I),
    # launch shapes: (B, out), (B, H, out), (B, A, out)
    "vct_solve_fm_info": ([_I, _P], _I),
    "vct_backward_fm_info": ([_I, _P], _I),
    "vct_derivs_fm_info": ([_I, _I, _P], _I),
    "vct_linesearch_fm_info": ([_I, _I, _P], _I),
}


def declare(lib: ctypes.CDLL, names=SIGNATURES) -> ctypes.CDLL:
    """Declare the C interface of the named functions of a loaded library."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C interface."""
    lib = declare(ctypes.CDLL(build_library()))
    if lib.vct_param_count() != len(PARAM_FIELDS):
        raise RuntimeError("csrc STParams and PARAM_FIELDS disagree")
    if lib.vct_solve_config_size() != ctypes.sizeof(SolveConfig):
        raise RuntimeError("csrc SolveConfig and cuda_lib.SolveConfig disagree")
    return lib


# csrc/singletrack.cuh: kernel_launch_info, a kernel's launch shape; the
# lead number is the team (kernels 2 and 3), the threads a (stage,
# scenario) (kernel 4) or the scenarios a block (kernel 1)
LAUNCH_INFO = ("lead", "threads", "block", "registers", "stack_bytes", "static_smem_bytes",
               "smem_bytes_per_block", "blocks_per_sm", "warps_per_sm")
LEADS = {"vct_solve_fm_info": "team", "vct_backward_fm_info": "team",
         "vct_derivs_fm_info": "threads_per_stage",
         "vct_linesearch_fm_info": "scenarios_per_block"}


def launch_info(fn, *shape) -> dict:
    """A kernel's launch shape and its residency on the card (``fn``: one of
    the library's ``vct_*_info`` functions; ``shape``: its B, then H or A)."""
    out = (ctypes.c_int * len(LAUNCH_INFO))()
    rc = fn(*shape, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"launch info: CUDA error {rc}")
    return {LEADS[fn.__name__]: out[0], **dict(zip(LAUNCH_INFO[1:], out[1:]))}


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {lib.vct_error_string(rc).decode()}")


def family_params(family) -> np.ndarray:
    """The family's car parameters, weights and bounds in STParams order (f32)."""
    p, w = family.params, family.weights
    ci, cs = family.input_constraints, family.state_constraints
    ct = family.tail_constraints or {}
    vals = dict(
        m=p.m, Izz=p.Izz, a=p.a, b=p.b, l=p.l, h=p.h, eps=p.eps, Peng=p.Peng,
        Xdf=p.Xdf, Xdr=p.Xdr, Xbf=p.Xbf, Xbr=p.Xbr, Caf=p.Caf, Car=p.Car,
        mu_f=p.mu_f, mu_r=p.mu_r, gcc=_gcc(p), Av2=p.Av2, Cd=p.Cd, Frr=p.Frr,
        w_time=w["time"], w_speed=w["speed"], w_ey=w["ey"], w_epsi=w["epsi"],
        w_w=w["w"], w_Fx=w["Fx"], w_dev=w["deviation_st"], w_boundary=w["boundary"],
        w_slip=w["slip"],
        Ux_min=cs["Ux_min"], max_speed=cs["max_speed"], delta_min=cs["delta_min"],
        delta_max=cs["delta_max"], ey_min=cs["ey_min"], ey_max=cs["ey_max"],
        w_min=ci["w_min"], w_max=ci["w_max"],
    )
    (vals["u0_lo"], vals["u0_hi"]), (vals["u1_lo"], vals["u1_hi"]) = (
        family.u_box(0, 0), family.u_box(0, 1)
    )
    pm = family.tail == "pm"
    vals.update(
        w_dev_pm=w.get("deviation_pm", 0.0) if pm else 0.0,
        w_Fy=w.get("Fy", 0.0) if pm else 0.0,
        w_switch_F=w.get("switch_F", 0.0) if pm else 0.0,
        V_min=ct.get("V_min", 0.0), ey_min_pm=ct.get("ey_min", 0.0),
        ey_max_pm=ct.get("ey_max", 0.0), N=family.N, pm=1.0 if pm else 0.0,
    )
    vals["u1_lo_pm"], vals["u1_hi_pm"] = family.u_box(family.H - 1, 1)
    return np.asarray([vals[k] for k in PARAM_FIELDS], np.float32)


def soa(t: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> contiguous (..., B): neighbouring threads read neighbouring
    scenarios (the struct-of-arrays layout the kernels take)."""
    return t.movedim(0, -1).contiguous()


def check_inputs(shapes: dict, tensors: dict, device) -> None:
    """Raise unless every tensor is a contiguous f32 tensor of its shape on device."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the CUDA kernels compute in float32")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
