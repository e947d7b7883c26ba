"""Kernels 2 and 3's team code, built with the host compiler, against their
plain PyTorch versions on the CPU.

``csrc/host_driver.cpp`` compiles the lane bodies of ``csrc/team.cuh``
(kernel 2, the backward pass) and ``csrc/solve_fm.cu`` (kernel 3, the whole
solve) with g++ into ``build/host/``; each scenario's team of TEAM members
is emulated in one thread, phase by phase.  Two builds: the kernels' team
of 4, and teams of 8.  The test decides whether g++ exists when it runs, and
skips without it.

Inputs: bench-like drops (``initial_states``, seed 0) with their aligned
warm starts, rolled out under perturbed controls, with random multipliers,
made in float64 and handed to both versions in float32, at B=8 on the
single-track family (H=6) and the cascade (N=4 + M=5).  Lanes 0 and 1 start
beyond the state guard and from a NaN.  Tolerances (those of
``chip_smoke.py``: float32 rounding in another order):
- kernel 2 at rho = 1: gains and dV within BW_TOL of each lane's largest
  magnitude, PD-failure flags identical;
- kernel 3 at one outer x one inner iteration, rho0 = 1: the same step on
  every lane, X, U and cost within SOLVE_TOL (the two diverged lanes: flags
  and counts only);
- early_exit x ls_fast_path, and the members run in the other order, change
  no output bit.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from vehicle_control_tpu_torch.controllers.mpc import problems
from vehicle_control_tpu_torch.environment.track import Track
from vehicle_control_tpu_torch.parallel.batch import aligned_carry, initial_states
from vehicle_control_tpu_torch.solvers import cuda_lib
from vehicle_control_tpu_torch.solvers.al_ilqr import ALILQRConfig, rollout
from vehicle_control_tpu_torch.solvers.backward_kernel_fm import backward_plain
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
from vehicle_control_tpu_torch.utils.config import load_config, project_root

B = 8
HORIZONS = {"none": dict(horizon=6), "pm": dict(horizon=4, horizon_pm=5)}
BW_TOL, SOLVE_TOL = 1e-3, 1e-4
WELL = ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=6, mu0=300.0, rho0=1.0)
BUDGET = dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6, mu0=300.0)


def _build(cxx, flags):
    """Compile host_driver.cpp unless a library for these sources and flags exists."""
    sources = sorted(glob.glob(os.path.join(cuda_lib.CSRC, "*")))
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + fh.read())
    out_dir = os.path.join(project_root(), "build", "host")
    lib = os.path.join(out_dir, f"libvct_host_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            so = os.path.join(tmp, "lib.so")
            cmd = [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", *flags, "-I", cuda_lib.CSRC,
                   "-o", so, os.path.join(cuda_lib.CSRC, "host_driver.cpp")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-4000:]
            os.replace(so, lib)
    return lib


@pytest.fixture(scope="module", params=[(), ("-DVCT_TEAM=8",)], ids=["team4", "team8"])
def host_lib(request):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++: the host build of the kernels' team code")
    lib = ctypes.CDLL(_build(cxx, request.param))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vct_host_backward.argtypes = [P] + [P] * 11 + [I, I]
    lib.vct_host_solve.argtypes = [P, P] + [P] * 11 + [I, I]
    lib.vct_host_set_member_order.argtypes = [I]
    assert lib.vct_host_solve_config_size() == ctypes.sizeof(cuda_lib.SolveConfig)
    assert lib.vct_host_team() >= 4
    return lib


def host_backward(lib, fam, X, U, lam, mu, rho, curv, ds):
    """Kernel 2's outputs, as BackwardKernelFM returns them."""
    H = fam.H
    soas = [cuda_lib.soa(t) for t in (X, U, lam, mu, rho, curv, ds)]
    kff, kfb = torch.empty(H, 2, B), torch.empty(H, 2, 10, B)
    dv, fail = torch.empty(2, B), torch.empty(B)
    params = cuda_lib.family_params(fam)
    rc = lib.vct_host_backward(params.ctypes.data, *[t.data_ptr() for t in soas],
                               kff.data_ptr(), kfb.data_ptr(), dv.data_ptr(), fail.data_ptr(),
                               B, H)
    assert rc == 0
    return kff.movedim(-1, 0), kfb.movedim(-1, 0), dv[0], dv[1], fail > 0.5


def host_solve(lib, fam, cfg, z0, U_init, lam_init, curv, ds):
    """Kernel 3's outputs and trace, as SolveKernelFM(trace=True) returns them."""
    H = fam.H
    soas = [cuda_lib.soa(t) for t in (z0, U_init, lam_init, curv, ds)]
    X, U, lam = torch.empty(H, 10, B), torch.empty(H, 2, B), torch.empty(H, 10, B)
    kff, kfb = torch.empty(H, 2, B), torch.empty(H, 2, 10, B)
    stats = torch.empty(cuda_lib.SOLVE_STATS, B)
    params, scfg = cuda_lib.family_params(fam), cuda_lib.solve_config(cfg)
    rc = lib.vct_host_solve(params.ctypes.data, ctypes.addressof(scfg),
                            *[t.data_ptr() for t in soas], X.data_ptr(), U.data_ptr(),
                            lam.data_ptr(), kff.data_ptr(), kfb.data_ptr(), stats.data_ptr(),
                            B, H)
    assert rc == 0
    return (X.movedim(-1, 0), U.movedim(-1, 0), lam.movedim(-1, 0), stats[0], stats[1],
            stats[2] > 0.5, stats[3].to(torch.int32),
            dict(first_alpha=stats[4], inner_runs=stats[5].to(torch.int32)))


def _config(rel):
    return load_config(f"{project_root()}/configs/{rel}")


@pytest.fixture(scope="module", params=["none", "pm"])
def inputs(request):
    """(family, X, U, lam, mu, rho, curv, ds, z0) in float32 on the CPU."""
    tail = request.param
    name = "singletrack.yaml" if tail == "none" else "cascaded.yaml"
    cfg = dict(_config(f"controllers/{name}"), obstacles=False, **HORIZONS[tail])
    track = Track(_config("environment/ippodromo.yaml"))
    prob = problems.build_cascaded_problem(_config("models/dynamic_car.yaml"), track, cfg, tail,
                                           torch.float64, "cpu")
    H = prob.family.H
    rng = np.random.default_rng(0)
    states = torch.as_tensor(initial_states(track.length, B, rng))
    carry = aligned_carry(prob, states)
    params, z0 = prob.init_horizon(states, carry.X_pred, carry.U_pred)
    U = carry.U_pred + torch.as_tensor(rng.normal(size=(B, H, 2)) * 0.05)
    X, _ = rollout(prob.fns, params, z0, U)
    lam = torch.as_tensor(np.abs(rng.normal(size=(B, H, 10))) * 0.1)
    z0 = z0.clone()
    z0[0, 1] = 1e8  # beyond the 1e7 state guard
    z0[1, 2] = float("nan")  # a NaN start
    mu, rho = torch.full((B,), 10.0), torch.ones(B)
    arrays = (X, U, lam, mu, rho, params.curvature, params.ds, z0)
    return (prob.family,) + tuple(a.to(torch.float32).contiguous() for a in arrays)


def _lane_err(a, b):
    """Per lane: max |a - b| / (1 + max |b| of the lane)."""
    scale = 1.0 + b.abs().reshape(b.shape[0], -1).amax(-1)
    return (a - b).abs().reshape(b.shape[0], -1).amax(-1) / scale


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_backward_team_matches_plain(host_lib, inputs):
    fam, X, U, lam, mu, rho, curv, ds = inputs[:8]
    got = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    assert torch.equal(got[4], ref[4])
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        assert a.shape == b.shape, name
        assert _lane_err(a, b).max().item() < BW_TOL, name


def test_solve_team_matches_plain(host_lib, inputs):
    fam, _, U, lam, _, _, curv, ds, z0 = inputs
    got = host_solve(host_lib, fam, WELL, z0, U, lam, curv, ds)
    ref = solve_plain(fam, WELL, z0, U, lam, curv, ds, trace=True)
    assert torch.equal(got[7]["first_alpha"], ref[7]["first_alpha"])  # the chosen step
    assert (ref[7]["first_alpha"][2:] > 0).any()
    assert torch.equal(got[5], ref[5]) and torch.equal(got[6], ref[6])
    assert torch.equal(got[7]["inner_runs"], ref[7]["inner_runs"])
    for name, a, b in zip(("X", "U", "lam"), got[:3], ref[:3]):
        assert _lane_err(a[2:], b[2:]).max().item() < SOLVE_TOL, name
    cost, cost_ref = got[3][2:], ref[3][2:]
    assert ((cost - cost_ref).abs() / cost_ref.abs().clamp_min(1.0)).max().item() < SOLVE_TOL


def test_exits_and_member_order_change_no_bit(host_lib, inputs):
    fam, X, U, lam, mu, rho, curv, ds, z0 = inputs
    outs = []
    for early_exit, fast in ((True, False), (False, False), (True, True), (False, True)):
        cfg = ALILQRConfig(**BUDGET, early_exit=early_exit, ls_fast_path=fast)
        outs.append(host_solve(host_lib, fam, cfg, z0, U, lam, curv, ds)[:7])
    bw = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    host_lib.vct_host_set_member_order(1)
    try:
        outs.append(host_solve(host_lib, fam, ALILQRConfig(**BUDGET), z0, U, lam, curv, ds)[:7])
        bw_rev = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    finally:
        host_lib.vct_host_set_member_order(0)
    for out in outs[1:]:
        assert all(_same_bits(a, b) for a, b in zip(out, outs[0]))
    assert all(_same_bits(a, b) for a, b in zip(bw, bw_rev))
