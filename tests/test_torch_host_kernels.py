"""Kernels 1-4's lane bodies, built with the host compiler, on the CPU.

``csrc/host_driver.cpp`` compiles the lane bodies of ``csrc/team.cuh``
(kernel 2, the backward pass), ``csrc/solve_fm.cu`` (kernel 3, the whole
solve), ``csrc/derivs_fm.cu`` (kernel 4, the stage derivatives) and
``csrc/rollout_fm.cu`` (kernel 1, the line search from staged stage
records) with g++ into ``build/host/``; each scenario's team of TEAM
members is emulated in one thread, phase by phase, and kernel 1's blocks
(its schedule, ``linesearch_block``) phase by phase.  Two builds, compiled side by side: the kernels' team of 4,
and teams of 8.  The test decides whether g++ exists when it runs, and skips
without it.

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
  no output bit;
- kernel 4's lane at inputs where the Hessian's second-order block is
  live: g, Hw and J within DV_TOL of each lane's largest magnitude;
- kernel 1: the staged blocks (the kernel's own schedule,
  linesearch_block: rollout and cost warps, one chunk apart; threads in
  either order) give the one-lane rollouts' costs (linesearch_lane, within
  LS_RTOL of the plain version) bit for bit, with step sizes that fit the
  warps of a block and with more.
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
from vehicle_control_tpu_torch.solvers.derivs_kernel_fm import derivs_plain
from vehicle_control_tpu_torch.solvers.rollout_kernel_fm import linesearch_costs_plain
from vehicle_control_tpu_torch.solvers.solve_kernel_fm import solve_plain
from vehicle_control_tpu_torch.utils.config import load_config, project_root

B = 8
HORIZONS = {"none": dict(horizon=6), "pm": dict(horizon=4, horizon_pm=5)}
BW_TOL, SOLVE_TOL, DV_TOL, LS_RTOL = 1e-3, 1e-4, 1e-4, 1e-4
BUILDS = {"team4": (), "team8": ("-DVCT_TEAM=8",)}
WELL = ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=6, mu0=300.0, rho0=1.0)
BUDGET = dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6, mu0=300.0)


def _library(flags):
    """(the library's path for these sources and flags, the g++ command that builds it)."""
    sources = sorted(glob.glob(os.path.join(cuda_lib.CSRC, "*")))
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + fh.read())
    lib = os.path.join(project_root(), "build", "host", f"libvct_host_{digest.hexdigest()[:16]}.so")
    return lib, ["-std=c++17", "-O1", "-shared", "-fPIC", *flags, "-I", cuda_lib.CSRC,
                 os.path.join(cuda_lib.CSRC, "host_driver.cpp")]


def _build_all(cxx):
    """{build: library path}: the builds that are missing compile side by side."""
    libs = {name: _library(flags) for name, flags in BUILDS.items()}
    out_dir = os.path.dirname(next(iter(libs.values()))[0])
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = {name: (lib, subprocess.Popen([cxx, *args, "-o", os.path.join(tmp, name)],
                                             stderr=subprocess.PIPE, text=True))
                for name, (lib, args) in libs.items() if not os.path.exists(lib)}
        for name, (lib, proc) in jobs.items():
            err = proc.communicate()[1]
            assert proc.returncode == 0, err[-4000:]
            os.replace(os.path.join(tmp, name), lib)
    return {name: lib for name, (lib, _) in libs.items()}


@pytest.fixture(scope="module")
def host_libs():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++: the host build of the kernels' lane bodies")
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, path in _build_all(cxx).items():
        lib = ctypes.CDLL(path)
        lib.vct_host_backward.argtypes = [P] + [P] * 11 + [I, I]
        lib.vct_host_solve.argtypes = [P, P] + [P] * 11 + [I, I]
        lib.vct_host_set_member_order.argtypes = [I]
        lib.vct_host_derivs.argtypes = [P] * 10 + [I, I]
        lib.vct_host_linesearch.argtypes = [P, P, I] + [P] * 10 + [I, I, I]
        assert lib.vct_host_solve_config_size() == ctypes.sizeof(cuda_lib.SolveConfig)
        assert lib.vct_host_team() >= 4
        libs[name] = lib
    return libs


@pytest.fixture(scope="module", params=list(BUILDS))
def host_lib(request, host_libs):
    return host_libs[request.param]


@pytest.fixture(scope="module")
def kernel_lib(host_libs):
    """The build of the kernels' own team width."""
    return host_libs["team4"]


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


def test_backward_team_matches_plain_live_block(host_lib, inputs):
    """Kernel 2 where the Hessian's second-order block is live (``_active``)."""
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    rho = inputs[5]
    got = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    assert torch.equal(got[4], ref[4])
    ok = torch.stack([torch.isfinite(t.reshape(B, -1)).all(-1) for t in ref[:4]]).all(0)
    assert ok.float().mean() > 0.5
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        assert _lane_err(a[ok], b[ok]).max().item() < BW_TOL, name


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


def host_derivs(lib, fam, X, U, lam, mu, curv, ds):
    """Kernel 4's outputs (g, Hw, J) as DerivsKernelFM returns them."""
    H, NW = fam.H, 12
    out = (torch.empty(H, NW, B), torch.empty(H, NW, NW, B), torch.empty(H, 10, NW, B))
    soas = [cuda_lib.soa(t) for t in (X, U, lam, mu, curv, ds)]
    params = cuda_lib.family_params(fam)
    rc = lib.vct_host_derivs(params.ctypes.data, *[t.data_ptr() for t in soas + list(out)], B, H)
    assert rc == 0
    return tuple(t.movedim(-1, 0) for t in out)


def _active(inputs):
    """The inputs with the lateral states spread and the multipliers scaled
    up, so that the slip penalty and the PHR rows of the Hessian's
    second-order block are live (at the inputs' own values it is almost all
    zeros)."""
    fam, X, U, lam, mu, _, curv, ds = inputs[:8]
    rng = np.random.default_rng(2)
    X = X.clone()
    for field, scale in ((1, 2.0), (2, 0.5), (3, 0.1)):  # Uy, r, delta
        X[..., field] += torch.as_tensor(rng.normal(size=X.shape[:2]) * scale, dtype=X.dtype)
    return fam, X, U, lam * 300.0, mu, curv, ds


def test_derivs_lane_matches_plain(kernel_lib, inputs):
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    got = host_derivs(kernel_lib, fam, X, U, lam, mu, curv, ds)
    ref = derivs_plain(fam, X, U, lam, mu, curv, ds)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _lane_err(a, b).max().item() < DV_TOL
    block = got[1][:, :fam.N][:, :, [0, 1, 2, 3, 10]][..., [0, 1, 2, 3, 10]]
    assert (block != 0).float().mean() > 0.8  # the second-order block is live


@pytest.mark.parametrize("n_alpha", [6, 12])
def test_linesearch_staged_matches_lane(kernel_lib, inputs, n_alpha):
    """Kernel 1's staged blocks (the kernel's schedule, its threads first to
    last and last to first) against the one-lane rollouts: 6 step sizes (a
    rollout and a cost warp each, chunks of 4 stages) and 12 (some warps
    take two, chunks of 2: the record buffers and the ring are reused)."""
    fam, X, U, lam, mu, _, curv, ds, z0 = inputs
    H = fam.H
    rng = np.random.default_rng(1)
    kff = torch.as_tensor(rng.normal(size=(B, H, 2)) * 0.02, dtype=torch.float32)
    Kfb = torch.as_tensor(rng.normal(size=(B, H, 2, 10)) * 0.01, dtype=torch.float32)
    alphas = ALILQRConfig(n_alpha=n_alpha).alphas()
    soas = [cuda_lib.soa(t) for t in (X, U, kff, Kfb, lam, mu, curv, ds, z0)]
    params = cuda_lib.family_params(fam)
    al = np.asarray(alphas, np.float32)
    costs = {}
    for mode in (0, 1, 2):  # one lane; the blocks, threads first to last; last to first
        out = torch.full((n_alpha, B), float("nan"))
        rc = kernel_lib.vct_host_linesearch(params.ctypes.data, al.ctypes.data, n_alpha,
                                            *[t.data_ptr() for t in soas], out.data_ptr(), B, H,
                                            mode)
        assert rc == 0
        costs[mode] = out
    assert _same_bits(costs[1], costs[0]) and _same_bits(costs[2], costs[0])
    ref = linesearch_costs_plain(fam, alphas, X, U, kff, Kfb, lam, mu, curv, ds, z0)
    assert torch.equal(torch.isposinf(costs[1]), torch.isposinf(ref))
    assert torch.isposinf(costs[1][:, :2]).all()
    fin = torch.isfinite(ref)
    assert ((costs[1][fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0)).max() < LS_RTOL
