"""Kernels 1-5's lane bodies, built with the host compiler, on the CPU.

``csrc/host_driver.cpp`` compiles the lane bodies of ``csrc/team.cuh``
(kernel 2, the backward pass), ``csrc/solve_fm.cu`` (kernel 3, the whole
solve), ``csrc/derivs_fm.cu`` (kernel 4, the stage derivatives),
``csrc/rollout_fm.cu`` and ``csrc/rollout_aos.cu`` (kernels 1 and 5, the
line search from staged stage records) with g++ into ``build/host/``; each
scenario's team of TEAM members is emulated in one thread, phase by phase,
and the line search's blocks (its schedule, ``linesearch_block``) phase by
phase.  Three builds, compiled side by side: the kernels' team of 4, teams
of 8, and the team of 4 whose floats count their arithmetic
(``csrc/op_count.h``, for chip_smoke.py's bounds).  The test decides whether g++ exists when it runs, and skips
without it.

Inputs: bench-like drops (``initial_states``, seed 0) with their aligned
warm starts, rolled out under perturbed controls, with random multipliers,
made in float64 and handed to both versions in float32, at B=8 on the
single-track family (H=6), the cascade (N=4 + M=5), the cascade with
ippodromo's obstacles (the barrier's table is a run-time parameter, so the
same builds run it), the kinematic family with them (N=6, H=7: the
kernels' instantiation for KinParams, the ``_kin`` entries), whose drops
sit 2-15 m before a disc, within 1.5 m of its ey, so the horizons run past
and into the discs, and the kc cascade (N=4 + K=5: the instantiation for
KcParams, the ``_kc`` entries).  Lanes 0 and 1 start beyond the state guard and from a
NaN.  Tolerances (those of
``chip_smoke.py``: float32 rounding in another order):
- kernel 2 at rho = 1: gains and dV within BW_TOL of each lane's largest
  magnitude, PD-failure flags identical;
- kernel 3 at one outer x one inner iteration, rho0 = 1: the same step on
  every lane, X, U and cost within SOLVE_TOL (the two diverged lanes: flags
  and counts only);
- early_exit x ls_fast_path, and the members run in the other order, change
  no output bit;
- kernel 4's lane at inputs where the Hessian's second-order block is
  live, and at the edges of its closed forms (the masked rows of stage 0,
  the seam, the terminal stage, a PHR row at lam + mu c = 0 exactly, Ux at
  max_speed, ey at its bound, the state clamps at their ties): g, Hw and J
  within DV_TOL of each lane's largest magnitude, Hw symmetric bit for bit;
- kernel 1: the staged blocks (the kernel's own schedule,
  linesearch_block: rollout and cost warps, one chunk apart; threads in
  either order) give the one-lane rollouts' costs (linesearch_lane, within
  LS_RTOL of the plain version) bit for bit, with step sizes that fit the
  warps of a block and with more; kernel 5's blocks (the same schedule from
  the (B, H, F) layout) give the same costs bit for bit;
- the counting build: kernels 4 and 2's outputs bit for bit, and at most
  half the operations that chip_smoke.count_ops counts on the plain
  versions' jets (the kinematic family's plain derivatives are closed forms
  too: there at most the plain version's);
- the kc cascade's seam reads the previous controls (a_final), so its
  Jacobian has live stash columns, which the team's slot must carry: the
  plain gains with those columns dropped part from the intact ones by more
  than three times BW_TOL on most lanes, so kernel 2's gate at BW_TOL
  (test_backward_team_matches_plain) fails a build that drops them.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
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
HORIZONS = {"none": dict(horizon=6), "pm": dict(horizon=4, horizon_pm=5),
            "kinematic": dict(horizon=6), "kc": dict(horizon=4, horizon_kc=5)}
BW_TOL, SOLVE_TOL, DV_TOL, LS_RTOL = 1e-3, 1e-4, 1e-4, 1e-4
BUILDS = {"team4": (), "team8": ("-DVCT_TEAM=8",)}
COUNT_FLAGS = ("-DVCT_COUNT_OPS",)  # the build that counts its f32 operations
WELL = ALILQRConfig(n_outer=1, n_inner=1, n_polish=0, n_alpha=6, mu0=300.0, rho0=1.0)
BUDGET = dict(n_outer=2, n_inner=3, n_polish=1, n_alpha=6, mu0=300.0)


def _build_all(cxx):
    """{build: library path}: the builds that are missing compile side by side
    (BUILDS and "count")."""
    libs = {name: cuda_lib.host_library(flags)
            for name, flags in dict(BUILDS, count=COUNT_FLAGS).items()}
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
        for suffix in ("", "_kin", "_kc"):  # the cascaded family's, the kinematic, the kc
            getattr(lib, "vct_host_backward" + suffix).argtypes = [P] + [P] * 11 + [I, I]
            getattr(lib, "vct_host_solve" + suffix).argtypes = [P, P] + [P] * 11 + [I, I]
            getattr(lib, "vct_host_derivs" + suffix).argtypes = [P] * 10 + [I, I]
            for ls in ("vct_host_linesearch", "vct_host_linesearch_aos"):
                getattr(lib, ls + suffix).argtypes = [P, P, I] + [P] * 10 + [I, I, I]
        lib.vct_host_set_member_order.argtypes = [I]
        assert lib.vct_host_solve_config_size() == ctypes.sizeof(cuda_lib.SolveConfig)
        assert lib.vct_host_param_count() == len(cuda_lib.PARAM_FIELDS)  # the table's too
        assert lib.vct_host_kin_param_count() == len(cuda_lib.KIN_PARAM_FIELDS)
        assert lib.vct_host_kc_param_count() == len(cuda_lib.KC_PARAM_FIELDS)
        assert lib.vct_host_team() >= 4
        if name == "count":
            lib.vct_host_ops.restype = ctypes.c_double
        libs[name] = lib
    return libs


@pytest.fixture(scope="module", params=list(BUILDS))
def host_lib(request, host_libs):
    return host_libs[request.param]


@pytest.fixture(scope="module")
def kernel_lib(host_libs):
    """The build of the kernels' own team width."""
    return host_libs["team4"]


def _entry(lib, fam, name):
    """The host build's C entry ``name`` for the family (``cuda_lib.entry``)."""
    return getattr(lib, cuda_lib.entry(fam, name))


def host_backward(lib, fam, X, U, lam, mu, rho, curv, ds):
    """Kernel 2's outputs, as BackwardKernelFM returns them."""
    H = fam.H
    soas = [cuda_lib.soa(t) for t in (X, U, lam, mu, rho, curv, ds)]
    kff, kfb = torch.empty(H, 2, B), torch.empty(H, 2, fam.NZ, B)
    dv, fail = torch.empty(2, B), torch.empty(B)
    params = cuda_lib.family_params(fam)
    rc = _entry(lib, fam, "vct_host_backward")(params.ctypes.data, *[t.data_ptr() for t in soas],
                               kff.data_ptr(), kfb.data_ptr(), dv.data_ptr(), fail.data_ptr(),
                               B, H)
    assert rc == 0
    return kff.movedim(-1, 0), kfb.movedim(-1, 0), dv[0], dv[1], fail > 0.5


def host_solve(lib, fam, cfg, z0, U_init, lam_init, curv, ds):
    """Kernel 3's outputs and trace, as SolveKernelFM(trace=True) returns them."""
    H = fam.H
    soas = [cuda_lib.soa(t) for t in (z0, U_init, lam_init, curv, ds)]
    X, U, lam = torch.empty(H, fam.NZ, B), torch.empty(H, 2, B), torch.empty(H, 10, B)
    kff, kfb = torch.empty(H, 2, B), torch.empty(H, 2, fam.NZ, B)
    stats = torch.empty(cuda_lib.SOLVE_STATS, B)
    params, scfg = cuda_lib.family_params(fam), cuda_lib.solve_config(cfg)
    rc = _entry(lib, fam, "vct_host_solve")(params.ctypes.data, ctypes.addressof(scfg),
                            *[t.data_ptr() for t in soas], X.data_ptr(), U.data_ptr(),
                            lam.data_ptr(), kff.data_ptr(), kfb.data_ptr(), stats.data_ptr(),
                            B, H)
    assert rc == 0
    return (X.movedim(-1, 0), U.movedim(-1, 0), lam.movedim(-1, 0), stats[0], stats[1],
            stats[2] > 0.5, stats[3].to(torch.int32),
            dict(first_alpha=stats[4], inner_runs=stats[5].to(torch.int32)))


def _config(rel):
    return load_config(f"{project_root()}/configs/{rel}")


@pytest.fixture(scope="module",
                params=["none", "pm", "pm_obstacles", "kinematic_obstacles", "kc"])
def inputs(request):
    """(family, X, U, lam, mu, rho, curv, ds, z0) in float32 on the CPU."""
    tail, _, obstacles = request.param.partition("_")
    track = Track(_config("environment/ippodromo.yaml"))
    if tail == "kinematic":
        cfg = dict(_config("controllers/kinematic.yaml"), obstacles=True, **HORIZONS[tail])
        prob = problems.build_kinematic_problem(_config("models/kinematic_car.yaml"), track, cfg,
                                                torch.float64, "cpu")
        ns, i_s, u_noise = 6, 2, (0.5, 0.05)  # (a, w) in physical units
    else:
        name = {"none": "singletrack.yaml", "pm": "cascaded.yaml",
                "kc": "cascaded_kinematic.yaml"}[tail]
        cfg = dict(_config(f"controllers/{name}"), obstacles=bool(obstacles), **HORIZONS[tail])
        prob = problems.build_cascaded_problem(_config("models/dynamic_car.yaml"), track, cfg,
                                               tail, torch.float64, "cpu")
        ns, i_s, u_noise = 8, 4, (0.05, 0.05)
    H = prob.family.H
    rng = np.random.default_rng(0)
    states = initial_states(track.length, B, rng, ns=ns)
    if obstacles:  # 2-15 m before a disc, within 1.5 m of its ey
        disc = track.data.obstacles.numpy()[np.arange(B) % len(track.obstacles)]
        states[:, i_s] = disc[:, 2] - rng.uniform(2.0, 15.0, B)
        states[:, i_s + 1] = disc[:, 3] + rng.uniform(-1.5, 1.5, B)
    states = torch.as_tensor(states)
    carry = aligned_carry(prob, states)
    params, z0 = prob.init_horizon(states, carry.X_pred, carry.U_pred)
    U = carry.U_pred + torch.as_tensor(rng.normal(size=(B, H, 2)) * np.asarray(u_noise))
    X, _ = rollout(prob.fns, params, z0, U)
    lam = torch.as_tensor(np.abs(rng.normal(size=(B, H, 10))) * 0.1)
    z0 = z0.clone()
    f_big, f_nan = (2, 3) if tail == "kinematic" else (1, 2)  # no clamp or stop brings them back
    z0[0, f_big] = 1e8  # beyond the 1e7 state guard
    z0[1, f_nan] = float("nan")  # a NaN start
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


def _finite_lanes(ts):
    return torch.stack([torch.isfinite(t.reshape(B, -1)).all(-1) for t in ts]).all(0)


def test_backward_team_matches_plain(host_lib, inputs):
    """The gains where the plain version's are finite, the same lanes
    finite (a lane where the Riccati step is not PD, as where the horizon
    runs into an obstacle's barrier, carries non-finite gains in both)."""
    fam, X, U, lam, mu, rho, curv, ds = inputs[:8]
    got = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    assert torch.equal(got[4], ref[4])
    ok = _finite_lanes(ref[:4])
    assert torch.equal(_finite_lanes(got[:4]), ok)
    assert ok.float().mean() > 0.5
    for name, a, b in zip(("kff", "Kfb", "dV1", "dV2"), got[:4], ref[:4]):
        assert a.shape == b.shape, name
        assert _lane_err(a[ok], b[ok]).max().item() < BW_TOL, name


def test_backward_team_matches_plain_live_block(host_lib, inputs):
    """Kernel 2 where the Hessian's second-order block is live (``_active``)."""
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    rho = inputs[5]
    got = host_backward(host_lib, fam, X, U, lam, mu, rho, curv, ds)
    ref = backward_plain(fam, X, U, lam, mu, rho, curv, ds)
    assert torch.equal(got[4], ref[4])
    ok = _finite_lanes(ref[:4])
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
    H, NZ, NW = fam.H, fam.NZ, fam.NZ + fam.NU
    out = (torch.empty(H, NW, B), torch.empty(H, NW, NW, B), torch.empty(H, NZ, NW, B))
    soas = [cuda_lib.soa(t) for t in (X, U, lam, mu, curv, ds)]
    params = cuda_lib.family_params(fam)
    rc = _entry(lib, fam, "vct_host_derivs")(params.ctypes.data,
                                             *[t.data_ptr() for t in soas + list(out)], B, H)
    assert rc == 0
    return tuple(t.movedim(-1, 0) for t in out)


def _active(inputs):
    """The inputs with the lateral states spread and the multipliers scaled
    up, so that the slip penalty and the PHR rows of the Hessian's
    second-order block are live (at the inputs' own values it is almost all
    zeros); for the kinematic family, delta and ey spread, so that the
    steering box's rows and the boundary cost are live."""
    fam, X, U, lam, mu, _, curv, ds = inputs[:8]
    rng = np.random.default_rng(2)
    X = X.clone()
    spread = (((1, 0.3), (3, 2.0)) if cuda_lib.is_kinematic(fam)  # delta, ey
              else ((1, 2.0), (2, 0.5), (3, 0.1)))  # Uy, r, delta
    for field, scale in spread:
        X[..., field] += torch.as_tensor(rng.normal(size=X.shape[:2]) * scale, dtype=X.dtype)
    return fam, X, U, lam * 300.0, mu, curv, ds


def test_derivs_lane_matches_plain(kernel_lib, inputs):
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    got = host_derivs(kernel_lib, fam, X, U, lam, mu, curv, ds)
    ref = derivs_plain(fam, X, U, lam, mu, curv, ds)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _lane_err(a, b).max().item() < DV_TOL
    if cuda_lib.is_kinematic(fam):  # the steering box's rows live on delta's Hessian entry
        assert (got[1][:, 1:fam.N, 1, 1] != 0).float().mean() > 0.3
        assert (got[0][:, :fam.N, 2] != 0).float().mean() > 0.5  # the barrier's s gradient
        return
    block = got[1][:, :fam.N][:, :, [0, 1, 2, 3, 10]][..., [0, 1, 2, 3, 10]]
    assert (block != 0).float().mean() > 0.8  # the second-order block is live
    if fam.obstacles:  # the barrier's s gradient and (s, s) entry, the only terms on s
        N = fam.N
        g_s = torch.cat([got[0][:, :N, 4], got[0][:, N:, 1]], 1)
        h_ss = torch.cat([got[1][:, :N, 4, 4], got[1][:, N:, 1, 1]], 1)
        assert ((g_s != 0) & (h_ss != 0)).float().mean() > 0.5


def _edges(inputs):
    """``_active``'s inputs with lanes 2-5 at the edges of the closed forms
    (every lane has the masked rows of stage 0, the terminal stage and, on
    the cascade, the seam): lane 2 Ux (V) at max_speed; lane 3 ey at its
    upper bound; lane 4 Ux, delta, ey and epsi at the ties of spatial_prime's
    clamps; lane 5 delta at delta_max, and the PHR rows of delta_max and
    w_max (the V floor on point-mass stages) at lam + mu c = 0 exactly."""
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    X, U, lam = X.clone(), U.clone(), lam.clone()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    N = fam.N
    if cuda_lib.is_kinematic(fam):
        kp = dict(zip(cuda_lib.KIN_PARAM_FIELDS, cuda_lib.family_params(fam).tolist()))
        X[2, :, 0] = kp["v_max"]  # the terminal speed hinge's tie
        X[3, :, 3] = kp["ey_max"]
        X[4, :, 1], X[4, :, 3], X[4, :, 4] = 1.0, 8.0, 1.2  # kc_prime's clamps' ties
        X[5, :, 1], U[5, :, 1] = kp["delta_max"], 0.0  # the steering stop's tie
        lam[5, :, 1] = 0.0  # c = delta - delta_max = 0
        U[5, :, 0] = f32(kp["a_max"]) - 0.5
        lam[5, :, 3] = -(mu[5] * (U[5, :, 0] - f32(kp["a_max"])))  # lam = -mu c
        return fam, X, U, lam, mu, curv, ds
    cp = dict(zip(cuda_lib.PARAM_FIELDS, cuda_lib.family_params(fam).tolist()))
    X[2, :, 0] = cp["max_speed"]
    X[3, :N, 5] = cp["ey_max"]
    if not cuda_lib.is_kc(fam):
        X[3, N:, 2] = cp["ey_max_pm"]
    X[4, :N, 0], X[4, :N, 3], X[4, :N, 5], X[4, :N, 6] = 1.0, 1.0, 8.0, 1.3
    X[5, :N, 3] = cp["delta_max"]
    lam[5, :N, 1] = 0.0  # c = delta - delta_max = 0
    U[5, :N, 1] = f32(cp["w_max"]) - 0.5
    lam[5, :N, 4] = -(mu[5] * (U[5, :N, 1] - f32(cp["w_max"])))  # lam = -mu c
    if cuda_lib.is_kc(fam):  # the tail: v, delta, ey and epsi on its clamps' ties, the stop
        kp = dict(zip(cuda_lib.KC_PARAM_FIELDS, cuda_lib.family_params(fam).tolist()))
        X[3, N:, 3] = kp["ey_max_kc"]
        X[4, N:, 0], X[4, N:, 1], X[4, N:, 3], X[4, N:, 4] = 0.5, 1.0, 8.0, 1.2
        X[5, N:, 1], U[5, N:, 1] = kp["delta_max_kc"], 0.0  # the steering stop's tie
        lam[5, N:, 1] = 0.0  # c = delta - delta_max = 0
        lam[5, N:, 5] = -(mu[5] * (U[5, N:, 1] - f32(kp["w_max"])))  # lam = -mu c
        return fam, X, U, lam, mu, curv, ds
    X[5, N:, 0] = f32(cp["V_min"]) + 1.0
    lam[5, N:, 0] = -(mu[5] * (f32(cp["V_min"]) - X[5, N:, 0]))
    return fam, X, U, lam, mu, curv, ds


def test_derivs_lane_at_edges(kernel_lib, inputs):
    fam, X, U, lam, mu, curv, ds = _edges(inputs)
    got = host_derivs(kernel_lib, fam, X, U, lam, mu, curv, ds)
    ref = derivs_plain(fam, X, U, lam, mu, curv, ds)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _lane_err(a, b).max().item() < DV_TOL
    assert _same_bits(got[1], got[1].transpose(-1, -2).contiguous())  # Hw symmetric


@pytest.mark.parametrize("n_alpha", [6, 12])
def test_linesearch_aos_blocks_match_lane(kernel_lib, inputs, n_alpha):
    """Kernel 5's blocks (kernel 1's schedule with the (B, H, F) record
    source, threads first to last and last to first) give kernel 1's
    one-lane costs bit for bit."""
    fam, X, U, lam, mu, _, curv, ds, z0 = inputs
    H = fam.H
    rng = np.random.default_rng(1)
    kff = torch.as_tensor(rng.normal(size=(B, H, 2)) * 0.02, dtype=torch.float32)
    Kfb = torch.as_tensor(rng.normal(size=(B, H, 2, fam.NZ)) * 0.01, dtype=torch.float32)
    args = (X, U, kff, Kfb, lam, mu, curv, ds, z0)
    params = cuda_lib.family_params(fam)
    al = np.asarray(ALILQRConfig(n_alpha=n_alpha).alphas(), np.float32)
    lane = torch.full((n_alpha, B), float("nan"))
    soas = [cuda_lib.soa(t) for t in args]
    assert _entry(kernel_lib, fam, "vct_host_linesearch")(
        params.ctypes.data, al.ctypes.data, n_alpha, *[t.data_ptr() for t in soas],
        lane.data_ptr(), B, H, 0) == 0
    assert torch.isposinf(lane[:, :2]).all() and torch.isfinite(lane[:, 2:]).any()
    for mode in (1, 2):
        out = torch.full((n_alpha, B), float("nan"))
        rc = _entry(kernel_lib, fam, "vct_host_linesearch_aos")(
            params.ctypes.data, al.ctypes.data, n_alpha,
            *[t.contiguous().data_ptr() for t in args], out.data_ptr(), B, H, mode)
        assert rc == 0
        assert _same_bits(out, lane)


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
    Kfb = torch.as_tensor(rng.normal(size=(B, H, 2, fam.NZ)) * 0.01, dtype=torch.float32)
    alphas = ALILQRConfig(n_alpha=n_alpha).alphas()
    soas = [cuda_lib.soa(t) for t in (X, U, kff, Kfb, lam, mu, curv, ds, z0)]
    params = cuda_lib.family_params(fam)
    al = np.asarray(alphas, np.float32)
    costs = {}
    for mode in (0, 1, 2):  # one lane; the blocks, threads first to last; last to first
        out = torch.full((n_alpha, B), float("nan"))
        rc = _entry(kernel_lib, fam, "vct_host_linesearch")(
            params.ctypes.data, al.ctypes.data, n_alpha, *[t.data_ptr() for t in soas],
            out.data_ptr(), B, H, mode)
        assert rc == 0
        costs[mode] = out
    assert _same_bits(costs[1], costs[0]) and _same_bits(costs[2], costs[0])
    ref = linesearch_costs_plain(fam, alphas, X, U, kff, Kfb, lam, mu, curv, ds, z0)
    assert torch.equal(torch.isposinf(costs[1]), torch.isposinf(ref))
    assert torch.isposinf(costs[1][:, :2]).all()
    fin = torch.isfinite(ref)
    assert ((costs[1][fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0)).max() < LS_RTOL


def test_counting_build_same_bits_fewer_ops(host_libs, inputs):
    """The host build whose floats count their arithmetic (``csrc/op_count.h``,
    the bounds of kernels 2-4 in chip_smoke.py) gives kernels 4 and 2's
    outputs bit for bit, and counts at most half the operations that
    ``chip_smoke.count_ops`` counts on the plain versions' jets."""
    fam, X, U, lam, mu, curv, ds = _active(inputs)
    rho = inputs[5]
    count, lib = host_libs["count"], host_libs["team4"]
    for a, b in zip(host_derivs(count, fam, X, U, lam, mu, curv, ds),
                    host_derivs(lib, fam, X, U, lam, mu, curv, ds)):
        assert _same_bits(a, b)
    for a, b in zip(host_backward(count, fam, X, U, lam, mu, rho, curv, ds),
                    host_backward(lib, fam, X, U, lam, mu, rho, curv, ds)):
        assert _same_bits(a, b)
    dv_args, bw_args = (X, U, lam, mu, curv, ds), (X, U, lam, mu, rho, curv, ds)
    ops_dv, ops_bw = chip_smoke.code_op_counts(count, fam, dv_args, bw_args)
    plain_dv = chip_smoke.count_ops(lambda: derivs_plain(fam, *dv_args)) / B
    plain_bw = chip_smoke.count_ops(lambda: backward_plain(fam, *bw_args)) / B
    assert 0 < ops_dv < (1.0 if cuda_lib.is_kinematic(fam) else 0.5) * plain_dv
    assert ops_dv < ops_bw < plain_bw


def test_kc_seam_stash_columns_gate(kernel_lib, inputs):
    """The kc seam's Jacobian reads the stash (a_final from the previous Fx,
    the next w stash from the previous w), and the team's slot carries those
    columns: kernel 2 keeps the plain gains within BW_TOL
    (test_backward_team_matches_plain), while the plain gains with the
    seam's stash columns zeroed part from the intact ones by more than three
    times BW_TOL on most lanes, so that gate fails a slot that drops them."""
    fam, X, U, lam, mu, rho, curv, ds = inputs[:8]
    if not cuda_lib.is_kc(fam):
        pytest.skip("the kc cascade's seam")
    from vehicle_control_tpu_torch.solvers.backward_kernel_fm import stage_derivatives
    from vehicle_control_tpu_torch.solvers.riccati import riccati_from_derivs

    g, Hw, Jm = stage_derivatives(fam, X, U, lam, mu, curv, ds)
    seam = fam.N - 1
    assert (Jm[:, seam, 6, 8] != 0).all() and (Jm[:, seam, 7, 9] == 1).all()
    assert (Jm[:, :seam, :, 8:10] == 0).all() and (Jm[:, fam.N:, :, 8:10] == 0).all()
    dropped = Jm.clone()
    dropped[:, seam, :, 8:10] = 0.0
    ref = riccati_from_derivs(fam.NZ, g, Hw, Jm, rho)
    cut = riccati_from_derivs(fam.NZ, g, Hw, dropped, rho)
    got = host_backward(kernel_lib, fam, X, U, lam, mu, rho, curv, ds)
    ok = _finite_lanes(ref[:4]) & _finite_lanes(cut[:4])
    assert ok.float().mean() > 0.5
    err_cut = torch.stack([_lane_err(a[ok], b[ok]) for a, b in zip(cut[:2], ref[:2])]).amax(0)
    err_got = torch.stack([_lane_err(a[ok], b[ok]) for a, b in zip(got[:2], ref[:2])]).amax(0)
    assert (err_cut > 3 * BW_TOL).float().mean() > 0.5, err_cut
    assert err_got.max().item() < BW_TOL
