"""The f64 witness of ``chip_smoke.py``'s lane-by-lane gates, on synthetic
tensors on the CPU (no card, no JAX).

Where the kernel misses a gate against the plain f32 version on a lane, the
plain version in f64 decides: the lane passes only if the witness sides with
the kernel (for +inf: the kernel's verdict on the same f32 inputs, or
verdicts as accurate against f64's as the plain f32 version's on copies of
the inputs one ulp apart), and at most ``WITNESS_SHARE`` of a
gate's lanes may be decided so.  Kernels 1 and 5: +inf on a rollout in one
f32 version only; kernel 3 check (i): a lane beyond SOLVE_TOL
(``lane_witness``); on the obstacle cascade also a cost beyond LS_RTOL and a
lane that kernels 2 or 4 decide on a knife edge (``f64_copies_side``).  And
check (ii)'s gates on the whole solve, both f32 versions against f64
(``solve_gates``), and kernel 2's gates (``backward_gates``, which
``kernel_ab.py`` shares), and the obstacle lap's sides (``disc_passes``) and
its violation gate (``obstacle_violation_gate``).  And the kinematic
family's set-up (``family_model``, ``build_problem``: its car, plant, drops'
width and bench.py's budget) and the check that every kernel but 5 was
launched on its path, in each family that drives the earlier routes
(``unlaunched``).
"""

import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from vehicle_control_tpu_torch.solvers import cuda_lib

INF = math.inf


def _costs(n=4096):
    """(A, B) line-search costs: all finite, a few +inf rollouts in all three."""
    c = torch.linspace(1.0, 2.0, 6 * n).reshape(6, n)
    c[:, :3] = INF
    return c, c.clone(), c.double()


def test_inf_witness_agreeing_lanes_pass_undisputed():
    kern, plain, f64 = _costs()
    assert chip_smoke.inf_witness("k1", kern, plain, f64) == "0"


def test_inf_witness_sides_with_kernel():
    kern, plain, f64 = _costs()
    kern[2, 10] = INF  # the kernel crosses the state guard, the plain f32 version not
    f64[2, 10] = INF
    plain[4, 20] = INF  # the plain f32 version crosses it, the kernel not
    out = chip_smoke.inf_witness("k1", kern, plain, f64)
    assert out.startswith("2|") and "2/10:" in out and "4/20:" in out


def test_inf_witness_sides_with_plain_fails():
    kern, plain, f64 = _costs()
    kern[2, 10] = INF
    with pytest.raises(RuntimeError, match="sides with the plain version on 1 of 1"):
        chip_smoke.inf_witness("k1", kern, plain, f64)


def test_inf_witness_chaotic_rollout():
    """The kernel crosses the state guard where the plain f32 version and
    f64 stay finite: it passes only where, over copies of the inputs one
    ulp apart, the kernel misses f64's verdict at most 4x as often as the
    plain f32 version does (which also reaches +inf on some copies), not
    because the plain f32 version's cost is itself off f64's."""
    kern, plain, f64 = _costs()
    kern[0, 1435], plain[0, 1435], f64[0, 1435] = INF, 2.019e6, 1.411e13
    with pytest.raises(RuntimeError, match="sides with the plain version on 1 of 1"):
        chip_smoke.inf_witness("k1", kern, plain, f64)
    n = 64
    copies = [torch.full((n, *kern.shape), math.nan, dtype=torch.float64) for _ in range(3)]
    for c in copies:
        c[:, 0, 1435] = 1.4e13  # every copy finite in all three
    with pytest.raises(RuntimeError, match="sides with the plain version on 1 of 1"):
        chip_smoke.inf_witness("k1", kern, plain, f64, copies)
    copies[0][:5, 0, 1435] = INF  # the kernel +inf on 5 copies, the plain version on 7
    copies[1][10:17, 0, 1435] = INF
    out = chip_smoke.inf_witness("k1", kern, plain, f64, copies)
    assert out.startswith("1|0/1435:kernel=inf")
    assert "kernel_wrong=6,plain_wrong=7,f64_inf=0" in out
    copies[1][11:17, 0, 1435] = 1.4e13  # the plain version on 1 copy: 6 > 4 x 1, fails
    with pytest.raises(RuntimeError, match="sides with the plain version on 1 of 1"):
        chip_smoke.inf_witness("k1", kern, plain, f64, copies)
    copies[2][20:30, 0, 1435] = INF  # f64 +inf on 10 copies: the kernel 16 wrong, the plain 11
    out = chip_smoke.inf_witness("k1", kern, plain, f64, copies)
    assert "kernel_wrong=16,plain_wrong=11,f64_inf=10" in out


def test_ulp_copies():
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(8, 3, 2, generator=g) * 100, torch.full((8,), 300.0))
    lanes = torch.tensor([1, 6])
    x, mu = chip_smoke.ulp_copies(args, lanes, copies=4, exact=(1,))
    base = args[0][lanes].repeat(4, 1, 1)  # copy-major
    up = torch.nextafter(base, torch.full_like(base, INF))
    down = torch.nextafter(base, torch.full_like(base, -INF))
    assert x.dtype == torch.float32 and x.shape == (8, 3, 2)
    assert ((x == up) | (x == down)).all() and (x == up).any() and (x == down).any()
    assert torch.equal(mu, torch.full((8,), 300.0))
    costs = chip_smoke.copy_costs(lambda a, m: a.sum((1, 2))[None].repeat(2, 1), (x, mu), lanes,
                                  (2, 8))
    assert costs.shape == (4, 2, 8)
    assert torch.isnan(costs[:, :, [0, 2, 3, 4, 5, 7]]).all()
    assert torch.equal(costs[:, 1, lanes], x.sum((1, 2)).double().reshape(4, 2))


def test_inf_witness_cap():
    kern, plain, f64 = _costs()
    n = int(chip_smoke.WITNESS_SHARE * kern.numel()) + 1  # one past 1 in 1,000
    kern[0, 100:100 + n] = INF
    f64[0, 100:100 + n] = INF
    with pytest.raises(RuntimeError, match=f"{n} of {kern.numel()} lanes decided"):
        chip_smoke.inf_witness("k1", kern, plain, f64)
    kern[0, 100] = plain[0, 100]  # at the cap: passes
    f64[0, 100] = plain[0, 100]
    assert chip_smoke.inf_witness("k1", kern, plain, f64).startswith(f"{n - 1}|")


def _solve_errors(n=4096):
    """(err, kern64, plain64) per lane, every lane within SOLVE_TOL."""
    err = torch.full((n,), 1e-6, dtype=torch.float64)
    return err, torch.full_like(err, 1e-5), torch.full_like(err, 1e-5)


def _solve_witness(err, kern64, plain64):
    """Check (i)'s witness as ``run_family`` calls it on the obstacle-free
    families."""
    return chip_smoke.lane_witness("k3", ~(err <= chip_smoke.SOLVE_TOL), kern64, plain64,
                                   chip_smoke.LS_FLOOR, err=err)


def test_solve_witness_sides_with_kernel():
    err, kern64, plain64 = _solve_errors()
    err[858] = 1.5e-4  # beyond SOLVE_TOL against the plain f32 version
    kern64[858], plain64[858] = 2e-4, 1e-4  # within 4x of the plain version's error
    out = _solve_witness(err, kern64, plain64)
    assert out.startswith("1|858:err=0.00015")


def test_solve_witness_sides_with_plain_fails():
    err, kern64, plain64 = _solve_errors()
    err[858] = 1.5e-4
    kern64[858], plain64[858] = 1e-2, 1e-5  # the kernel far from f64, the plain version close
    with pytest.raises(RuntimeError, match="sides with the plain version"):
        _solve_witness(err, kern64, plain64)
    err[858] = float("nan")  # a NaN error is disputed, not passed
    with pytest.raises(RuntimeError, match="sides with the plain version"):
        _solve_witness(err, kern64, plain64)


def test_solve_witness_cap():
    err, kern64, plain64 = _solve_errors()
    n = int(chip_smoke.WITNESS_SHARE * err.numel()) + 1
    err[:n] = 1.5e-4
    with pytest.raises(RuntimeError, match=f"{n} of {err.numel()} lanes decided"):
        _solve_witness(err, kern64, plain64)
    err[0] = 1e-6
    assert _solve_witness(err, kern64, plain64).startswith(f"{n - 1}|")


def _solve(conv, cost, iters):
    """Solve outputs with the trace, as check (ii) reads them."""
    n = len(conv)
    return (None, None, None, torch.as_tensor(cost, dtype=torch.float32), None,
            torch.as_tensor(conv), torch.as_tensor(iters, dtype=torch.int32),
            dict(inner_runs=torch.full((n,), 13, dtype=torch.int32)))


def _solves(n=4096):
    """(kernel, plain f32, f64): f64 converges on 3/4 of the lanes, and each
    f32 version parts from it on 800 lanes of its own (400 each way), at a
    cost 1e-3 off f64's."""
    conv = torch.ones(n, dtype=torch.bool)
    conv[: n // 4] = False
    cost = torch.linspace(1.0, 2.0, n).double()
    it = torch.full((n,), 9)
    kern_c, plain_c = conv.clone(), conv.clone()
    kern_c[:400], kern_c[2048:2448] = True, False
    plain_c[500:900], plain_c[3000:3400] = True, False
    return (_solve(kern_c, cost * (1 + 1e-3), it), _solve(plain_c, cost * (1 + 1e-3), it),
            _solve(conv, cost, it))


def test_solve_gates_kernel_as_far_as_plain_passes():
    kern, plain, f64 = _solves()
    rows, passed = chip_smoke.solve_gates(kern, plain, f64)
    assert passed, rows
    assert rows["flips_vs_f64"] == "0.1953/0.1953"


def test_solve_gates_kernel_beyond_plain_fails():
    kern, plain, f64 = _solves()
    kern[5][1500:1600] = False  # 100 more flips: 2.4% beyond the plain's
    assert not chip_smoke.solve_gates(kern, plain, f64)[1]
    kern, plain, f64 = _solves()
    kern[3][:] = kern[3] * 1.01  # cost median 1e-2 against f64, the plain's 1e-3
    assert not chip_smoke.solve_gates(kern, plain, f64)[1]
    kern, plain, f64 = _solves()
    kern[6][:2000] = 3  # iterations 6 away on half the lanes
    assert not chip_smoke.solve_gates(kern, plain, f64)[1]


def _gains(n=64, seed=0):
    """Kernel 2's (kff, Kfb, dV1, dV2, fail) on n lanes, H=3, and an f64 copy."""
    g = torch.Generator().manual_seed(seed)
    out = (torch.randn(n, 3, 2, generator=g), torch.randn(n, 3, 2, 10, generator=g),
           torch.randn(n, generator=g), torch.randn(n, generator=g),
           torch.zeros(n, dtype=torch.bool))
    return out, tuple(t.double() if t.is_floating_point() else t for t in out)


def _perturbed(gains, lane=None, value=None, scale=0.0):
    """A copy of gains, each float entry off by scale of its lane's largest
    magnitude, with kff[lane, 0, 0] = value if lane is given."""
    out = [t.clone() for t in gains]
    for t in out[:4]:
        t += scale * (1.0 + t.abs().reshape(t.shape[0], -1).amax(-1)).reshape(
            (-1,) + (1,) * (t.dim() - 1))
    if lane is not None:
        out[0][lane, 0, 0] = value
    return tuple(out)


@pytest.mark.parametrize("case, missed", [
    ("same", False), ("within_tol", False), ("beyond_tol", True),
    ("kernel_nan_lane", True), ("plain_nan_lane", True), ("both_nan_lane", False),
    ("fail_flag", True),
])
def test_backward_gates_at_rho_well(case, missed):
    """Kernel 2's gates at rho = RHO_WELL: within BW_TOL of each lane's
    largest magnitude, the same fail flags and the same non-finite lanes
    (either way round); a lane non-finite in both is not compared."""
    ref, _ = _gains()
    got = dict(same=ref, within_tol=_perturbed(ref, scale=0.5 * chip_smoke.BW_TOL),
               beyond_tol=_perturbed(ref, scale=2.0 * chip_smoke.BW_TOL),
               kernel_nan_lane=_perturbed(ref, 5, math.nan), plain_nan_lane=ref,
               both_nan_lane=_perturbed(ref, 5, math.nan), fail_flag=ref)[case]
    if case in ("plain_nan_lane", "both_nan_lane"):
        ref = _perturbed(ref, 5, math.nan)
    if case == "fail_flag":
        got = got[:4] + (got[4].clone().index_fill_(0, torch.tensor([3]), True),)
    rows, _, miss = chip_smoke.backward_gates("k2", got, ref)
    assert (miss is not None) == missed, miss
    assert rows["nonfinite_lanes"] == int(case in ("plain_nan_lane", "both_nan_lane"))


@pytest.mark.parametrize("factor, missed", [(1.0, False), (3.0, False), (20.0, True)])
def test_backward_gates_at_rho0_against_f64(factor, missed):
    """At the solver's rho0 each output's lane errors against f64 are held,
    quantile by quantile, to QUANT_FACTOR x the plain f32 version's."""
    ref, ref64 = _gains(seed=1)
    plain = _perturbed(ref, scale=1e-3)
    got = _perturbed(ref, scale=factor * 1e-3)
    _, _, miss = chip_smoke.backward_gates("k2", got, plain, ref64)
    assert (miss is not None) == missed, miss


def test_scripts_import_no_jax():
    """chip_smoke.py and kernel_ab.py import neither jax nor the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\nimport chip_smoke, kernel_ab\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'vehicle_control_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_disc_passes():
    """The obstacle lap's sides and least distances: "left" where the car
    is above a disc's ey at its nearest state."""
    s = torch.linspace(0.0, 60.0, 121).double().numpy()
    states = torch.zeros(121, 8, dtype=torch.float64).numpy()
    states[:, 4] = s
    states[:, 5] = [2.5 if abs(v - 30.0) < 5 else (-2.0 if abs(v - 50.0) < 5 else 0.0) for v in s]
    (side0, d0), (side1, d1) = chip_smoke.disc_passes(states, ((30.0, 0.0, 1.0), (50.0, 0.5, 2.0)))
    assert (side0, side1) == ("left", "right")
    assert d0 == pytest.approx(2.5) and d1 == pytest.approx(2.5)


@pytest.mark.parametrize("kern_f64,missed", [(3e-4, False), (1e-2, True)])
def test_cost_witness_beyond_rtol(kern_f64, missed):
    """On the obstacle cascade a rollout beyond LS_RTOL of the plain f32
    version passes only where the kernel is, against f64, as accurate as
    the plain f32 version; the other families keep the direct gate."""
    kern, plain, f64 = _costs()
    f64[:, 100] = 1.5
    plain[:, 100] = 1.5 * (1 + 1e-4)
    kern[:, 100] = 1.5 * (1 + kern_f64)

    def rtol_witness(kern, share):
        fin = torch.isfinite(kern) & torch.isfinite(plain)
        rel = torch.zeros(kern.shape, dtype=torch.float64)
        rel[fin] = chip_smoke.cost_errors(kern[fin], plain[fin])
        return chip_smoke.lane_witness(
            "k1", fin & ~(rel <= chip_smoke.LS_RTOL), chip_smoke.cost_errors(kern, f64),
            chip_smoke.cost_errors(plain, f64), chip_smoke.LS_FLOOR, share, err=rel)

    share = chip_smoke.FAMILY_SHARES["cascaded_obstacles"]["rtol"]
    if missed:
        with pytest.raises(RuntimeError, match="sides with the plain"):
            rtol_witness(kern, share)
    else:
        assert rtol_witness(kern, share).startswith("6|")
    with pytest.raises(RuntimeError, match="sides with the plain" if missed else "at most 0.0"):
        rtol_witness(kern, 0.0)  # a direct gate: no rollout beyond LS_RTOL
    assert rtol_witness(plain, 0.0) == "0"


def _rounded(phase):
    """A version of y = 1e3 x whose f32 result carries a rounding-like error
    of 1e-3 that turns on the input's last bits (none in f64); ``phase``
    picks the realization."""
    def fn(x):
        noise = 1e-3 * torch.sin(1e7 * x.double() + phase) if x.dtype == torch.float32 else 0.0
        return ((1e3 * x.double() + noise).to(x.dtype),)
    return fn


def _lane_errors(a, b):
    return (a[0].double() - b[0].double()).abs().amax(-1)


@pytest.mark.parametrize("kernel_bias,missed", [
    (0.0, False),  # another realization of the same rounding: as accurate on copies
    (2e-2, True),  # a kernel off by 20x the rounding on every copy is wrong
])
def test_knife_edge_witness(kernel_bias, missed):
    """A lane that f64 on its own inputs gives to the plain version passes
    only where, on its inputs and copies of them one ulp apart, the kernel's
    mean error against f64 is within 4x the plain f32 version's
    (``copies_side``)."""
    x = torch.linspace(1.0, 2.0, 4096).reshape(1024, 4).contiguous()
    kernel = lambda x: (_rounded(1.0)(x)[0] + kernel_bias,)  # noqa: E731
    plain = _rounded(0.0)
    ref, ref64, got = plain(x), plain(x.double()), kernel(x)
    kern64, plain64 = _lane_errors(got, ref64), _lane_errors(ref, ref64)
    plain64[7] = 1e-9  # the plain version on the lane's own inputs happens to be exact
    disputed = torch.zeros(1024, dtype=torch.bool)
    disputed[7] = True
    edge = lambda lanes: chip_smoke.copies_side(lanes, kernel, plain, _lane_errors, (x,),  # noqa
                                                chip_smoke.LS_FLOOR)
    args = (disputed, kern64, plain64, chip_smoke.LS_FLOOR,
            chip_smoke.FAMILY_SHARES["cascaded_obstacles"]["solve"], edge)
    if missed:
        with pytest.raises(RuntimeError, match="sides with the plain"):
            chip_smoke.lane_witness("k3", *args)
    else:
        assert chip_smoke.lane_witness("k3", *args).endswith(",copies=1")


@pytest.mark.parametrize("viols,missed", [
    ({174: (0.1465, 0.14, 0.139)}, False),  # f64 leaves the state as violated
    ({174: (0.1465, 0.04, 0.001)}, False),  # the plain f32 solve too
    ({174: (0.1465, 0.002, 0.001)}, True),  # only the kernel: a fault
])
def test_obstacle_violation_gate(viols, missed):
    """The obstacle lap's largest violation beyond LAP_VIOL_MAX passes only
    where, at that step, kernel 3's violation is at most 4x the plain
    solve's in f32 or f64 on the same inputs, plus LAP_VIOL_MAX."""
    chip_smoke.obstacle_violation_gate(dict(max_violation=0.005), {})
    lap = dict(max_violation=0.1465)
    if missed:
        with pytest.raises(RuntimeError, match="max violation"):
            chip_smoke.obstacle_violation_gate(lap, viols)
    else:
        chip_smoke.obstacle_violation_gate(lap, viols)


def test_kinematic_family_setup():
    """The kinematic family: bench.py's budget (2 x 3, 6 steps, mu0 = 10),
    kinematic.yaml as shipped (N=50, obstacles on), the kinematic car's
    plant (s at field 2 of 6), the earlier routes driven."""
    env = chip_smoke.make_env(torch.device("cpu"))
    ctrl_yaml, tail, overrides, budget = chip_smoke.FAMILIES["kinematic"]
    assert (ctrl_yaml, tail, overrides) == ("kinematic.yaml", "kinematic", dict(obstacles=True))
    assert budget == dict(n_outer=2, n_inner=3, n_alpha=6, mu0=10.0)
    assert "kinematic" in chip_smoke.SIDE_ROUTES
    # its knife-edge shares (the obstacle cascade's stay as they were)
    assert chip_smoke.FAMILY_SHARES["kinematic"] == dict(rtol=chip_smoke.WITNESS_SHARE,
                                                         kernel2=1e-2, solve=1e-1)
    assert chip_smoke.FAMILY_SHARES["cascaded_obstacles"] == dict(
        rtol=chip_smoke.WITNESS_SHARE, kernel2=1e-2, kernel4=1e-2, solve=5e-2)
    assert {k: chip_smoke.FAMILY_COPIES[k] for k in ("cascaded_obstacles", "kinematic")} == {
        "cascaded_obstacles": ("solve",), "kinematic": ("solve", "kernel2")}
    car, transition, s_index, ns = chip_smoke.family_model("kinematic", env)
    assert car is env["kin_car"] and transition is env["kin_transition"] and (s_index, ns) == (2, 6)
    assert chip_smoke.family_model("cascaded", env)[2:] == (4, 8)
    prob = chip_smoke.build_problem("kinematic", car, env["track"], torch.float32, "cpu",
                                    env["root"])
    fam = prob.family
    assert (fam.tail, fam.N, fam.H, fam.NZ, len(fam.obstacles)) == ("kinematic", 50, 51, 8, 7)
    state = torch.zeros(1, 6)
    state[0, 0], state[0, 2] = 5.0, 10.0
    nxt = transition(state, torch.zeros(1, 2), torch.zeros(1), chip_smoke.DT)
    assert nxt[0, 2].item() == pytest.approx(10.25)  # s + v dt on the straight


def test_cascaded_kinematic_family_setup():
    """The kc cascade: bench.py's cascaded_kinematic budget (3 x 8 + 6
    polish, 6 steps, mu0 = 300), cascaded_kinematic.yaml as shipped (N=20 +
    K=20, obstacles off), the dynamic car's plant, the kernels' _kc
    instantiation; its lap among the simulator's, held at its split."""
    env = chip_smoke.make_env(torch.device("cpu"))
    ctrl_yaml, tail, overrides, budget = chip_smoke.FAMILIES["cascaded_kinematic"]
    assert (ctrl_yaml, tail, overrides) == ("cascaded_kinematic.yaml", "kc",
                                            dict(horizon=20, horizon_kc=20))
    assert budget == dict(n_outer=3, n_inner=8, n_polish=6, n_alpha=6, mu0=300.0)
    assert "cascaded_kinematic" not in chip_smoke.SIDE_ROUTES
    assert chip_smoke.CPU_F64_LANES["cascaded_kinematic"] == 1024
    assert "cascaded_kinematic" in chip_smoke.LAPS
    # its knife-edge shares: the kinematic bicycle's steering stop and box rows
    # on its tail (PERF.md: 15 lanes of kernel 2 at rho = 1, 40 at rho0, 16 of
    # check (i))
    assert chip_smoke.FAMILY_SHARES["cascaded_kinematic"] == dict(
        rtol=chip_smoke.WITNESS_SHARE, kernel2=2e-2, solve=1e-2)
    assert chip_smoke.FAMILY_COPIES["cascaded_kinematic"] == ("solve", "kernel2")
    assert (chip_smoke.KC_SPLIT_M, chip_smoke.KC_SPLIT_REF_S) == (200.0, 13.80)
    car, transition, s_index, ns = chip_smoke.family_model("cascaded_kinematic", env)
    assert car is env["car"] and transition is env["transition"] and (s_index, ns) == (4, 8)
    prob = chip_smoke.build_problem("cascaded_kinematic", car, env["track"], torch.float32,
                                    "cpu", env["root"])
    fam = prob.family
    assert (fam.tail, fam.N, fam.H, fam.NZ, fam.obstacles) == ("kc", 20, 40, 10, ())
    assert cuda_lib.entry(fam, "vct_solve_fm_info") == "vct_solve_fm_kc_info"
    assert len(cuda_lib.family_params(fam)) == len(cuda_lib.KC_PARAM_FIELDS)


def _kernels_line(launches):
    """A kernels line's launch counts: {kernel: {family: launches}}."""
    return [dict(name=name, launches=sum(per.values()),
                 per_family={f: dict(launches=n) for f, n in per.items()})
            for name, per in launches.items()]


def test_unlaunched_kernels():
    """Kernel 5 may stay unlaunched; kernels 1, 2 and 4 must run in every
    family that drives the earlier routes, kernel 3 in every family."""
    ok = {"linesearch_fm": dict(singletrack=13, cascaded=0, kinematic=6),
          "backward_fm": dict(singletrack=13, cascaded=0, kinematic=6),
          "solve_fm": dict(singletrack=40, cascaded=40, kinematic=415),
          "derivs_fm": dict(singletrack=13, cascaded=0, kinematic=6),
          "linesearch_aos": dict(singletrack=0, cascaded=0, kinematic=0)}
    assert chip_smoke.unlaunched(_kernels_line(ok)) == []
    bad = dict(ok, derivs_fm=dict(singletrack=13, cascaded=0, kinematic=0),
               solve_fm=dict(singletrack=40, cascaded=0, kinematic=415))
    assert chip_smoke.unlaunched(_kernels_line(bad)) == [("solve_fm", "cascaded"),
                                                         ("derivs_fm", "kinematic")]


def test_kinematic_lap_action_witness():
    """The kinematic lap's first actions: a step beyond ACTION_TOL and the
    plain f32 version's error passes where its error against f64 is at
    most 4x the plain's (one step of SNAP_STEPS at most); the cascade lap
    has no such rule."""
    label = "kinematic_vs_plain"
    assert "kernel3_vs_plain" not in chip_smoke.LAP_SHARES
    steps = [(1e-5, 2e-5, True), (2e-4, 1e-4, True), (1.349e-1, 1.247e-1, False)]
    assert chip_smoke.action_witness(label, steps).startswith("1|")
    assert chip_smoke.action_witness(label, steps[:2]) == "0"
    with pytest.raises(RuntimeError, match="sides with the plain version"):
        chip_smoke.action_witness(label, steps[:2] + [(0.6, 0.1, False)])
    with pytest.raises(RuntimeError, match="decided by the witness"):
        chip_smoke.action_witness(label, [(0.2, 0.1, False), (0.2, 0.1, False), (0.0, 0.0, True)])
