"""The f64 witness of ``chip_smoke.py``'s lane-by-lane gates, on synthetic
tensors on the CPU (no card, no JAX).

Where the kernel misses a gate against the plain f32 version on a lane, the
plain version in f64 decides: the lane passes only if the witness sides with
the kernel (for +inf: the kernel's verdict on the same f32 inputs, or
verdicts as accurate against f64's as the plain f32 version's on copies of
the inputs one ulp apart), and at most ``WITNESS_SHARE`` of a
gate's lanes may be decided so.  Kernels 1 and 5: +inf on a rollout in one
f32 version only; kernel 3 check (i): a lane beyond SOLVE_TOL.  And check
(ii)'s gates on the whole solve, both f32 versions against f64
(``solve_gates``).
"""

import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

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


def test_solve_witness_sides_with_kernel():
    err, kern64, plain64 = _solve_errors()
    err[858] = 1.5e-4  # beyond SOLVE_TOL against the plain f32 version
    kern64[858], plain64[858] = 2e-4, 1e-4  # within 4x of the plain version's error
    out = chip_smoke.solve_witness("k3", err, kern64, plain64)
    assert out.startswith("1|858:err=0.00015")


def test_solve_witness_sides_with_plain_fails():
    err, kern64, plain64 = _solve_errors()
    err[858] = 1.5e-4
    kern64[858], plain64[858] = 1e-2, 1e-5  # the kernel far from f64, the plain version close
    with pytest.raises(RuntimeError, match="sides with the plain version"):
        chip_smoke.solve_witness("k3", err, kern64, plain64)
    err[858] = float("nan")  # a NaN error is disputed, not passed
    with pytest.raises(RuntimeError, match="sides with the plain version"):
        chip_smoke.solve_witness("k3", err, kern64, plain64)


def test_solve_witness_cap():
    err, kern64, plain64 = _solve_errors()
    n = int(chip_smoke.WITNESS_SHARE * err.numel()) + 1
    err[:n] = 1.5e-4
    with pytest.raises(RuntimeError, match=f"{n} of {err.numel()} lanes decided"):
        chip_smoke.solve_witness("k3", err, kern64, plain64)
    err[0] = 1e-6
    assert chip_smoke.solve_witness("k3", err, kern64, plain64).startswith(f"{n - 1}|")


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
