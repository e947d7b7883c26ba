"""The port's simulator layer against the JAX package's, on the CPU in float64.

The JAX runs (its simulator on the cut cascade and on the cut single
track, and its parity step) each cost ~25-40 s of tracing and
compilation, so they run in three subprocesses of this file (``python
tests/test_torch_simulation.py JOB OUT``) while the port's side runs here.
The port runs on the CPU, where the simulator builds its problems in f64
and every solve is kernel 3's plain version (``solve_plain``); the JAX
simulator runs its XLA solver in f64.  Tolerances:

* the device track lookups at 1,000 seeded s values: rtol 1e-12 (the same
  coefficient tables, the same formulas);
* ``make_racing_loop``: a chunk of 3 steps gives three single steps' bits;
* ``RacingSimulator``, 4 steps in chunks of 2, cascaded cut to N=4 + M=5
  and single track to N=6, the solver budget cut to 2 outer x 4 inner
  (``controller_overrides``): states, actions, violations and global
  predictions to rtol 1e-6 (absolute floor 1e-6 of each array's scale),
  accepted iterations equal: the whole-solve kernel's semantics agree
  with the XLA solver to rounding in f64 (``test_torch_cascaded_slice``);
* ``CascadedMPC.command`` on JAX's recorded states gives JAX's simulator
  actions (its step is the controllers' ``make_mpc_step``) to the same
  tolerance; its predictions equal JAX's controller's on the same carry to
  rtol 1e-12;
* ``action_parity`` of the port's parity step (kernels 1 and 2, their
  plain versions) against JAX's over 3 steps of the reference run
  ``verify_r5final_ippodromo``, budget 2 x 3, no polish: actions and the
  report to rtol 1e-6;
* ``summarize()`` of the same artifacts gives JAX's text; ``save`` and
  ``load`` round-trip; ``save_config`` reads back equal through
  ``parse_yaml`` and ``yaml.safe_load``;
* ``scripts.main --device cpu --steps 2`` with a simconfig whose
  ``output_dir`` is the test's temporary directory.

The full f64 lap against ``verify_r5final_ippodromo`` is marked slow (kernel
3's plain version takes ~30-40 s a solve at the full horizon on one core).
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import config_path, t, tracks
from vehicle_control_tpu.controllers.mpc import controllers as jctrl
from vehicle_control_tpu.controllers.mpc import problems as jproblems
from vehicle_control_tpu.environment import track as jtrack
from vehicle_control_tpu.simulation import RacingSimulator as JSimulator
from vehicle_control_tpu.simulation import analysis as janalysis
from vehicle_control_tpu.utils import profiling as jprofiling
from vehicle_control_tpu.utils.config import ConfigDict as JConfigDict
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.controllers.mpc import controllers as tctrl
from vehicle_control_tpu_torch.controllers.mpc import problems as tproblems
from vehicle_control_tpu_torch.environment import track as ttrack
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.scripts import main as tmain
from vehicle_control_tpu_torch.simulation import (
    KinematicRacingSimulator,
    RacingSimulator,
    make_racing_loop,
)
from vehicle_control_tpu_torch.simulation import analysis as tanalysis
from vehicle_control_tpu_torch.utils import profiling as tprofiling
from vehicle_control_tpu_torch.utils.config import (
    ConfigDict,
    dump_yaml,
    load_config,
    parse_yaml,
    project_root,
    save_config,
)

STEPS, CHUNK, DT = 4, 2, 0.05
BUDGET = {"n_outer": 2, "n_inner": 4}
OVERRIDES = {
    "cascaded": {"horizon": 4, "horizon_pm": 5, "solver": BUDGET},
    "singletrack": {"horizon": 6, "solver": BUDGET},
}
PARITY_BUDGET, PARITY_STEPS = dict(n_outer=2, n_inner=3, n_polish=0), 3
REF_RUN = os.path.join(project_root(), "experiments", "data", "verify_r5final_ippodromo")
JOBS = ("sim:cascaded", "sim:singletrack", "parity")


def _close(a, b, what, rtol=1e-6, atol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * (1.0 + np.abs(b).max()), err_msg=what)


def _simconfig(names, overrides=OVERRIDES, **extra):
    return {"track_name": "ippodromo", "controller_names": list(names), "obstacles": False,
            "name": "torch_sim_test", "save_data": False,
            "controller_overrides": {n: overrides[n] for n in names}, **extra}


def _car_track(loader):
    return (loader(config_path("models/dynamic_car.yaml")),
            loader(config_path("environment/ippodromo.yaml")))


def _cut_cascade(loader):
    cfg = loader(config_path("controllers/cascaded.yaml"))
    cfg.update(obstacles=False, **OVERRIDES["cascaded"])
    return cfg


# -- the JAX runs, in subprocesses ----------------------------------------------


def _jax_job(job, out):
    """Run one JAX reference and save its arrays to ``out`` (an .npz)."""
    kind, _, name = job.partition(":")
    if kind == "sim":
        sim = JSimulator(JConfigDict(_simconfig([name])), *_car_track(j_load_config))
        sim.run(max_steps=STEPS, chunk=CHUNK)
        arrays = dict(state=sim.state_traj[name], action=sim.action_traj[name],
                      violation=sim.violation_traj[name], iterations=sim.iter_traj[name],
                      preds=sim._global_preds(name))
    else:
        car, track_cfg = _car_track(j_load_config)
        prob = jproblems.build_cascaded_problem(car, jtrack.Track(track_cfg),
                                                _cut_cascade(j_load_config), "pm", jnp.float64)
        cfg = dataclasses.replace(jctrl.parity_solver_config(**PARITY_BUDGET), unroll=1)
        step, actions = jax.jit(jctrl.make_parity_step(prob, cfg)), []

        def recorded(carry, state):
            carry, action, info = step(carry, state)
            actions.append(np.asarray(action))
            return carry, action, info

        ref = janalysis.load_reference_run(REF_RUN, "cascaded")
        rep = janalysis.action_parity(recorded, jctrl.initial_carry(prob, jnp.float64), ref,
                                      n_steps=PARITY_STEPS)
        arrays = dict(actions=np.asarray(actions), **{k: np.asarray(v) for k, v in
                                                      rep._asdict().items()})
    np.savez(out, **arrays)


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """Start the JAX jobs at once; ``jax_runs(job)`` waits for one and
    returns its arrays."""
    out = tmp_path_factory.mktemp("jax_runs")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join([project_root(), os.path.dirname(__file__)]))
    procs = {job: subprocess.Popen(
        [sys.executable, __file__, job, str(out / f"{job.replace(':', '_')}.npz")],
        cwd=project_root(), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for job in JOBS}

    def result(job):
        proc = procs[job]
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"JAX job {job} failed:\n{log[-4000:]}"
        return dict(np.load(out / f"{job.replace(':', '_')}.npz"))

    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- the port alone and the cheap comparisons, then the parity step --------------


def test_track_lookups_match_jax():
    """curvature_derivative, position, orientation and rel2glob at 1,000
    seeded s values over negative s and later laps, rtol 1e-12."""
    jt, tt = tracks()
    rng = np.random.default_rng(0)
    s = rng.uniform(-1.5 * jt.length, 2.5 * jt.length, 1000)
    ey, epsi = rng.uniform(-3, 3, 1000), rng.uniform(-0.5, 0.5, 1000)
    pairs = [
        (ttrack.curvature_derivative(tt.data, t(s)), jtrack.curvature_derivative(jt.data, s)),
        *zip(ttrack.position(tt.data, t(s)), jtrack.position(jt.data, s)),
        (ttrack.orientation(tt.data, t(s)), jtrack.orientation(jt.data, s)),
        *zip(ttrack.rel2glob(tt.data, t(s), t(ey), t(epsi)),
             jtrack.rel2glob(jt.data, s, ey, epsi)),
    ]
    for i, (a, b) in enumerate(pairs):
        _close(a.numpy(), b, f"lookup {i}", 1e-12, 1e-12)


def test_save_config_round_trips(tmp_path):
    """Every shipped config and the emitter's edge cases read back equal
    through parse_yaml and yaml.safe_load."""
    edge = {"float": 1e-06, "big": -2.5e30, "whole": 3.0, "list": [1, 2.0, "x", None, True],
            "nested": [[0, 1], [2, 3]], "maps": [{"a": 1}, {"b": [1, 2]}], "empty": {},
            "none": [], "quote": "it's", "dquote": 'say "hi"', "true": "yes", "1": "null",
            "colon": "a: b # c", "blank": ""}
    configs = [load_config(p).to_dict() for p in sorted(glob.glob(
        os.path.join(project_root(), "configs", "**", "*.yaml"), recursive=True))]
    for i, data in enumerate(configs + [edge]):
        path = tmp_path / f"c{i}.yaml"
        save_config(ConfigDict(data), str(path))
        text = path.read_text()
        assert text == dump_yaml(data)
        assert parse_yaml(text) == data
        assert yaml.safe_load(text) == data
        assert load_config(str(path)).to_dict() == data
    for bad in ("line\nbreak", float("inf")):
        with pytest.raises(ValueError):
            dump_yaml({"a": bad})


def test_profiling_matches_jax(tmp_path):
    """solver_stats gives JAX's numbers; StepTimer keeps its layout; trace
    writes a Chrome trace."""
    rng = np.random.default_rng(0)
    viol, iters = rng.uniform(0, 1e-2, 50), rng.integers(0, 9, 50)
    assert tprofiling.solver_stats(viol, iters, viol < 5e-3) == jprofiling.solver_stats(
        viol, iters, viol < 5e-3)
    timer = tprofiling.StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert timer.elapsed.shape == (3,)
    assert set(timer.summary()) == {"mean_ms", "p50_ms", "p95_ms", "steps"}
    with tprofiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]


def test_analysis_loads_reference_run():
    """load_reference_run reads the reference run as JAX's does (the config
    through the port's own loader); summarize_run gives JAX's numbers."""
    ref, jref = (m.load_reference_run(REF_RUN, "cascaded") for m in (tanalysis, janalysis))
    for a, b in zip(ref[:3] + ref[4:], jref[:3] + jref[4:]):
        np.testing.assert_array_equal(a, b)
    assert ref.config.to_dict() == jref.config.to_dict()
    args = (ref.states, ref.actions, ref.elapsed, DT, 7, 0, 5)
    assert tanalysis.summarize_run(*args) == janalysis.summarize_run(*args)


def test_summarize_matches_jax(capsys):
    """summarize() of the same artifacts gives the JAX simulator's text."""
    sc = _simconfig(["cascaded"], {"cascaded": {}})
    port = RacingSimulator(ConfigDict(sc), *_car_track(load_config), device="cpu").load(REF_RUN)
    ref = JSimulator(JConfigDict(sc), *_car_track(j_load_config)).load(REF_RUN)
    text = port.summarize()
    assert text == ref.summarize()
    assert "Lap time (cascaded): 20.85 s" in text


def test_unported_options_raise():
    """The kinematic tail with obstacles and the render adapters raise; the
    kinematic tail without obstacles builds (tests/test_torch_cascaded_
    kinematic.py runs it), the kinematic family too (KinematicRacingSimulator
    and KinematicMPC on the CPU: tests/test_torch_kinematic.py runs them);
    obstacles reach the controller's problem (tests/test_torch_obstacles.py
    runs them)."""
    car, track_cfg = _car_track(load_config)
    with pytest.raises(NotImplementedError):
        RacingSimulator(ConfigDict(_simconfig(["cascaded_kinematic"], {"cascaded_kinematic": {}},
                                              obstacles=True)), car, track_cfg, device="cpu")
    kc = RacingSimulator(ConfigDict(_simconfig(["cascaded_kinematic"],
                                               {"cascaded_kinematic": {}})), car, track_cfg,
                         device="cpu")
    prob = kc.entries["cascaded_kinematic"].problem
    assert (prob.family.tail, prob.horizon, prob.nz) == ("kc", 40, 10)
    kin_car = load_config(config_path("models/kinematic_car.yaml"))
    kin = KinematicRacingSimulator(ConfigDict(_simconfig(["kinematic"], {"kinematic": {}})),
                                   kin_car, track_cfg, device="cpu")
    prob = kin.entries["kinematic"].problem
    assert (prob.family.tail, prob.horizon, prob.nz, prob.ns_model) == ("kinematic", 51, 8, 6)
    assert not prob.family.obstacles  # the simconfig's obstacles: False overrides the YAML's
    assert tuple(kin.entries["kinematic"].state.shape) == (1, 6)
    ctrl = tctrl.KinematicMPC(kin_car, ttrack.Track(track_cfg),
                              load_config(config_path("controllers/kinematic.yaml")), device="cpu")
    assert ctrl.problem.u_scale.dtype == torch.float64 and len(ctrl.problem.family.obstacles) == 7
    obs = RacingSimulator(ConfigDict(_simconfig(["cascaded"], {"cascaded": {}}, obstacles=True)),
                          car, track_cfg, device="cpu")
    assert len(obs.entries["cascaded"].problem.family.obstacles) == 7
    sim = RacingSimulator(ConfigDict(_simconfig(["cascaded"], save_images=True)), car,
                          track_cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        sim.run(max_steps=1)


def test_precision_warning():
    """make_mpc_step warns, as JAX's does, for an f64 problem where the
    kernels run (any device but the CPU; ``meta`` stands in for the card
    here), and not for f32 there or for the CPU's plain versions."""
    car, track_cfg = _car_track(load_config)
    track = ttrack.Track(track_cfg)
    cfg = _cut_cascade(load_config)
    solver = tctrl.controller_solver_config(cfg)
    for dtype, device, warns in ((torch.float64, "meta", True), (torch.float32, "meta", False),
                                 (torch.float64, "cpu", False)):
        prob = tproblems.build_cascaded_problem(car, track, cfg, "pm", dtype, device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tctrl.make_mpc_step(prob, solver)
        assert any("float32" in str(w.message) for w in caught) == warns, (dtype, device)


def test_chunk_equals_single_steps():
    """A chunk of 3 steps gives the bits of three chunks of one step."""
    car, track_cfg = _car_track(load_config)
    track = ttrack.Track(track_cfg)
    cfg = _cut_cascade(load_config)
    prob = tproblems.build_cascaded_problem(car, track, cfg, "pm", torch.float64, "cpu")
    solver = dataclasses.replace(tctrl.controller_solver_config(cfg), n_outer=1, n_inner=2)
    transition = tdc.make_transitions(tdc.DynamicCarParams.from_config(car))[0]
    run_chunk = make_racing_loop(prob, solver, transition, track.data, DT, 4)
    state = torch.tensor([[4.0, 0, 0, 0, 1.0, 0.1, 0, 0], [6.0, 0, 0, 0, 50.0, -0.5, 0.05, 0]],
                         dtype=torch.float64)
    carry = tctrl.MPCCarry(*(a.expand((2,) + a.shape).clone()
                             for a in tctrl.initial_carry(prob)))
    s3, c3, r3 = run_chunk(state, carry, 3)
    s1, c1, recs = state, carry, []
    for _ in range(3):
        s1, c1, r = run_chunk(s1, c1, 1)
        recs.append(r)
    assert r3.X_pred.shape == (2, 3, prob.horizon, prob.nz)
    for a, b in zip((s3, *c3, *r3), (s1, *c1, *(torch.cat(f, 1) for f in zip(*recs)))):
        assert torch.equal(a, b)
    assert run_chunk.kernels[0].launches == 0


def test_main_on_cpu(tmp_path, capsys):
    """``scripts.main --device cpu --steps 2`` races, saves the artifacts and
    the log under the simconfig's output_dir; ``load`` replays them;
    without --device it asks for the card, which raises here."""
    sc = _simconfig(["cascaded"], save_data=True, logging=True, output_dir=str(tmp_path))
    path = tmp_path / "simconfig.yaml"
    save_config(sc, str(path))
    sim = tmain.main(["--device", "cpu", "--steps", "2", "--config", str(path)])
    assert "Lap time (cascaded)" in capsys.readouterr().out
    run_dir = tmp_path / "data" / "torch_sim_test_ippodromo_torch"
    assert sorted(os.listdir(run_dir)) == sorted(
        f"cascaded_{k}" for k in ("action_traj.npy", "config.yaml", "elapsed.npy", "preds.npy",
                                  "state_traj.npy"))
    assert sim.state_traj["cascaded"].shape == (2, 8)
    assert (tmp_path / "logs" / "torch_sim_test_torch.log").read_text().startswith("Lap time")
    save_config(dict(sc, load=True), str(path))
    replay = tmain.main(["--device", "cpu", "--config", str(path)])
    np.testing.assert_array_equal(replay.state_traj["cascaded"], sim.state_traj["cascaded"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain.main(["--steps", "1", "--config", str(path)])


def test_parity_step_matches_jax(jax_runs):
    """action_parity of the port's parity step (UNSHIFTED warm start,
    kernels 1 + 2) over 3 steps of the reference run, against JAX's."""
    car, track_cfg = _car_track(load_config)
    prob = tproblems.build_cascaded_problem(car, ttrack.Track(track_cfg),
                                            _cut_cascade(load_config), "pm", torch.float64, "cpu")
    step, actions = tctrl.make_parity_step(prob, tctrl.parity_solver_config(**PARITY_BUDGET)), []

    def recorded(carry, state):
        carry, action, info = step(carry, state)
        actions.append(action[0].numpy())
        return carry, action, info

    carry = tctrl.MPCCarry(*(a[None] for a in tctrl.initial_carry(prob)))
    rep = tanalysis.action_parity(recorded, carry, tanalysis.load_reference_run(REF_RUN,
                                                                                "cascaded"),
                                  n_steps=PARITY_STEPS)
    ref = jax_runs("parity")
    _close(np.asarray(actions), ref["actions"], "parity actions")
    for key, value in rep._asdict().items():
        _close(value, ref[key], f"parity report {key}")
    assert [k.launches for k in step.kernels] == [0, 0]


# -- the port's simulator against JAX's ---------------------------------------


@pytest.fixture(scope="module")
def port_sim():
    sim = RacingSimulator(ConfigDict(_simconfig(["cascaded", "singletrack"])),
                          *_car_track(load_config), device="cpu")
    return sim.run(max_steps=STEPS, chunk=CHUNK)


@pytest.mark.parametrize("name", ["cascaded", "singletrack"])
def test_simulator_matches_jax(port_sim, jax_runs, name):
    ref = jax_runs(f"sim:{name}")
    assert port_sim.state_traj[name].shape == ref["state"].shape == (STEPS, 8)
    np.testing.assert_array_equal(port_sim.iter_traj[name], ref["iterations"])
    for key, ours in (("state", port_sim.state_traj[name]),
                      ("action", port_sim.action_traj[name]),
                      ("violation", port_sim.violation_traj[name]),
                      ("preds", port_sim._global_preds(name))):
        _close(ours, ref[key], f"{name} {key}")
    assert port_sim.elapsed[name].shape == (STEPS,)


def test_save_load_round_trip(port_sim, tmp_path):
    path = port_sim.save(str(tmp_path / "run"))
    other = RacingSimulator(ConfigDict(_simconfig(["cascaded", "singletrack"])),
                            *_car_track(load_config), device="cpu").load(path)
    for name in ("cascaded", "singletrack"):
        for attr in ("state_traj", "action_traj", "elapsed"):
            np.testing.assert_array_equal(getattr(other, attr)[name],
                                          getattr(port_sim, attr)[name])
        preds = np.load(os.path.join(path, f"{name}_preds.npy"))
        assert preds.shape == (STEPS, port_sim.entries[name].problem.horizon, 3)
        cfg_path = os.path.join(path, f"{name}_config.yaml")
        saved = port_sim.entries[name].config.to_dict()
        assert saved["elapsed_semantics"] == "chunk_mean"
        with open(cfg_path) as fh:
            assert yaml.safe_load(fh) == saved == load_config(cfg_path).to_dict()


def test_cascaded_mpc_matches_jax(jax_runs):
    """CascadedMPC.command on JAX's recorded states gives JAX's actions;
    state and action predictions and the global-frame prediction equal
    JAX's controller's on the same carry."""
    ref = jax_runs("sim:cascaded")
    car, track_cfg = _car_track(load_config)
    ctrl = tctrl.CascadedMPC(car, ttrack.Track(track_cfg), _cut_cascade(load_config),
                             device="cpu")
    assert ctrl.dtype == torch.float64
    for k in range(2):
        _close(ctrl.command(ref["state"][k]).numpy(), ref["action"][k], f"command {k}")
    jcar, jtrack_cfg = _car_track(j_load_config)
    jc = jctrl.CascadedMPC(jcar, jtrack.Track(jtrack_cfg), _cut_cascade(j_load_config))
    jc._carry = jctrl.MPCCarry(*(jnp.asarray(a[0].numpy()) for a in ctrl._carry))
    for ours, theirs in ((ctrl.get_state_prediction(), jc.get_state_prediction()),
                         (ctrl.state_prediction, jc.state_prediction),
                         (ctrl.action_prediction, jc.action_prediction)):
        _close(ours.numpy(), theirs, "prediction", 1e-12, 1e-12)
    ctrl.reset()
    np.testing.assert_array_equal(ctrl.state_prediction[:, 0].numpy(), 4.0)
    single = tctrl.SingleTrackMPC(car, ttrack.Track(track_cfg),
                                  dict(load_config(config_path("controllers/singletrack.yaml")),
                                       obstacles=False, horizon=6), device="cpu")
    assert single.get_state_prediction().shape == (6, 3)


@pytest.mark.slow
def test_full_lap_matches_reference():
    """The simconfig's lap (cascaded, N=20 + M=40, the YAML's budget) in f64
    on the CPU against the JAX f64 lap of verify_r5final_ippodromo (20.85 s,
    417 steps): the lap time within 0.05 s, violations under 1e-2."""
    sc = dict(load_config(os.path.join(project_root(), "configs", "simconfig.yaml")),
              save_data=False, logging=False)
    sim = RacingSimulator(ConfigDict(sc), *_car_track(load_config), device="cpu")
    sim.run(max_steps=600, chunk=25)
    ref = tanalysis.load_reference_run(REF_RUN, "cascaded")
    lap, ref_lap = (st[-1, 7] + DT for st in (sim.state_traj["cascaded"], ref.states))
    assert abs(lap - ref_lap) <= 0.05, (lap, ref_lap)
    assert sim.violation_traj["cascaded"].max() <= 1e-2


if __name__ == "__main__":
    _jax_job(sys.argv[1], sys.argv[2])
