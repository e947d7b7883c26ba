"""The racing simulators and their run artifacts (counterpart of
vehicle_control_tpu/simulation/racing.py): ``RacingSimulator`` (the dynamic
car) and ``KinematicRacingSimulator`` (the kinematic car).

Controllers race as ghost cars on one track: each runs its closed loop
(``closed_loop.make_racing_loop``, a batch of one) in chunks to lap
completion, with one device-to-host fetch a chunk; ``summarize()`` prints
the run's statistics and ``save()``/``load()`` keep the reference's
``.npy`` layout (``{ctrl}_state_traj.npy``, ``_action_traj.npy``,
``_preds.npy``, ``_elapsed.npy`` and ``{ctrl}_config.yaml``).

Route and precision: on the card the problem is built in f32 and every
solve is one launch of kernel 3 at the controller YAML's budget
(``controller_solver_config``); on the CPU it is built in f64 and the
solve is kernel 3's plain version.  The JAX simulator runs its XLA solver
in f64.  The artifacts go to ``{output_dir}/data/{name}_{track}_torch``
(``output_dir``: the simconfig's, else ``experiments/``), beside the JAX
package's ``{name}_{track}``, which the port never overwrites.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vehicle_control_tpu_torch.controllers.mpc import problems
from vehicle_control_tpu_torch.controllers.mpc.controllers import (
    MPCCarry,
    controller_solver_config,
    initial_carry,
)
from vehicle_control_tpu_torch.environment import track as track_mod
from vehicle_control_tpu_torch.environment.track import Track
from vehicle_control_tpu_torch.models import dynamic_car as dc
from vehicle_control_tpu_torch.models import kinematic_car as kc
from vehicle_control_tpu_torch.simulation.closed_loop import StepRecord, make_racing_loop
from vehicle_control_tpu_torch.utils.config import load_config, project_root, save_config
from vehicle_control_tpu_torch.utils.device import DEFAULT_DEVICE, default_dtype, require_device
from vehicle_control_tpu_torch.utils.profiling import StepTimer, solver_stats


def _controller_config_path(name: str) -> str:
    return os.path.join(project_root(), "configs", "controllers", f"{name}.yaml")


def _build_problem(name: str, ctrl_cfg, car_cfg, track, dtype, device):
    """The problem family from the config's shape, as the JAX simulator
    picks it (``horizon_kc``: the kinematic tail, ``horizon_pm``: the point
    mass, else the pure kinematic bicycle)."""
    if "horizon_kc" in ctrl_cfg:
        return problems.build_cascaded_problem(car_cfg, track, ctrl_cfg, "kc", dtype, device)
    if "horizon_pm" in ctrl_cfg:
        return problems.build_cascaded_problem(car_cfg, track, ctrl_cfg, "pm", dtype, device)
    return problems.build_kinematic_problem(car_cfg, track, ctrl_cfg, dtype, device)


class _Entry:
    """One car + controller pair (a 'ghost car' lane)."""

    def __init__(self, name, problem, run_chunk, carry, state, ctrl_cfg):
        self.name = name
        self.problem = problem
        self.run_chunk = run_chunk
        self.carry = carry
        self.state = state
        self.config = ctrl_cfg
        self.timer = StepTimer()  # one time a chunk
        self.chunks = []  # the host's StepRecords, one a chunk
        self.elapsed = []
        self.done = False
        self.steps = 0


def _fetch(state, recs: StepRecord):
    """The next state and a chunk's records (batch of one) on the host, in
    one device-to-host copy: (the next state, StepRecord) as numpy arrays
    in their own dtypes, the batch axis dropped (records time first)."""
    fields = (state,) + tuple(recs)
    flat = torch.cat([f.reshape(f.shape[0], -1).to(torch.float64) for f in fields], 1)[0]
    flat = flat.cpu().numpy()
    out, at = [], 0
    for f in fields:
        size = f[0].numel()
        out.append(flat[at:at + size].reshape(f.shape[1:]).astype(
            str(f.dtype).removeprefix("torch.")))
        at += size
    return out[0], StepRecord(*out[1:])


class RacingSimulator:
    """Dynamic-car racing loop.

    ``device`` is the card unless the caller asks for another; ``dtype``
    defaults to f32 on the card and f64 elsewhere (``default_dtype``)."""

    model = "dynamic"
    s_index = 4
    t_index = 7
    ey_index = 5
    speed_index = 0

    def __init__(self, simconfig, carconfig, trackconfig, device=DEFAULT_DEVICE, dtype=None):
        self.device = require_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.config = simconfig
        self.car_config = carconfig
        self.name = simconfig.get("name", "run")
        self.track = Track(trackconfig)
        self.dt = float(carconfig["dt"])
        output_dir = simconfig.get("output_dir") or os.path.join(project_root(), "experiments")
        self.src_dir = os.path.join(output_dir, "data", f"{self.name}_{trackconfig['name']}_torch")
        self.log_path = os.path.join(output_dir, "logs", f"{self.name}_torch.log")
        self._track_data = self.track.data.to(self.device, self.dtype)
        transition = self._plant_transition()
        names = list(simconfig.get("controller_names", ["cascaded"]))
        overrides = simconfig.get("controller_overrides", {}) or {}
        self.entries = {}
        for name in names:
            ctrl_cfg = load_config(_controller_config_path(name))
            ctrl_cfg["obstacles"] = bool(simconfig.get("obstacles", False))
            for key, val in dict(overrides.get(name, {})).items():
                ctrl_cfg[key] = val
            problem = _build_problem(name, ctrl_cfg, carconfig, self.track, self.dtype,
                                     self.device)
            run_chunk = make_racing_loop(problem, controller_solver_config(ctrl_cfg),
                                         transition, self._track_data, self.dt, self.s_index)
            carry = MPCCarry(*(a[None] for a in initial_carry(problem)))
            self.entries[name] = _Entry(name, problem, run_chunk, carry, self._initial_state(),
                                        ctrl_cfg)

    def _plant_transition(self):
        return dc.make_transitions(dc.DynamicCarParams.from_config(self.car_config))[0]

    def _initial_state(self):
        # Ux=4, s=1: a standing start at the line
        state = torch.zeros(1, 8, dtype=self.dtype, device=self.device)
        state[0, 0], state[0, 4] = 4.0, 1.0
        return state

    # -- main loop -----------------------------------------------------------

    def run(self, max_steps: int = 2500, chunk: int = 25):
        """Run every controller to lap completion (or ``max_steps``).

        ``chunk`` steps run between two host fetches (the last chunk is cut
        to ``max_steps``), so wall-clock is observable at chunk granularity
        and the saved per-step elapsed is the chunk mean; ``chunk=1`` gives
        per-step timings.  The saved ``elapsed_semantics`` records which.
        A later call goes on from where this one stopped.
        """
        if self.config.get("save_images", False):
            raise NotImplementedError("save_images: the render adapters are not ported "
                                      "(ROADMAP item 'The render adapters')")
        self._chunk = chunk
        lap_s = self.track.length - 0.1
        for entry in self.entries.values():
            while not entry.done and entry.steps < max_steps:
                n = min(chunk, max_steps - entry.steps)
                with entry.timer:
                    state, carry, recs = entry.run_chunk(entry.state, entry.carry, n)
                    next_state, host = _fetch(state, recs)
                entry.state, entry.carry = state, carry
                entry.chunks.append(host)
                entry.elapsed.append(np.full(n, entry.timer.times[-1] / n))
                entry.steps += n
                if float(next_state[self.s_index]) > lap_s:
                    entry.done = True
        self._finalize()
        if self.config.get("save_data", False):
            self.save()
        if self.config.get("logging", False):
            self._write_log()
        return self

    def _write_log(self):
        """The run's summary and solver health, written after the run."""
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        with open(self.log_path, "w") as fh:
            fh.write(self.summarize() + "\n")
            for name in self.violation_traj:
                stats = solver_stats(
                    self.violation_traj[name],
                    self.iter_traj[name],
                    self.violation_traj[name] < 1e-2,
                )
                fh.write(f"{name} solver: {stats}\n")
        return self.log_path

    def _finalize(self):
        self.state_traj = {}
        self.action_traj = {}
        self.elapsed = {}
        self.pred_traj = {}
        self.violation_traj = {}
        self.iter_traj = {}
        for name, e in self.entries.items():
            if not e.chunks:
                continue
            recs = StepRecord(*(np.concatenate(f) for f in zip(*e.chunks)))
            # trim to lap completion
            s = recs.state[:, self.s_index]
            lap = np.argmax(s > self.track.length - 0.1)
            end = lap + 1 if s[lap] > self.track.length - 0.1 else len(s)
            self.state_traj[name] = recs.state[:end]
            self.action_traj[name] = recs.action[:end]
            self.elapsed[name] = np.concatenate(e.elapsed)[:end]
            self.pred_traj[name] = recs.X_pred[:end]
            self.violation_traj[name] = recs.violation[:end]
            self.iter_traj[name] = recs.iterations[:end]

    # -- statistics ------------------------------------------------------------

    def summarize(self):
        lines = []
        for name in self.state_traj:
            st = self.state_traj[name].astype(np.float64)
            ac = self.action_traj[name].astype(np.float64)
            el = self.elapsed[name]
            laptime = st[-1, self.t_index] + self.dt
            lines.append(f"Lap time ({name}): {laptime:.2f} s")
            lines.append(f"Mean step time ({name}): {np.mean(el) * 1e3:.2f} ms")
            lines.append(f"Median step time ({name}): {np.median(el) * 1e3:.2f} ms")
            lines.append(f"Average speed ({name}): {np.mean(st[:, self.speed_index]):.2f} m/s")
            lines.append(f"Mean |u0| ({name}): {np.mean(np.abs(ac[:, 0])):.2f}")
            lines.append(f"MSE ey ({name}): {np.mean(st[:, self.ey_index] ** 2):.3f}")
        text = "\n".join(lines)
        print(text)
        return text

    def save_animation(self, *args, **kwargs):
        raise NotImplementedError("the render adapters are not ported "
                                  "(ROADMAP item 'The render adapters')")

    # -- persistence -------------------------------------------------------------

    def save(self, path: str | None = None):
        path = path or self.src_dir
        os.makedirs(path, exist_ok=True)
        for name in self.state_traj:
            np.save(os.path.join(path, f"{name}_state_traj.npy"), self.state_traj[name])
            np.save(os.path.join(path, f"{name}_action_traj.npy"), self.action_traj[name])
            np.save(os.path.join(path, f"{name}_preds.npy"), self._global_preds(name))
            np.save(os.path.join(path, f"{name}_elapsed.npy"), self.elapsed[name])
            cfg_out = self.entries[name].config
            cfg_out["elapsed_semantics"] = (
                "per_step" if getattr(self, "_chunk", 25) == 1 else "chunk_mean"
            )
            save_config(cfg_out, os.path.join(path, f"{name}_config.yaml"))
        return path

    def load(self, path: str | None = None):
        path = path or self.src_dir
        self.state_traj, self.action_traj, self.elapsed, self.pred_traj = {}, {}, {}, {}
        self.violation_traj = {}
        for name in self.entries:
            self.state_traj[name] = np.load(os.path.join(path, f"{name}_state_traj.npy"))
            self.action_traj[name] = np.load(os.path.join(path, f"{name}_action_traj.npy"))
            self.elapsed[name] = np.load(os.path.join(path, f"{name}_elapsed.npy"))
        return self

    def _global_preds(self, name):
        """Predicted trajectories in the global frame, (T, H, 3), computed
        in f64 on the host."""
        X = torch.from_numpy(self.pred_traj[name].astype(np.float64))  # (T, H, nz)
        e = self.entries[name]
        if "horizon_pm" in e.config or "horizon_kc" in e.config:
            N = int(e.config["horizon"])
            i = 1 if "horizon_pm" in e.config else 2  # the tail's s: point mass 1, kinematic 2
            s = torch.cat([X[:, :N, 4], X[:, N:, i]], dim=1)
            ey = torch.cat([X[:, :N, 5], X[:, N:, i + 1]], dim=1)
            epsi = torch.cat([X[:, :N, 6], X[:, N:, i + 2]], dim=1)
        else:  # the kinematic family
            s, ey, epsi = X[:, :, 2], X[:, :, 3], X[:, :, 4]
        x, y, psi = track_mod.rel2glob(self.track.data, s, ey, epsi)
        return torch.stack([x, y, psi], dim=-1).numpy()


class KinematicRacingSimulator(RacingSimulator):
    """Kinematic-car racing loop: the kinematic plant and its standing start
    (v = 0.1, s = 1); the controller ``kinematic`` (``KinematicMPC``'s
    problem)."""

    model = "kinematic"
    s_index = 2
    t_index = 5
    ey_index = 3
    speed_index = 0

    def _plant_transition(self):
        return kc.make_transitions(kc.KinematicCarParams.from_config(self.car_config))[0]

    def _initial_state(self):
        state = torch.zeros(1, 6, dtype=self.dtype, device=self.device)
        state[0, 0], state[0, 2] = 0.1, 1.0
        return state
