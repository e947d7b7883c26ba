"""The JAX package's cascaded kinematic lap on the CPU in float64: the reference lap.

Runs the JAX ``RacingSimulator`` on ``configs/simconfig.yaml`` with
``controller_names: [cascaded_kinematic]`` (``CascadedKinematicMPC``: N=20
single-track stages and a kinematic-bicycle tail of 20 stages, the dynamic
car of ``configs/models/dynamic_car.yaml``, ippodromo, obstacles off, its
XLA solver in f64 at the controller YAML's active ``solver:`` block, 4 x 12)
and prints the lap time (the last state's t + dt, as ``chip_smoke.py``
counts it; with the lap not completed, the time the run stopped at), the
steps, whether the lap completed, the split time at s = 200 m (the first
state past it: its t), the first step where the car runs wide (|ey|
beyond the dynamics' 8 m clamp) and its s, the largest |ey| up to the
split, the largest violation and its step,
and the steps whose violation is above the simulator log's 1e-2 (also
those before the split): the reference beside which ``chip_smoke.py``'s
cascaded kinematic lap reads the port's.  The repo ships no JAX run of
this controller under ``experiments/data/``.  It writes nothing.

    JAX_PLATFORMS=cpu python tests/cascaded_kinematic_lap_study.py

A few minutes on the CPU (the solver's compile included).
"""

import os
import sys

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vehicle_control_tpu.simulation import RacingSimulator  # noqa: E402
from vehicle_control_tpu.utils.config import load_config  # noqa: E402

NAME = "cascaded_kinematic"
SPLIT_M, EY_WIDE = 200.0, 8.0


def main():
    sc = load_config(os.path.join(ROOT, "configs", "simconfig.yaml"))
    sc.update(controller_names=[NAME], save_data=False, logging=False, save_images=False)
    car = load_config(os.path.join(ROOT, "configs/models/dynamic_car.yaml"))
    sim = RacingSimulator(
        sc, car, load_config(os.path.join(ROOT, "configs/environment/ippodromo.yaml")))
    sim.run(max_steps=800, chunk=25)
    viol, st = sim.violation_traj[NAME], sim.state_traj[NAME]
    split = int(np.argmax(st[:, 4] >= SPLIT_M))
    wide = np.abs(st[:, 5]) > EY_WIDE
    first_wide = int(np.argmax(wide)) if wide.any() else -1
    print(f"lap_time_s={st[-1, 7] + sim.dt:.4f} steps={len(st)} "
          f"lap_completed={bool(st[-1, 4] > sim.track.length - 0.1)} "
          f"split_{SPLIT_M:g}m_t={st[split, 7]:.4f} split_step={split} "
          f"first_wide_step={first_wide} s_there={st[first_wide, 4]:.3f} "
          f"max_abs_ey_to_split={np.abs(st[:split + 1, 5]).max():.3f} "
          f"max_violation={viol.max():.6g} at_step={int(viol.argmax())} "
          f"steps_above_1e-2={int((viol > 1e-2).sum())} "
          f"before_split={int((viol[:split + 1] > 1e-2).sum())} "
          f"max_violation_before_split={viol[:split + 1].max():.6g} "
          f"top5={','.join(f'{int(i)}:{viol[i]:.4g}' for i in np.argsort(viol)[-5:][::-1])}")


if __name__ == "__main__":
    main()
