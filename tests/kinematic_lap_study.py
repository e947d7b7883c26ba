"""The JAX package's kinematic lap on the CPU in float64: the reference lap.

Runs the JAX ``KinematicRacingSimulator`` on ``configs/simconfig.yaml``
with ``controller_names: [kinematic]`` (as ``vehicle_control_tpu/scripts/
kinmain.py`` does: the kinematic car of ``configs/models/kinematic_car.yaml``,
ippodromo, obstacles off, its XLA solver in f64 at the controller YAML's
budget) and prints the lap time (the last state's t + dt, as
``chip_smoke.py`` counts it), the steps, the largest violation and its step,
and the steps whose violation is above the simulator log's 1e-2: the
reference beside which ``chip_smoke.py``'s kinematic lap reads the port's.
Beside it, the lap of each shipped JAX run of this controller
(``experiments/data/verify_kin_ippodromo`` and ``verify_kin2_ippodromo``).
It writes nothing.

    JAX_PLATFORMS=cpu python tests/kinematic_lap_study.py

About 1-2 minutes on the CPU (the solver's compile included).
"""

import os
import sys

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vehicle_control_tpu.simulation import KinematicRacingSimulator  # noqa: E402
from vehicle_control_tpu.utils.config import load_config  # noqa: E402

SHIPPED = ("verify_kin_ippodromo", "verify_kin2_ippodromo")


def main():
    sc = load_config(os.path.join(ROOT, "configs", "simconfig.yaml"))
    sc.update(controller_names=["kinematic"], save_data=False, logging=False,
              save_images=False)
    car = load_config(os.path.join(ROOT, "configs/models/kinematic_car.yaml"))
    sim = KinematicRacingSimulator(
        sc, car, load_config(os.path.join(ROOT, "configs/environment/ippodromo.yaml")))
    sim.run(max_steps=800, chunk=25)
    viol, st = sim.violation_traj["kinematic"], sim.state_traj["kinematic"]
    print(f"lap_time_s={st[-1, 5] + sim.dt:.4f} steps={len(st)} max_violation={viol.max():.6g} "
          f"at_step={int(viol.argmax())} steps_above_1e-2={int((viol > 1e-2).sum())} "
          f"top5={','.join(f'{int(i)}:{viol[i]:.4g}' for i in np.argsort(viol)[-5:][::-1])}")
    for run in SHIPPED:
        ref = np.load(os.path.join(ROOT, "experiments", "data", run, "kinematic_state_traj.npy"))
        print(f"{run}: lap_time_s={ref[-1, 5] + sim.dt:.4f} steps={len(ref)}")


if __name__ == "__main__":
    main()
