"""The JAX package's obstacle lap on the CPU in float64: its violations.

Runs the JAX simulator on ``configs/simconfig.yaml`` with ``obstacles`` set
to true (cascaded, ippodromo's seven discs, its XLA solver in f64 at the
controller YAML's budget, as ``experiments/data/verify_obs_ippodromo`` was
made) and prints the lap time (the last state's t + dt, as
``chip_smoke.py`` counts it), the steps, the largest violation and its step,
the steps whose violation is above the simulator log's 1e-2, and the least
(s, ey) distance to each disc's centre: the reference beside which
``chip_smoke.py``'s obstacle lap reads the port's violations.

    JAX_PLATFORMS=cpu python tests/obstacle_lap_study.py

About 2-4 minutes on the CPU (the solver's compile included).
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


def main():
    sc = load_config(os.path.join(ROOT, "configs", "simconfig.yaml"))
    sc.update(obstacles=True, save_data=False, logging=False)
    sim = RacingSimulator(sc, load_config(os.path.join(ROOT, "configs/models/dynamic_car.yaml")),
                          load_config(os.path.join(ROOT, "configs/environment/ippodromo.yaml")))
    sim.run(max_steps=800, chunk=25)
    viol, st = sim.violation_traj["cascaded"], sim.state_traj["cascaded"]
    print(f"lap_time_s={st[-1, 7] + sim.dt:.4f} steps={len(st)} max_violation={viol.max():.6g} "
          f"at_step={int(viol.argmax())} steps_above_1e-2={int((viol > 1e-2).sum())} "
          f"top5={','.join(f'{int(i)}:{viol[i]:.4g}' for i in np.argsort(viol)[-5:][::-1])}")
    for o in sim.track.obstacles:
        d = np.sqrt((st[:, 4] - o.s) ** 2 + (st[:, 5] - o.ey) ** 2)
        print(f"disc s={o.s:g} ey={o.ey:g} r={o.radius:g}: least_dist={d.min():.4f} "
              f"ey_there={st[int(d.argmin()), 5]:.4f}")


if __name__ == "__main__":
    main()
