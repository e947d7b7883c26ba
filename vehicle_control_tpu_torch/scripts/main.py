"""Racing entry point (counterpart of vehicle_control_tpu/scripts/main.py).

Usage: python -m vehicle_control_tpu_torch.scripts.main [--track NAME]
       [--steps N] [--device cuda|cpu] [--config PATH]

Reads the simconfig (``configs/simconfig.yaml`` by default) for the
controllers and run options, races a lap on ``--device`` (the card by
default; without CUDA that raises, there is no fallback to the CPU), prints
``summarize()`` and, with ``save_data``, writes the run's artifacts.  With
``load`` it replays saved artifacts instead of racing.
"""

from __future__ import annotations

import argparse
import os

from vehicle_control_tpu_torch.simulation import RacingSimulator
from vehicle_control_tpu_torch.utils.config import load_config, project_root
from vehicle_control_tpu_torch.utils.device import DEFAULT_DEVICE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", default=None, help="override simconfig track_name")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    ap.add_argument("--config", default=None, help="simconfig path "
                    "(default configs/simconfig.yaml)")
    args = ap.parse_args(argv)

    root = project_root()
    simconfig = load_config(args.config or os.path.join(root, "configs/simconfig.yaml"))
    if args.track:
        simconfig["track_name"] = args.track
    if simconfig.get("save_gif", False):
        raise NotImplementedError("save_gif: the render adapters are not ported "
                                  "(ROADMAP item 'The render adapters')")
    trackconfig = load_config(
        os.path.join(root, f"configs/environment/{simconfig['track_name']}.yaml")
    )
    carconfig = load_config(os.path.join(root, "configs/models/dynamic_car.yaml"))
    sim = RacingSimulator(simconfig, carconfig, trackconfig, device=args.device)
    if simconfig.get("load", False):
        # replay a saved run instead of racing
        sim.load()
    else:
        sim.run(max_steps=args.steps)
    sim.summarize()
    return sim


if __name__ == "__main__":
    main()
