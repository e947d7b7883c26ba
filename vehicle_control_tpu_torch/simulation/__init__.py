from vehicle_control_tpu_torch.simulation.closed_loop import StepRecord, make_racing_loop
from vehicle_control_tpu_torch.simulation.racing import KinematicRacingSimulator, RacingSimulator

__all__ = ["KinematicRacingSimulator", "RacingSimulator", "StepRecord", "make_racing_loop"]
