from vehicle_control_tpu_torch.controllers.mpc.controllers import (
    CascadedMPC,
    KinematicMPC,
    SingleTrackMPC,
)

__all__ = ["CascadedMPC", "KinematicMPC", "SingleTrackMPC"]
