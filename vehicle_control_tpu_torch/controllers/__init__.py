from vehicle_control_tpu_torch.controllers.mpc.controllers import (
    CascadedKinematicMPC,
    CascadedMPC,
    KinematicMPC,
    SingleTrackMPC,
)

__all__ = ["CascadedKinematicMPC", "CascadedMPC", "KinematicMPC", "SingleTrackMPC"]
