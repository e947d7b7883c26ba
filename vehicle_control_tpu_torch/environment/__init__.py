from vehicle_control_tpu_torch.environment.track import (
    Obstacle,
    OccupancyGrid,
    Track,
    TrackData,
    Waypoint,
    curvature,
    curvature_derivative,
    obstacle_distances,
    occupancy,
    orientation,
    position,
    rel2glob,
)

__all__ = [
    "Obstacle",
    "OccupancyGrid",
    "Track",
    "TrackData",
    "Waypoint",
    "curvature",
    "curvature_derivative",
    "obstacle_distances",
    "occupancy",
    "orientation",
    "position",
    "rel2glob",
]
