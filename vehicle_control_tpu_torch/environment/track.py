"""Closed-track geometry (counterpart of vehicle_control_tpu/environment/track.py).

* Host-side preprocessing (NumPy/SciPy, runs once, the same pipeline as the
  JAX package): corner list -> dense waypoints -> moving-average smoothing
  -> closure -> cubic spline over the waypoint index -> arclength -> uniform
  cubic-spline coefficient tables for k(s), x(s) and y(s).
* Device-side lookups on :class:`TrackData` tensors: ``curvature``,
  ``curvature_derivative``, ``position``, ``orientation`` and ``rel2glob``
  are a gather of one coefficient row and a Horner evaluation (of the
  spline or its derivative), with ``s mod length`` for successive laps.
* Obstacles: discs placed by (s, ey, radius) (:class:`Obstacle`), a binary
  occupancy grid over (s, ey) built on the host on its first lookup
  (``Track.occupancy_grid``), and the device lookups ``occupancy`` (bilinear
  on that grid) and ``obstacle_distances`` (the (s, ey)-plane distance to
  each disc's centre, the one the MPC barrier reads).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch
from scipy.integrate import trapezoid
from scipy.interpolate import CubicSpline, InterpolatedUnivariateSpline

from vehicle_control_tpu_torch.utils.math import wrap

CURVATURE_DS = 0.05  # curvature table sampling step


@dataclasses.dataclass(frozen=True)
class TrackData:
    """Device-resident track geometry: uniform-knot cubic spline tables.

    Coefficient tables are (n_segments, 4), ascending powers of the local
    parameter t = s - i*ds in [0, ds).
    """

    length: torch.Tensor  # scalar
    ds: torch.Tensor  # scalar knot spacing
    k_coeffs: torch.Tensor  # (n, 4) curvature spline
    x_coeffs: torch.Tensor  # (n, 4) centerline x(s)
    y_coeffs: torch.Tensor  # (n, 4) centerline y(s)
    width: torch.Tensor  # scalar track width
    obstacles: torch.Tensor  # (n_obs, 5): cx, cy, s, ey, radius

    def to(self, device=None, dtype=None) -> "TrackData":
        return TrackData(
            **{
                f.name: getattr(self, f.name).to(device=device, dtype=dtype)
                for f in dataclasses.fields(self)
            }
        )


def _horner(coeffs, idx, t):
    c = coeffs[idx]  # (..., 4): one gather per lookup
    return ((c[..., 3] * t + c[..., 2]) * t + c[..., 1]) * t + c[..., 0]


def _horner_d1(coeffs, idx, t):
    c = coeffs[idx]
    return (3.0 * c[..., 3] * t + 2.0 * c[..., 2]) * t + c[..., 1]


def _locate(track: TrackData, s):
    """Wrap s into [0, length) and find the spline segment + local offset.

    ``torch.remainder`` (not ``fmod``) matches ``jnp.mod`` for negative s.
    """
    s_mod = torch.remainder(s, track.length)
    n_seg = track.k_coeffs.shape[0]
    idx = torch.clamp(torch.floor(s_mod / track.ds).long(), 0, n_seg - 1)
    t = s_mod - idx.to(s_mod.dtype) * track.ds
    return idx, t


def curvature(track: TrackData, s):
    """k(s), the precomputed-curvature spline."""
    idx, t = _locate(track, s)
    return _horner(track.k_coeffs, idx, t)


def curvature_derivative(track: TrackData, s):
    """dk/ds."""
    idx, t = _locate(track, s)
    return _horner_d1(track.k_coeffs, idx, t)


def position(track: TrackData, s):
    """Centerline (x, y) at arclength s."""
    idx, t = _locate(track, s)
    return _horner(track.x_coeffs, idx, t), _horner(track.y_coeffs, idx, t)


def orientation(track: TrackData, s):
    """Tangent heading at arclength s."""
    idx, t = _locate(track, s)
    return torch.atan2(_horner_d1(track.y_coeffs, idx, t), _horner_d1(track.x_coeffs, idx, t))


def rel2glob(track: TrackData, s, ey, epsi):
    """Frenet (s, ey, epsi) -> global (x, y, psi)."""
    psi_c = orientation(track, s)
    x, y = position(track, s)
    return x - torch.sin(psi_c) * ey, y + torch.cos(psi_c) * ey, wrap(psi_c + epsi)


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Device-resident obstacle occupancy over (s, ey) (``Track.occupancy_grid``)."""

    length: torch.Tensor  # scalar track length
    occ_grid: torch.Tensor  # (n_s, n_ey) binary occupancy over (s, ey)
    occ_ds: torch.Tensor  # scalar s spacing of occ_grid
    occ_ey0: torch.Tensor  # scalar first ey sample
    occ_dey: torch.Tensor  # scalar ey spacing

    def to(self, device=None, dtype=None) -> "OccupancyGrid":
        return OccupancyGrid(
            **{
                f.name: getattr(self, f.name).to(device=device, dtype=dtype)
                for f in dataclasses.fields(self)
            }
        )


def occupancy(grid: OccupancyGrid, s, ey):
    """Bilinear lookup of the obstacle-occupancy grid at (s, ey), with
    ``s mod length``."""
    s = torch.remainder(torch.as_tensor(s, dtype=grid.occ_grid.dtype, device=grid.occ_grid.device),
                        grid.length)
    ey = torch.as_tensor(ey, dtype=s.dtype, device=s.device)
    n_s, n_ey = grid.occ_grid.shape
    fi = torch.clamp(s / grid.occ_ds, 0.0, n_s - 1.001)
    fj = torch.clamp((ey - grid.occ_ey0) / grid.occ_dey, 0.0, n_ey - 1.001)
    i = torch.floor(fi).long()
    j = torch.floor(fj).long()
    ti = fi - i
    tj = fj - j
    g = grid.occ_grid
    return (
        g[i, j] * (1 - ti) * (1 - tj)
        + g[i + 1, j] * ti * (1 - tj)
        + g[i, j + 1] * (1 - ti) * tj
        + g[i + 1, j + 1] * ti * tj
    )


def obstacle_distances(track: TrackData, s, ey):
    """Euclidean (s, ey)-plane distance to each obstacle's centre, the
    distance the MPC barrier reads; shape (..., n_obs)."""
    s = torch.as_tensor(s, dtype=track.obstacles.dtype, device=track.obstacles.device)[..., None]
    ey = torch.as_tensor(ey, dtype=s.dtype, device=s.device)[..., None]
    return torch.sqrt((s - track.obstacles[:, 2]) ** 2 + (ey - track.obstacles[:, 3]) ** 2)


def _wrap_np(angle):
    return np.mod(angle + np.pi, 2.0 * np.pi) - np.pi


class Waypoint:
    """(x, y, psi) with lane bounds."""

    def __init__(self, x, y, psi):
        self.x = x
        self.y = y
        self.psi = psi
        self.lb = None
        self.rb = None


class Obstacle:
    """Circular obstacle placed by (s, ey, radius), centred at (cx, cy)."""

    def __init__(self, cx, cy, s, ey, radius):
        self.cx = cx
        self.cy = cy
        self.s = s
        self.ey = ey
        self.radius = radius

    def __repr__(self) -> str:
        return f"Obstacle(cx={self.cx}, cy={self.cy}, radius={self.radius})"


class Track:
    """Host-side track: preprocessing plus a :class:`TrackData` (f64, CPU).

    Accepts the reference YAML schema: ``name``, ``corners``,
    ``obstacle_data``, ``resolution``, ``smoothing``, ``width``.  Move the
    tables with ``track.data.to(device, dtype)``.
    """

    def __init__(self, config):
        self.name = config["name"]
        self.width = float(config["width"])
        self.resolution = float(config["resolution"])
        self.smoothing = int(config["smoothing"])
        wp_x, wp_y = self._construct_path(config["corners"])
        self.waypoints: List[Waypoint] = self._construct_waypoints(wp_x, wp_y)
        self.n_waypoints = len(self.waypoints)
        self._construct_spline()
        self._precompute_curvatures()

        self.obstacles: List[Obstacle] = self._construct_obstacles(
            config.get("obstacle_data") or []
        )
        obs_arr = np.array(
            [[o.cx, o.cy, o.s, o.ey, o.radius] for o in self.obstacles], dtype=np.float64
        ).reshape(-1, 5)
        f64 = torch.float64
        self.data = TrackData(
            length=torch.tensor(self.length, dtype=f64),
            ds=torch.tensor(CURVATURE_DS, dtype=f64),
            k_coeffs=torch.from_numpy(self._k_coeffs),
            x_coeffs=torch.from_numpy(self._x_coeffs),
            y_coeffs=torch.from_numpy(self._y_coeffs),
            width=torch.tensor(self.width, dtype=f64),
            obstacles=torch.from_numpy(obs_arr),
        )

    def _construct_path(self, corners):
        wp_x, wp_y = [], []
        for i in range(len(corners) - 1):
            start, end = corners[i], corners[i + 1]
            distance = float(np.hypot(end[0] - start[0], end[1] - start[1]))
            n_wp = int(distance / self.resolution)
            wp_x.extend(np.linspace(start[0], end[0], n_wp, endpoint=False))
            wp_y.extend(np.linspace(start[1], end[1], n_wp, endpoint=False))
        wp_x = np.asarray(wp_x)
        wp_y = np.asarray(wp_y)
        # moving-average smoothing, end points untouched
        n = len(wp_x)
        sm = self.smoothing
        xs = np.array(wp_x)
        ys = np.array(wp_y)
        for i in range(n):
            if sm <= i <= n - sm - 2:
                xs[i] = np.mean(wp_x[i - sm : i + sm + 1])
                ys[i] = np.mean(wp_y[i - sm : i + sm + 1])
        # close the circuit
        return np.append(xs, xs[0]), np.append(ys, ys[0])

    def _construct_waypoints(self, wp_x, wp_y):
        # heading from the difference-ahead vector; drops the closing point
        waypoints = []
        half = self.width / 2
        for i in range(len(wp_x) - 1):
            dx = wp_x[i + 1] - wp_x[i]
            dy = wp_y[i + 1] - wp_y[i]
            wp = Waypoint(wp_x[i], wp_y[i], np.arctan2(dy, dx))
            orth = float(_wrap_np(wp.psi + np.pi / 2))
            wp.lb = np.array([wp.x - np.cos(orth) * half, wp.y - np.sin(orth) * half])
            wp.rb = np.array([wp.x + np.cos(orth) * half, wp.y + np.sin(orth) * half])
            waypoints.append(wp)
        return waypoints

    def _construct_spline(self):
        xs = np.array([wp.x for wp in self.waypoints])
        ys = np.array([wp.y for wp in self.waypoints])
        sigma = np.arange(len(xs), dtype=np.float64)
        self._x_of_sigma = InterpolatedUnivariateSpline(sigma, xs, k=3, ext=3)
        self._y_of_sigma = InterpolatedUnivariateSpline(sigma, ys, k=3, ext=3)
        speed = np.sqrt(
            self._x_of_sigma.derivative(1)(sigma) ** 2
            + self._y_of_sigma.derivative(1)(sigma) ** 2
        )
        self.length = float(trapezoid(speed, sigma))

    def _sigma(self, s):
        return (np.asarray(s) / self.length) * self.n_waypoints

    def get_curvature_host(self, s):
        """Unsigned curvature from the spline derivatives (computed in sigma;
        the formula is reparameterisation-invariant)."""
        sig = self._sigma(np.mod(s, self.length))
        dx = self._x_of_sigma.derivative(1)(sig)
        dy = self._y_of_sigma.derivative(1)(sig)
        ddx = self._x_of_sigma.derivative(2)(sig)
        ddy = self._y_of_sigma.derivative(2)(sig)
        return np.abs(dx * ddy - ddx * dy) / np.power(dx**2 + dy**2, 1.5)

    def get_orientation_host(self, s):
        sig = self._sigma(np.mod(s, self.length))
        dx = self._x_of_sigma.derivative(1)(sig)
        dy = self._y_of_sigma.derivative(1)(sig)
        return np.arctan2(dy, dx)

    def rel2glob_host(self, s, ey):
        """Frenet (s, ey) -> global (x, y) on the host."""
        psi_c = self.get_orientation_host(s)
        sig = self._sigma(np.mod(s, self.length))
        x = self._x_of_sigma(sig) - np.sin(psi_c) * ey
        y = self._y_of_sigma(sig) + np.cos(psi_c) * ey
        return x, y

    def _construct_obstacles(self, obstacle_data):
        """The discs, placed by (s, ey, radius)."""
        obstacles = []
        for s, ey, radius in obstacle_data:
            x, y = self.rel2glob_host(s, ey)
            obstacles.append(Obstacle(float(x), float(y), s, ey, radius))
        return obstacles

    @functools.cached_property
    def _occupancy_host(self):
        """(s samples, ey samples, grid): the binary occupancy grid over (s,
        ey), 0.5 m in s, 0.01 m in ey, a cell occupied within radius + 1 of
        a centre; built on the first lookup."""
        s_values = np.arange(0.0, self.length - 0.1, 0.5)
        ey_values = np.arange(0.0, self.width, 0.01) - self.width / 2
        S, EY = np.meshgrid(s_values, ey_values, indexing="ij")
        psi_c = self.get_orientation_host(S.ravel()).reshape(S.shape)
        X = self._x_of_sigma(self._sigma(S.ravel())).reshape(S.shape) - np.sin(psi_c) * EY
        Y = self._y_of_sigma(self._sigma(S.ravel())).reshape(S.shape) + np.cos(psi_c) * EY
        Z = np.zeros_like(S)
        for obs in self.obstacles:
            # the clearance is radius + 1, unsquared, against the Euclidean
            # distance (not its square, which the original code compared)
            Z += (np.sqrt((X - obs.cx) ** 2 + (Y - obs.cy) ** 2) <= obs.radius + 1).astype(float)
        return s_values, ey_values, Z

    @functools.cached_property
    def occupancy_grid(self) -> OccupancyGrid:
        """The occupancy grid for the device lookup ``occupancy`` (f64, CPU)."""
        s_values, ey_values, grid = self._occupancy_host
        f64 = torch.float64
        return OccupancyGrid(
            length=torch.tensor(self.length, dtype=f64),
            occ_grid=torch.from_numpy(grid),
            occ_ds=torch.tensor(s_values[1] - s_values[0], dtype=f64),
            occ_ey0=torch.tensor(ey_values[0], dtype=f64),
            occ_dey=torch.tensor(ey_values[1] - ey_values[0], dtype=f64),
        )

    def occupancy(self, s, ey):
        """Bilinear occupancy lookup on the host."""
        return _bilinear(*self._occupancy_host, s, ey)

    def _precompute_curvatures(self):
        # sample every 0.05 m then refit a cubic
        s_values = np.arange(0.0, self.length - 0.1, CURVATURE_DS)
        k_values = self.get_curvature_host(s_values)
        x_values = self._x_of_sigma(self._sigma(s_values))
        y_values = self._y_of_sigma(self._sigma(s_values))
        self._k_coeffs = _uniform_cubic_coeffs(s_values, k_values)
        self._x_coeffs = _uniform_cubic_coeffs(s_values, x_values)
        self._y_coeffs = _uniform_cubic_coeffs(s_values, y_values)


def _bilinear(xs, ys, grid, x, y):
    x = np.clip(x, xs[0], xs[-1])
    y = np.clip(y, ys[0], ys[-1])
    i = np.clip(np.searchsorted(xs, x) - 1, 0, len(xs) - 2)
    j = np.clip(np.searchsorted(ys, y) - 1, 0, len(ys) - 2)
    tx = (x - xs[i]) / (xs[i + 1] - xs[i])
    ty = (y - ys[j]) / (ys[j + 1] - ys[j])
    return (
        grid[i, j] * (1 - tx) * (1 - ty)
        + grid[i + 1, j] * tx * (1 - ty)
        + grid[i, j + 1] * (1 - tx) * ty
        + grid[i + 1, j + 1] * tx * ty
    )


def _uniform_cubic_coeffs(s_values: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Interpolating cubic spline on a uniform grid as (n-1, 4) ascending-power
    coefficients in the local parameter t = s - s_i."""
    c = CubicSpline(s_values, values, bc_type="not-a-knot").c
    return np.ascontiguousarray(np.stack([c[3], c[2], c[1], c[0]], axis=1))
