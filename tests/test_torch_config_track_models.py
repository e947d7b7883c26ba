"""The port's config loader, track geometry and car model against the JAX
package's, on the same float64 inputs.

The host-side track pipeline is the same NumPy/SciPy code on both sides, so
its tables agree exactly; the device lookups and the car model agree to
float64 rounding (rtol 1e-12).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import config_path, t, tracks
from vehicle_control_tpu.environment import track as jtrack
from vehicle_control_tpu.models import dynamic_car as jdc
from vehicle_control_tpu.utils.config import load_config as j_load_config
from vehicle_control_tpu_torch.environment import track as ttrack
from vehicle_control_tpu_torch.models import dynamic_car as tdc
from vehicle_control_tpu_torch.utils import convert
from vehicle_control_tpu_torch.utils.config import load_config, parse_yaml, project_root
from vehicle_control_tpu_torch.utils.math import arctan, wrap

CONFIGS = sorted(glob.glob(os.path.join(project_root(), "configs", "**", "*.yaml"), recursive=True))
TRACKS = ("ippodromo", "shoe", "bean", "gokart")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, project_root()))
def test_yaml_loader_matches_safe_load(path):
    with open(path) as fh:
        text = fh.read()
    assert parse_yaml(text) == yaml.safe_load(text)
    assert load_config(path).to_dict() == yaml.safe_load(text)


def test_yaml_loader_subset():
    text = "a: {f: 1, r: [0, 2.5]}  # c\nb:\n- 'x # y'\n- [1e-3, 1.0e-3, -.5, ~]\nc: off\n"
    assert parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        parse_yaml("a: &anchor 1\n")


@pytest.mark.parametrize("name", TRACKS)
def test_track_tables_and_curvature(name):
    jt, tt = tracks(name)
    assert tt.length == jt.length
    for f in ("k_coeffs", "x_coeffs", "y_coeffs", "obstacles"):
        np.testing.assert_array_equal(getattr(tt.data, f).numpy(), np.asarray(getattr(jt.data, f)))
    # the converter carries JAX's tables across unchanged
    moved = convert.track_data({f: np.asarray(v) for f, v in vars(jt.data).items()}, "cpu")
    np.testing.assert_array_equal(moved.k_coeffs.numpy(), tt.data.k_coeffs.numpy())
    # negative s and successive laps exercise the modulo sign in _locate
    s = np.linspace(-1.5 * jt.length, 2.5 * jt.length, 4001)
    np.testing.assert_allclose(
        ttrack.curvature(tt.data, t(s)).numpy(),
        np.asarray(jtrack.curvature(jt.data, jnp.asarray(s))),
        rtol=1e-12, atol=1e-14,
    )


def test_math_helpers():
    x = np.linspace(-20, 20, 2001)
    np.testing.assert_allclose(wrap(t(x)).numpy(), np.mod(x + np.pi, 2 * np.pi) - np.pi, atol=1e-12)
    np.testing.assert_allclose(arctan(t(x)).numpy(), np.arctan(x), atol=4e-11)


def _car():
    cfg = config_path("models/dynamic_car.yaml")
    jp = jdc.DynamicCarParams.from_config(j_load_config(cfg))
    tp = tdc.DynamicCarParams.from_config(load_config(cfg))
    assert convert.car_params({k: np.asarray(v) for k, v in vars(jp).items()}) == tp
    return jp, tp


def _states(B=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 8)) * [3.0, 0.8, 0.4, 0.2, 50, 1.5, 0.2, 5]
    x[:, 0] += 10.0
    u = rng.normal(size=(B, 2)) * [3000.0, 0.3]
    k = rng.normal(size=B) * 0.05
    return x, u, k


def test_temporal_ode_matches_jax():
    jp, tp = _car()
    x, u, k = _states()
    np.testing.assert_allclose(
        tdc.temporal_ode(t(x), t(u), t(k), tp).numpy(),
        np.asarray(jdc.temporal_ode(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), jp)),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("which", ["temporal", "spatial"])
def test_transitions_match_jax(which):
    jp, tp = _car()
    x, u, k = _states(seed=1)
    i = 0 if which == "temporal" else 1
    jstep, tstep = jdc.make_transitions(jp)[i], tdc.make_transitions(tp)[i]
    h = 0.05 if which == "temporal" else 0.5
    np.testing.assert_allclose(
        tstep(t(x), t(u), t(k), h).numpy(),
        np.asarray(jstep(jnp.asarray(x), jnp.asarray(u), jnp.asarray(k), h)),
        rtol=1e-12, atol=1e-12,
    )
    assert torch.isfinite(tstep(t(x), t(u), t(k), h)).all()
