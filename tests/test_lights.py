"""Punctual light model tests (Lights.hlsli:26-61 parity)."""

import numpy as np
import jax.numpy as jnp

from gltf_renderer.ops.lights import get_light_ray, sample_point_light
from gltf_renderer.scene.types import (
    GpuLights,
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_SPOT,
)


def _lights(**kw):
    d = dict(
        type=np.asarray([LIGHT_TYPE_POINT], np.int32),
        position=np.asarray([[0.0, 0.0, 2.0]], np.float32),
        direction=np.asarray([[0.0, 0.0, -1.0]], np.float32),
        color=np.asarray([[1.0, 1.0, 1.0]], np.float32),
        intensity=np.asarray([4.0], np.float32),
        cutoff=np.asarray([0.0], np.float32),
        inner_angle=np.asarray([0.2], np.float32),
        outer_angle=np.asarray([0.6], np.float32),
    )
    d.update({k: np.asarray(v) for k, v in kw.items()})
    return GpuLights(**{k: jnp.asarray(v) for k, v in d.items()})


def test_point_light_inverse_square():
    lights = _lights()
    idx = jnp.zeros(2, jnp.int32)
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]], jnp.float32)
    ray = get_light_ray(lights, idx, pos)
    # distance 2 -> 4/4 = 1; distance 1 -> 4/1 = 4.
    np.testing.assert_allclose(ray.color[0], [1.0, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(ray.color[1], [4.0, 4.0, 4.0], atol=1e-6)
    np.testing.assert_allclose(ray.direction[0], [0, 0, 1], atol=1e-6)


def test_point_light_range_cutoff():
    """Smooth distance cutoff: falloff = saturate(1-(d/range)^4)/d^2
    (Lights.hlsli:38-44)."""
    lights = _lights(cutoff=[2.0])
    idx = jnp.zeros(2, jnp.int32)
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 1.9]], jnp.float32)
    ray = get_light_ray(lights, idx, pos)
    # At d = 2.0 (== range): zero.
    np.testing.assert_allclose(ray.color[0], [0, 0, 0], atol=1e-6)
    # Inside range: positive, matches formula at d=0.1.
    d = 0.1
    expect = 4.0 * max(0.0, 1 - (d / 2.0) ** 4) / d**2
    np.testing.assert_allclose(ray.color[1][0], expect, rtol=1e-4)


def test_spot_cone_attenuation():
    lights = _lights(type=[LIGHT_TYPE_SPOT])
    idx = jnp.zeros(3, jnp.int32)
    # Directly below (on axis), at ~0.4 rad off axis (between cones), far off.
    pos = jnp.asarray(
        [[0.0, 0.0, 0.0], [2.0 * np.tan(0.4), 0.0, 0.0], [5.0, 0.0, 1.99]],
        jnp.float32,
    )
    ray = np.asarray(get_light_ray(lights, idx, pos).color)
    on_axis = ray[0][0]
    between = ray[1][0]
    outside = ray[2][0]
    assert on_axis > 0
    assert 0 < between  # partially attenuated
    # Angular attenuation must reduce relative to pure inverse-square.
    d1 = np.linalg.norm([2.0 * np.tan(0.4), 0.0, -2.0])
    assert between < 4.0 / d1**2
    assert outside < 1e-6  # beyond the outer cone


def test_directional_light():
    lights = _lights(type=[LIGHT_TYPE_DIRECTIONAL], direction=[[0.0, 0.0, -1.0]])
    idx = jnp.zeros(2, jnp.int32)
    pos = jnp.asarray([[0.0, 0.0, 0.0], [100.0, 50.0, -20.0]], jnp.float32)
    ray = get_light_ray(lights, idx, pos)
    # No falloff; direction constant (toward the light).
    np.testing.assert_allclose(ray.color[0], ray.color[1], atol=1e-6)
    np.testing.assert_allclose(ray.color[0], [4.0, 4.0, 4.0], atol=1e-6)
    np.testing.assert_allclose(ray.direction[0], [0, 0, 1], atol=1e-6)


def test_uniform_light_pick():
    lights = GpuLights(
        type=jnp.asarray([0, 0, 0], jnp.int32),
        position=jnp.asarray([[0, 0, 1], [0, 0, 2], [0, 0, 3]], jnp.float32),
        direction=jnp.zeros((3, 3), jnp.float32),
        color=jnp.ones((3, 3), jnp.float32),
        intensity=jnp.ones(3, jnp.float32),
        cutoff=jnp.zeros(3, jnp.float32),
        inner_angle=jnp.zeros(3, jnp.float32),
        outer_angle=jnp.ones(3, jnp.float32),
    )
    u = jnp.asarray([0.0, 0.4, 0.99], jnp.float32)
    surface = jnp.zeros((3, 3), jnp.float32)
    ray, pdf = sample_point_light(lights, 3, surface, u)
    assert pdf == 1.0 / 3.0
    # u=0 -> light 0 (z=1); u=0.99 -> light 2 (z=3).
    d = np.asarray(ray.direction)
    np.testing.assert_allclose(d[0], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(d[2], [0, 0, 1], atol=1e-6)
