"""Punctual light sampling (port of Lights.hlsli + SamplePointLight).

Vectorized GetLightRay (Lights.hlsli:26-61): point/spot/directional, smooth
distance-cutoff falloff, spot angular attenuation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from gltf_renderer.scene.types import GpuLights, LIGHT_TYPE_DIRECTIONAL, LIGHT_TYPE_SPOT
from gltf_renderer.utils.math import normalize, saturate


class LightRay(NamedTuple):
    direction: jnp.ndarray  # (R, 3) unit, surface -> light
    color: jnp.ndarray      # (R, 3) incident radiance (after falloff)


def get_light_ray(lights: GpuLights, light_index, surface_pos) -> LightRay:
    """lights gathered table; light_index (R,) int32; surface_pos (R, 3)."""
    lt = lights.type[light_index]
    pos = lights.position[light_index]
    ldir = lights.direction[light_index]
    color = lights.color[light_index] * lights.intensity[light_index][..., None]
    cutoff = lights.cutoff[light_index]

    is_positional = lt != LIGHT_TYPE_DIRECTIONAL
    to_light = jnp.where(is_positional[..., None], pos - surface_pos, -ldir)

    dist = jnp.sqrt(jnp.maximum(jnp.sum(to_light * to_light, -1), 1e-20))
    falloff = jnp.where(
        cutoff > 0.0,
        jnp.clip(1.0 - (dist / jnp.maximum(cutoff, 1e-20)) ** 4, 0.0, 1.0),
        1.0,
    )
    falloff = falloff / (dist * dist)
    color = jnp.where(is_positional[..., None], color * falloff[..., None], color)

    direction = normalize(to_light)

    # Spot angular attenuation (Lights.hlsli:48-58).
    scale = 1.0 / jnp.maximum(
        1e-3, jnp.cos(lights.inner_angle[light_index]) - jnp.cos(lights.outer_angle[light_index])
    )
    offset = -jnp.cos(lights.outer_angle[light_index]) * scale
    cd = -jnp.sum(normalize(ldir) * direction, -1)
    ang = saturate(cd * scale + offset)
    ang = ang * ang
    color = jnp.where((lt == LIGHT_TYPE_SPOT)[..., None], color * ang[..., None], color)
    return LightRay(direction=direction, color=color)


def sample_point_light(lights: GpuLights, num_lights: int, surface_pos, u):
    """Uniform light pick (PathTracer.lib.hlsl:680-686). Returns (ray, pdf)."""
    idx = jnp.clip((u * float(num_lights)).astype(jnp.int32), 0, num_lights - 1)
    pdf = 1.0 / float(num_lights)
    return get_light_ray(lights, idx, surface_pos), pdf
