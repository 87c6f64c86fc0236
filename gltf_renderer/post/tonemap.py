"""Tone mapping: exposure + AgX (+ none) + sRGB encode + triangle-noise dither.

Port of ToneMapper.ps.hlsl (AgX constants from Benjamin Wrensch's minimal AgX,
based on Troy Sobotka's original — ToneMapper.ps.hlsl:28-75) and ToneMapper
host config (ToneMapper.h/.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gltf_renderer.ops.rng import random_float3
from gltf_renderer.render.settings import TONEMAPPER_AGX, TONEMAPPER_NONE
from gltf_renderer.utils.math import encode_srgb, saturate

_AGX_INSET = jnp.asarray(
    [
        [0.856627153315983, 0.137318972929847, 0.11189821299995],
        [0.0951212405381588, 0.761241990602591, 0.0767994186031903],
        [0.0482516061458583, 0.101439036467562, 0.811302368396859],
    ],
    jnp.float32,
).T  # HLSL constructor rows are transposed (ToneMapper.ps.hlsl:50-55)

_AGX_OUTSET = jnp.asarray(
    [
        [1.12710058, -0.14132976, -0.14132976],
        [-0.11060664, 1.1578237, -0.11060664],
        [-0.01649394, -0.01649394, 1.25193641],
    ],
    jnp.float32,
).T

_LOG_MIN = -12.47393
_LOG_MAX = 4.026069


def agx_curve(x):
    """6th-order polynomial fit (ToneMapper.ps.hlsl:30-44)."""
    x2 = x * x
    x4 = x2 * x2
    return (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )


def agx_tonemap(color):
    """ToneMapper.ps.hlsl AgxTonemap:47-75. color (..., 3) linear -> display."""
    # Full f32 for the 3x3 color transforms: TF32 (~1e-3 relative) would
    # move display values by up to ~1/4 of an 8-bit step. These products are
    # bandwidth-bound, so the extra passes should cost little (not measured).
    hi = jax.lax.Precision.HIGHEST
    c = jnp.matmul(color, _AGX_INSET.T, precision=hi)
    c = jnp.clip(jnp.log2(jnp.maximum(c, 1e-10)), _LOG_MIN, _LOG_MAX)
    c = (c - _LOG_MIN) / (_LOG_MAX - _LOG_MIN)
    c = agx_curve(c)
    c = jnp.matmul(c, _AGX_OUTSET.T, precision=hi)
    return jnp.power(jnp.maximum(c, 0.0), 2.2)


def dither(color, px, py, frame):
    """Triangle-noise dither (ToneMapper.ps.hlsl:77-81)."""
    seed = jnp.stack(
        [
            px.astype(jnp.uint32),
            py.astype(jnp.uint32),
            jnp.broadcast_to(jnp.asarray(frame, jnp.uint32), px.shape),
        ],
        -1,
    )
    tri = random_float3(seed * jnp.uint32(2)) + random_float3(seed * jnp.uint32(2) + jnp.uint32(1)) - 1.0
    return color + tri / 255.0


def tonemap(hdr, tonemapper: int, exposure, frame=0, apply_dither: bool = True):
    """(H, W, 3) linear HDR -> (H, W, 3) float display-encoded [0,1].

    Mirrors ToneMapper.ps.hlsl main:84-102.
    """
    color = exposure * hdr
    if tonemapper == TONEMAPPER_NONE:
        color = saturate(color)
    elif tonemapper == TONEMAPPER_AGX:
        color = agx_tonemap(color)
    color = encode_srgb(color)
    if apply_dither:
        h, w = hdr.shape[0], hdr.shape[1]
        py, px = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        color = dither(color, px, py, frame)
    return jnp.clip(color, 0.0, 1.0)


def to_u8(display):
    return jnp.round(display * 255.0).astype(jnp.uint8)
