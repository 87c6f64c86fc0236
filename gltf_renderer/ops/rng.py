"""Counter-based RNG + low-discrepancy sequences.

Bit-exact ports of Source/Shaders/Random.hlsli so accumulation matches the
reference renderer sample-for-sample: pcg3d/pcg4d (jcgt 9(3):2), R1/R2
quasirandom sequences, radical inverse / Hammersley.

All functions are stateless and vectorized: inputs are uint32 arrays of shape
(..., 3) / (..., 4) and outputs match. Counter-based streams make the wavefront
bounce loop reproducible regardless of scheduling — the replacement for the
reference's per-ray `random_count` threading (PathTracer.lib.hlsl:144-148).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32_MAX_F = 4294967295.0


def pcg3d(v):
    """uint3 hash. Random.hlsli:4-15."""
    v = v.astype(jnp.uint32) * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return jnp.stack([x, y, z], axis=-1)


def pcg4d(v):
    """uint4 hash. Random.hlsli:17-30."""
    v = v.astype(jnp.uint32) * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def random_float3(v):
    """3 floats in [0,1] from a uint3 seed. Random.hlsli:32-37."""
    return pcg3d(v).astype(jnp.float32) / _U32_MAX_F


def random_float4(v):
    """4 floats in [0,1] from a uint4 seed (pcg4d / 0xffffffff).

    Matches GenerateNextRandom (PathTracer.lib.hlsl:144-148) given
    v = (pixel.x, pixel.y, seed, counter).
    """
    return pcg4d(v).astype(jnp.float32) / _U32_MAX_F


def pt_random(pixel_x, pixel_y, seed, counter):
    """The path tracer's per-ray random stream, keyed exactly like the
    reference: pcg4d(uint4(pixel.xy, frame_seed, counter)).
    """
    v = jnp.stack(
        [
            pixel_x.astype(jnp.uint32),
            pixel_y.astype(jnp.uint32),
            jnp.broadcast_to(jnp.asarray(seed, jnp.uint32), pixel_x.shape),
            jnp.broadcast_to(jnp.asarray(counter, jnp.uint32), pixel_x.shape),
        ],
        axis=-1,
    )
    return random_float4(v)


def r1(start, n):
    """Golden-ratio 1D sequence. Random.hlsli:73-77."""
    g = 0.618033988749894
    x = start + jnp.asarray(n, jnp.float32) * g
    return x - jnp.floor(x)


def r2(start, n):
    """Plastic-constant 2D sequence. Random.hlsli:80-85."""
    g = 1.324717957244746
    a = jnp.array([1.0 / g, 1.0 / (g * g)], jnp.float32)
    x = jnp.asarray(start, jnp.float32) + jnp.asarray(n, jnp.float32)[..., None] * a
    return x - jnp.floor(x)


def radical_inverse(n):
    """Van der Corput base-2 via bit reversal. Random.hlsli:87-98."""
    n = n.astype(jnp.uint32)
    n = (n << 16) | (n >> 16)
    n = ((n & jnp.uint32(0x00FF00FF)) << 8) | ((n & jnp.uint32(0xFF00FF00)) >> 8)
    n = ((n & jnp.uint32(0x0F0F0F0F)) << 4) | ((n & jnp.uint32(0xF0F0F0F0)) >> 4)
    n = ((n & jnp.uint32(0x33333333)) << 2) | ((n & jnp.uint32(0xCCCCCCCC)) >> 2)
    n = ((n & jnp.uint32(0x55555555)) << 1) | ((n & jnp.uint32(0xAAAAAAAA)) >> 1)
    return n.astype(jnp.float32) * 2.3283064365386963e-10


def hammersley_2d(i, n):
    """Hammersley point set. Random.hlsli:100-103."""
    return jnp.stack(
        [i.astype(jnp.float32) / jnp.asarray(n, jnp.float32), radical_inverse(i)], axis=-1
    )
