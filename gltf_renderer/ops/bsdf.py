"""Layered glTF BSDF library (port of Source/Shaders/Bsdf.hlsli).

GGX D/G/V (isotropic + anisotropic), Schlick/conductor Fresnel, FresnelMix
dielectric layering, Charlie sheen with a *computed* directional-albedo LUT
(the reference loads Resources/Sheen_E.exr; we rebuild the same table by
Monte-Carlo integration at import time — GpuResources.cpp:72-132), clearcoat,
IOR-modulated thin transmission, Beer's-law volume attenuation, and the full
`gltf_bsdf` layering used by both eval paths (Bsdf.hlsli:241-325).

Everything is vectorized jnp over leading dims. `SurfaceProperties` is a
NamedTuple-of-arrays pytree mirroring Bsdf.hlsli:4-24.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from gltf_renderer.utils.math import (
    PI,
    dot,
    max_value,
    normalize,
    saturate,
    to_local,
)

MINIMUM_ROUGHNESS = 0.001


class SurfaceProperties(NamedTuple):
    """Bsdf.hlsli:4-24. All fields are arrays with a shared batch shape."""

    albedo: jnp.ndarray              # (..., 3)
    alpha: jnp.ndarray               # (..., 1)
    metalness: jnp.ndarray           # (..., 1)
    roughness_squared: jnp.ndarray   # (..., 2)  (tangent, bitangent)
    shading_normal: jnp.ndarray      # (..., 3)
    anisotropy_tangent: jnp.ndarray  # (..., 3)
    anisotropy_bitangent: jnp.ndarray  # (..., 3)
    ior: jnp.ndarray                 # (..., 1)
    specular_color: jnp.ndarray      # (..., 3)
    specular_factor: jnp.ndarray     # (..., 1)
    clearcoat: jnp.ndarray           # (..., 1)
    clearcoat_roughness: jnp.ndarray  # (..., 1)
    clearcoat_normal: jnp.ndarray    # (..., 3)
    sheen_color: jnp.ndarray         # (..., 3)
    sheen_roughness_squared: jnp.ndarray  # (..., 1)
    transmissive: jnp.ndarray        # (..., 1)
    thickness: jnp.ndarray           # (..., 1)
    attenuation_distance: jnp.ndarray  # (..., 1)
    attenuation_color: jnp.ndarray   # (..., 3)


def heavyside(a):
    """Bsdf.hlsli:29-32."""
    return jnp.where(a > 0.0, 1.0, 0.0)


def schlick_fresnel(f0, n_dot_v):
    """Bsdf.hlsli:39-47 (uses |n_dot_v|)."""
    return f0 + (1.0 - f0) * jnp.power(1.0 - jnp.abs(n_dot_v), 5.0)


# ---------------------------------------------------------------------------
# Isotropic GGX (Bsdf.hlsli:50-89)
# ---------------------------------------------------------------------------

def ggx_d(a, n_dot_h):
    a2 = a * a
    num = a2 * heavyside(n_dot_h)
    den = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    den = PI * den * den
    return num / jnp.maximum(den, 1e-20)


def ggx_smith_g1(a, n_dot_l, h_dot_l):
    a2 = a * a
    num = 2.0 * n_dot_l * heavyside(h_dot_l)
    den = n_dot_l + jnp.sqrt(jnp.maximum(a2 + (1.0 - a2) * n_dot_l * n_dot_l, 0.0))
    return num / jnp.maximum(den, 1e-20)


def ggx_correlated_v(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v):
    a2 = a * a
    num = 0.5 * heavyside(h_dot_l) * heavyside(h_dot_v)
    den = jnp.abs(n_dot_v) * jnp.sqrt(jnp.maximum(a2 + (1.0 - a2) * n_dot_l * n_dot_l, 0.0))
    den = den + jnp.abs(n_dot_l) * jnp.sqrt(
        jnp.maximum(a2 + (1.0 - a2) * n_dot_v * n_dot_v, 0.0)
    )
    return num / jnp.maximum(den, 1e-20)


def specular_brdf(a, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v):
    """Bsdf.hlsli:86-89."""
    return ggx_correlated_v(a, n_dot_l, n_dot_v, h_dot_l, h_dot_v) * ggx_d(a, n_dot_h)


# ---------------------------------------------------------------------------
# Anisotropic GGX (Bsdf.hlsli:92-129) — local-frame vectors (t, b, n)
# ---------------------------------------------------------------------------

def ggx_anisotropic_d(a, h_local):
    """a: (..., 2)."""
    a2 = a[..., 0] * a[..., 1]
    f = jnp.stack(
        [a[..., 1] * h_local[..., 0], a[..., 0] * h_local[..., 1], a2 * h_local[..., 2]],
        axis=-1,
    )
    w2 = a2 / jnp.maximum(jnp.sum(f * f, axis=-1), 1e-20)
    return heavyside(h_local[..., 2]) * a2 * w2 * w2 / PI


def ggx_anisotropic_smith_g1(a, l_local, l_dot_h):
    num = 2.0 * l_local[..., 2] * heavyside(l_dot_h)
    v = jnp.stack(
        [a[..., 0] * l_local[..., 0], a[..., 1] * l_local[..., 1], l_local[..., 2]],
        axis=-1,
    )
    den = l_local[..., 2] + jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 0.0))
    return num / jnp.maximum(den, 1e-20)


def _aniso_len(a, w_local):
    v = jnp.stack(
        [a[..., 0] * w_local[..., 0], a[..., 1] * w_local[..., 1], w_local[..., 2]],
        axis=-1,
    )
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 0.0))


def ggx_anisotropic_correlated_v(a, v_local, l_local, h_dot_v, h_dot_l):
    num = 0.5 * heavyside(h_dot_v) * heavyside(h_dot_l)
    tv = jnp.abs(l_local[..., 2]) * _aniso_len(a, v_local)
    tl = jnp.abs(v_local[..., 2]) * _aniso_len(a, l_local)
    return num / jnp.maximum(tv + tl, 1e-20)


def anisotropic_specular_brdf(a, v_local, h_local, l_local):
    """Bsdf.hlsli:124-129."""
    h_dot_v = jnp.sum(h_local * v_local, axis=-1)
    h_dot_l = jnp.sum(h_local * l_local, axis=-1)
    return ggx_anisotropic_correlated_v(a, v_local, l_local, h_dot_v, h_dot_l) * (
        ggx_anisotropic_d(a, h_local)
    )


# ---------------------------------------------------------------------------
# Fresnel layering (Bsdf.hlsli:131-162)
# ---------------------------------------------------------------------------

def lambert_diffuse(color):
    return color / PI


def fresnel_mix(f0_color, ior, weight, base, layer, h_dot_v):
    """Dielectric specular-over-diffuse. Bsdf.hlsli:136-143."""
    f0 = (1.0 - ior) / (1.0 + ior)
    f0 = f0 * f0 * f0_color
    f0 = jnp.minimum(f0, 1.0)
    fr = schlick_fresnel(f0, h_dot_v)
    return (1.0 - weight * max_value(fr)) * base + weight * fr * layer


def conductor_fresnel(specular, f0, h_dot_v):
    """Bsdf.hlsli:145-148."""
    return specular * schlick_fresnel(f0, h_dot_v)


def clearcoat_brdf(roughness_squared, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v):
    """Bsdf.hlsli:151-154."""
    return specular_brdf(roughness_squared, n_dot_l, n_dot_v, n_dot_h, h_dot_l, h_dot_v)


def fresnel_coat(ior, weight, base, layer, n_dot_v):
    """Bsdf.hlsli:156-162."""
    f0 = (1.0 - ior) / (1.0 + ior)
    f0 = f0 * f0
    fr = schlick_fresnel(f0, n_dot_v)
    w = weight * fr
    return base + (layer - base) * w


# ---------------------------------------------------------------------------
# Charlie sheen (Bsdf.hlsli:165-214)
# ---------------------------------------------------------------------------

def sheen_normal_distribution(alpha, n_dot_h):
    inv_r = 1.0 / alpha
    cos2 = n_dot_h * n_dot_h
    sin2 = jnp.maximum(1.0 - cos2, 0.0)
    return (2.0 + inv_r) * jnp.power(sin2, inv_r * 0.5) / (2.0 * PI)


def _sheen_l(alpha, x):
    t = (1.0 - alpha) * (1.0 - alpha)
    a = 21.5473 + (25.3245 - 21.5473) * t
    b = 3.82987 + (3.32435 - 3.82987) * t
    c = 0.19823 + (0.16801 - 0.19823) * t
    d = -1.97760 + (-1.27393 + 1.97760) * t
    e = -4.32054 + (-4.85967 + 4.32054) * t
    return a / (1.0 + b * jnp.power(jnp.maximum(x, 1e-20), c)) + d * x + e


def _sheen_shadowing(alpha, cos_theta):
    lo = jnp.exp(_sheen_l(alpha, cos_theta))
    hi = jnp.exp(2.0 * _sheen_l(alpha, jnp.full_like(cos_theta, 0.5)) - _sheen_l(alpha, 1.0 - cos_theta))
    return jnp.where(cos_theta < 0.5, lo, hi)


def sheen_visibility(alpha, n_dot_l, n_dot_v):
    den = (1.0 + _sheen_shadowing(alpha, n_dot_l) + _sheen_shadowing(alpha, n_dot_v)) * (
        4.0 * n_dot_l * n_dot_v
    )
    return jnp.clip(1.0 / jnp.maximum(den, 1e-20), 0.0, 1.0)


def sheen_brdf(alpha, n_dot_l, n_dot_v, n_dot_h):
    """Bsdf.hlsli:199-202 (visibility called with (n_dot_v, n_dot_l) — symmetric)."""
    return sheen_normal_distribution(alpha, n_dot_h) * sheen_visibility(alpha, n_dot_v, n_dot_l)


@functools.lru_cache(maxsize=1)
def sheen_e_table():
    """The sheen directional-albedo LUT E(cos_theta, alpha), (16, 16) f32.

    The exact Dassault Systèmes Enterprise PBR (DSPBR) table the reference
    loads from Resources/Sheen_E.exr (GpuResources.cpp:72-132) — embedded as
    data/sheen_e.npy (CC-BY-SA 4.0 with attribution, see
    data/SHEEN_E_LICENSE.txt). Sampled bilinearly by sheen_e() with the same
    (cos_theta, alpha) uv convention as Bsdf.hlsli:204-208, so sheen shading
    is bit-identical to the reference. sheen_e_table_mc remains as the
    self-contained Monte-Carlo rebuild (corr 0.986 — validated in tests).
    """
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "data", "sheen_e.npy")
    return np.load(path).astype(np.float32)


@functools.lru_cache(maxsize=1)
def sheen_e_table_mc(res_cos: int = 64, res_alpha: int = 64, n_samples: int = 8192):
    """Directional albedo E(cos_theta_v, alpha) of the Charlie sheen BRDF.

    Rebuilds the Resources/Sheen_E.exr LUT (loaded in GpuResources.cpp:72-132)
    by cosine-weighted Monte-Carlo with a Hammersley set:
        E = pi * mean_over_cosine_samples[ sheen_brdf(v, l) ].
    Returned as a numpy (res_alpha, res_cos) array indexed [alpha, cos].
    """
    i = np.arange(n_samples, dtype=np.uint32)
    # radical inverse base 2
    bits = i.copy()
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    u1 = (i.astype(np.float64) + 0.5) / n_samples
    u2 = bits.astype(np.float64) * 2.3283064365386963e-10
    # cosine-weighted hemisphere samples (local +z frame)
    phi = 2.0 * np.pi * u2
    cos_l = np.sqrt(1.0 - u1)
    sin_l = np.sqrt(u1)
    l = np.stack([sin_l * np.cos(phi), sin_l * np.sin(phi), cos_l], axis=-1)  # (S, 3)

    cos_v = (np.arange(res_cos) + 0.5) / res_cos
    alpha = np.clip((np.arange(res_alpha) + 0.5) / res_alpha, 1e-3, 1.0)
    sin_v = np.sqrt(1.0 - cos_v * cos_v)
    v = np.stack([sin_v, np.zeros_like(cos_v), cos_v], axis=-1)  # (C, 3)

    h = v[:, None, :] + l[None, :, :]
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    n_dot_h = h[..., 2]  # (C, S)
    n_dot_l = cos_l[None, :]
    n_dot_v = cos_v[:, None]

    a = alpha[:, None, None]  # (A, 1, 1)
    inv_r = 1.0 / a
    sin2 = np.maximum(1.0 - n_dot_h * n_dot_h, 0.0)[None]
    d = (2.0 + inv_r) * np.power(sin2, inv_r * 0.5) / (2.0 * np.pi)

    def lam(aa, x):
        t = (1.0 - aa) ** 2
        ca = 21.5473 + (25.3245 - 21.5473) * t
        cb = 3.82987 + (3.32435 - 3.82987) * t
        cc = 0.19823 + (0.16801 - 0.19823) * t
        cd = -1.97760 + (-1.27393 + 1.97760) * t
        ce = -4.32054 + (-4.85967 + 4.32054) * t
        return ca / (1.0 + cb * np.power(np.maximum(x, 1e-20), cc)) + cd * x + ce

    def shadow(aa, ct):
        return np.where(
            ct < 0.5,
            np.exp(lam(aa, ct)),
            np.exp(2.0 * lam(aa, 0.5) - lam(aa, 1.0 - ct)),
        )

    vis = 1.0 / np.maximum(
        (1.0 + shadow(a, n_dot_l[None]) + shadow(a, n_dot_v[None]))
        * 4.0 * n_dot_l[None] * n_dot_v[None],
        1e-20,
    )
    vis = np.clip(vis, 0.0, 1.0)
    f = d * vis  # (A, C, S)
    e = np.pi * f.mean(axis=-1)  # cosine-weighted estimator
    return np.clip(e, 0.0, 1.0).astype(np.float32)


def sheen_e(alpha, cos_theta, table=None):
    """Bilinear LUT lookup, linear-clamp semantics (Bsdf.hlsli:204-208).

    Texture coords: x = cos_theta, y = alpha; texel centers at (i+0.5)/N.
    """
    if table is None:
        table = jnp.asarray(sheen_e_table())
    res_a, res_c = table.shape
    x = jnp.clip(cos_theta * res_c - 0.5, 0.0, res_c - 1.0)
    y = jnp.clip(alpha * res_a - 0.5, 0.0, res_a - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, res_c - 1)
    y1 = jnp.minimum(y0 + 1, res_a - 1)
    fx = x - x0
    fy = y - y0
    v00 = table[y0, x0]
    v01 = table[y0, x1]
    v10 = table[y1, x0]
    v11 = table[y1, x1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def sheen_mix(material, layer, sheen_color, alpha, n_dot_l, n_dot_v, table=None):
    """Albedo-scaling sheen layering. Bsdf.hlsli:210-214."""
    mx = max_value(sheen_color)[..., 0]
    scale = jnp.minimum(
        1.0 - mx * sheen_e(alpha, n_dot_v, table), 1.0 - mx * sheen_e(alpha, n_dot_l, table)
    )
    return sheen_color * layer[..., None] + material * scale[..., None]


# ---------------------------------------------------------------------------
# Transmission & volume (Bsdf.hlsli:216-239)
# ---------------------------------------------------------------------------

def modulate_roughness(a, ior):
    """Bsdf.hlsli:216-220."""
    return jnp.clip(a * saturate(2.0 * (ior - 1.0)), MINIMUM_ROUGHNESS, 1.0)


def thin_transmission_btdf(color, a, ior, n, v, l):
    """Thin-surface transmission = flipped-reflection GGX. Bsdf.hlsli:222-228.

    a, ior: (..., 1) — squeezed internally to match the (...,) dot products.
    """
    a = modulate_roughness(a, ior)[..., 0]
    l = l - 2.0 * dot(n, l) * n
    h = normalize(v + l)
    return color * specular_brdf(
        a,
        dot(n, l, keepdims=False),
        dot(n, v, keepdims=False),
        dot(n, h, keepdims=False),
        dot(h, l, keepdims=False),
        dot(h, v, keepdims=False),
    )[..., None]


def attenuate(attenuation_distance, attenuation_color, distance):
    """Beer's law. Bsdf.hlsli:232-239.

    attenuation_distance: (..., 1); attenuation_color: (..., 3); distance: (..., 1).
    """
    expo = distance / jnp.maximum(attenuation_distance, 1e-8)
    att = jnp.power(jnp.maximum(attenuation_color, 1e-8), expo)
    return jnp.where(attenuation_distance == 0.0, 1.0, att)


# ---------------------------------------------------------------------------
# Full layered BSDF (Bsdf.hlsli:241-325)
# ---------------------------------------------------------------------------

def gltf_bsdf(
    sp: SurfaceProperties,
    v,
    l,
    is_transmission: Optional[jnp.ndarray] = None,
    sheen_table=None,
    enable_sheen: bool = True,
    enable_clearcoat: bool = True,
    enable_transmission: bool = True,
):
    """Layered glTF BSDF evaluation.

    With is_transmission=None this is GltfBsdf (Bsdf.hlsli:241-282); with an
    (...,) bool mask it is the reflection/transmission-masked variant
    (Bsdf.hlsli:284-325). Returns (..., 3) BSDF value (radiance units, not
    premultiplied by any cosine beyond the reference's saturate terms).
    """
    a = sp.roughness_squared
    n = sp.shading_normal
    h = normalize(v + l)
    t, b = sp.anisotropy_tangent, sp.anisotropy_bitangent
    v_local = to_local(t, b, n, v)
    h_local = to_local(t, b, n, h)
    l_local = to_local(t, b, n, l)
    h_dot_l = dot(h, l, keepdims=False)
    h_dot_v = dot(h, v, keepdims=False)

    l_abs = jnp.concatenate([l_local[..., 0:2], jnp.abs(l_local[..., 2:3])], axis=-1)
    h_dot_abs_l = jnp.sum(normalize(l_abs + v_local) * v_local, axis=-1)

    if is_transmission is None:
        refl_mask = jnp.ones(l_local.shape[:-1], l_local.dtype)
        trans_mask = jnp.ones_like(refl_mask)
    else:
        refl_mask = jnp.where(is_transmission, 0.0, 1.0)
        trans_mask = jnp.where(is_transmission, 1.0, 0.0)

    lz_pos = saturate(l_local[..., 2])
    lz_neg = saturate(-l_local[..., 2])

    specular = (refl_mask * lz_pos * anisotropic_specular_brdf(a, v_local, h_local, l_local))[
        ..., None
    ]
    diffuse = refl_mask[..., None] * lz_pos[..., None] * lambert_diffuse(sp.albedo)
    if enable_transmission:
        transmission = trans_mask[..., None] * lz_neg[..., None] * thin_transmission_btdf(
            sp.albedo, a[..., 1:2], sp.ior, n, v, l
        )
        diffuse = diffuse + sp.transmissive * (transmission - diffuse)
    dielectric = fresnel_mix(
        sp.specular_color, sp.ior, sp.specular_factor, diffuse, specular, h_dot_abs_l[..., None]
    )
    metal = refl_mask[..., None] * conductor_fresnel(specular, sp.albedo, h_dot_v[..., None])
    material = dielectric + sp.metalness * (metal - dielectric)

    # Sheen (statically skipped when no material in the scene has sheen).
    if enable_sheen:
        sheen_a = jnp.clip(sp.sheen_roughness_squared[..., 0], 1e-6, 1.0)
        sheen = refl_mask * lz_pos * sheen_brdf(
            sheen_a, l_local[..., 2], v_local[..., 2], h_local[..., 2]
        )
        material = sheen_mix(
            material, sheen, sp.sheen_color, sheen_a, l_local[..., 2], v_local[..., 2],
            sheen_table,
        )

    if not enable_clearcoat:
        return material

    # Clearcoat EVALUATION is about the SHADING normal — the reference's
    # GltfBsdf computes clearcoat_n_dot_{v,h,l} with n = shading_normal
    # (Bsdf.hlsli:275-279, :318-322) even though SampleClearcoat /
    # ClearcoatPdf / LayerProbabilities use clearcoat_normal
    # (PathTracer.lib.hlsl:394-411, :540). Replicated exactly: the
    # asymmetry is image-affecting on normal-mapped clearcoat materials
    # (round-4 parity-review finding; was clearcoat_normal here).
    cn = sp.shading_normal
    cc_n_dot_v = dot(cn, v, keepdims=False)
    cc_n_dot_h = dot(cn, h, keepdims=False)
    cc_n_dot_l = dot(cn, l, keepdims=False)
    cc = refl_mask * saturate(cc_n_dot_l) * clearcoat_brdf(
        sp.clearcoat_roughness[..., 0], cc_n_dot_l, cc_n_dot_v, cc_n_dot_h, h_dot_l, h_dot_v
    )
    coated = fresnel_coat(
        1.5, sp.clearcoat, material, cc[..., None], cc_n_dot_v[..., None]
    )
    return coated
