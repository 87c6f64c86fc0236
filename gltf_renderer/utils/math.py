"""Core mapping / basis / codec math, vectorized over leading dims.

Behavioral parity targets in the reference (cited per function):
  Source/Shaders/Common.hlsli      — octahedral codec, basis construction
  Source/Shaders/Transforms.hlsli  — square<->disk/sphere, equirect/cube mappings
  Source/Shaders/Vertex.hlsli      — 10:10:10:2 tangent-space codec
  Source/Shaders/Color.hlsli       — luminance, sRGB encode
All functions are pure jnp and safe under jit/vmap; vectors live on the last axis.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = 3.14159265359
TAU = 2.0 * PI


def dot(a, b, keepdims=True):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def normalize(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def cross(a, b):
    return jnp.cross(a, b)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def length(v):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 0.0))


def max_value(color):
    """MaxValue — Bsdf.hlsli:34-37."""
    return jnp.max(color, axis=-1, keepdims=True)


def sign_not_zero(x):
    """SignNotZero — Common.hlsli:70-76 (>= 0 -> 1 else -1)."""
    return jnp.where(x >= 0.0, 1.0, -1.0)


# ---------------------------------------------------------------------------
# Octahedral normal codec (Common.hlsli:78-103)
# ---------------------------------------------------------------------------

def encode_octahedral(n):
    """Unit vector -> [-1,1]^2 octahedral map. Common.hlsli:78-89."""
    denom = jnp.abs(n[..., 0:1]) + jnp.abs(n[..., 1:2]) + jnp.abs(n[..., 2:3])
    octa = n / denom
    xy = octa[..., 0:2]
    yx_abs = jnp.abs(octa[..., [1, 0]])
    folded = sign_not_zero(xy) * (1.0 - yx_abs)
    return jnp.where(octa[..., 2:3] >= 0.0, xy, folded)


def decode_octahedral(e):
    """[-1,1]^2 -> unit vector. Common.hlsli:91-103."""
    z = 1.0 - jnp.abs(e[..., 0:1]) - jnp.abs(e[..., 1:2])
    xy = jnp.where(z >= 0.0, e, sign_not_zero(e) * (1.0 - jnp.abs(e[..., [1, 0]])))
    return normalize(jnp.concatenate([xy, z], axis=-1))


# ---------------------------------------------------------------------------
# Basis construction (Common.hlsli:33-53)
# ---------------------------------------------------------------------------

def create_basis(n):
    """Tangent/bitangent for normal n. Common.hlsli CreateBasis:33-42.

    Returns (t, b) with rows [t, b, n] forming world_to_local.
    """
    use_x = jnp.abs(n[..., 0:1]) > jnp.abs(n[..., 2:3])
    b1 = jnp.stack([-n[..., 1], n[..., 0], jnp.zeros_like(n[..., 0])], axis=-1)
    b2 = jnp.stack([jnp.zeros_like(n[..., 0]), -n[..., 2], n[..., 1]], axis=-1)
    b = normalize(jnp.where(use_x, b1, b2))
    t = cross(b, n)
    return t, b


def create_basis_accurate(n):
    """Duff et al. branchless ONB (jcgt 6(1)). Common.hlsli:46-53."""
    s = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    b1 = jnp.concatenate(
        [1.0 + s * n[..., 0:1] * n[..., 0:1] * a, s * b, -s * n[..., 0:1]], axis=-1
    )
    b2 = jnp.concatenate(
        [b, s + n[..., 1:2] * n[..., 1:2] * a, -n[..., 1:2]], axis=-1
    )
    return b1, b2


def to_local(t, b, n, v):
    """world->tangent: rows (t,b,n) dotted with v."""
    return jnp.concatenate(
        [dot(t, v), dot(b, v), dot(n, v)], axis=-1
    )


def to_world(t, b, n, v_local):
    return (
        v_local[..., 0:1] * t + v_local[..., 1:2] * b + v_local[..., 2:3] * n
    )


def reflect(i, n):
    """HLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i) * n


# ---------------------------------------------------------------------------
# Square / disk / sphere mappings (Transforms.hlsli)
# ---------------------------------------------------------------------------

def uv_to_unit_square(uv):
    """Transforms.hlsli:52-55 — uv*(2,-2)+(-1,1)."""
    return uv * jnp.array([2.0, -2.0], uv.dtype) + jnp.array([-1.0, 1.0], uv.dtype)


def unit_square_to_uv(sq):
    """Transforms.hlsli:57-60."""
    return (sq - jnp.array([-1.0, 1.0], sq.dtype)) * jnp.array([0.5, -0.5], sq.dtype)


def square_to_disk(square):
    """Branchless concentric mapping. Transforms.hlsli SquareToDisk2:82-89."""
    ax = jnp.abs(square[..., 0])
    ay = jnp.abs(square[..., 1])
    r = jnp.maximum(ax, ay)
    phi = jnp.where(r == 0.0, 0.0, PI * (r + (ay - ax)) / (4.0 * jnp.where(r == 0, 1.0, r)))
    x = jnp.sign(square[..., 0]) * r * jnp.cos(phi)
    y = jnp.sign(square[..., 1]) * r * jnp.sin(phi)
    return jnp.stack([x, y], axis=-1)


def square_to_sphere(square):
    """Octahedral-concentric square->sphere. Transforms.hlsli:125-137."""
    ax = jnp.abs(square[..., 0])
    ay = jnp.abs(square[..., 1])
    d = 1.0 - (ax + ay)
    r = 1.0 - jnp.abs(d)
    phi = jnp.where(
        r == 0.0, 0.0, (PI / 4.0) * ((ay - ax) / jnp.where(r == 0.0, 1.0, r) + 1.0)
    )
    f = r * jnp.sqrt(jnp.maximum(2.0 - r * r, 0.0))
    x = f * jnp.sign(square[..., 0]) * jnp.cos(phi)
    y = f * jnp.sign(square[..., 1]) * jnp.sin(phi)
    z = jnp.sign(d) * (1.0 - r * r)
    return jnp.stack([x, y, z], axis=-1)


def sphere_to_square(sphere):
    """Inverse of square_to_sphere. Transforms.hlsli:139-150."""
    z = sphere[..., 2]
    r = jnp.sqrt(jnp.maximum(1.0 - jnp.abs(z), 0.0))
    phi = jnp.arctan2(jnp.abs(sphere[..., 1]), jnp.abs(sphere[..., 0]))
    d = jnp.sign(z) * (1.0 - r)
    diff = r * ((4.0 / PI) * phi - 1.0)
    x = jnp.sign(sphere[..., 0]) * 0.5 * (1.0 - d - diff)
    y = jnp.sign(sphere[..., 1]) * 0.5 * (1.0 - d + diff)
    return jnp.stack([x, y], axis=-1)


# ---------------------------------------------------------------------------
# Equirectangular / cubemap direction math (Transforms.hlsli:3-50)
# ---------------------------------------------------------------------------

def direction_to_equirectangular(d):
    """Direction -> equirect uv. Transforms.hlsli:3-8 (Z-up convention)."""
    u = jnp.arctan2(d[..., 1], d[..., 0]) / TAU
    v = 1.0 - ((d[..., 2] + 1.0) / 2.0)
    return jnp.stack([u, v], axis=-1)


# Face axes from Transforms.hlsli:10-50 (D3D cube face order +X,-X,+Y,-Y,+Z,-Z).
_CUBE_FACE_DIR = jnp.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], jnp.float32
)
_CUBE_U_DIR = jnp.array(
    [[0, 0, -1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [-1, 0, 0]], jnp.float32
)
_CUBE_V_DIR = jnp.array(
    [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]], jnp.float32
)


def cubemap_to_direction(face, uv):
    """(face, uv in [0,1]^2) -> unit direction. Transforms.hlsli:10-50.

    The per-face basis is applied as branchless selects instead of
    `_CUBE_*_DIR[face]` table rows: the selects fuse into the surrounding
    elementwise kernel instead of paying for a tiny-table gather. Each component equals the
    old fd + u*ud + v*vd sum exactly (one nonzero term per component)."""
    su = uv[..., 0] * 2.0 - 1.0
    sv = uv[..., 1] * 2.0 - 1.0
    one = jnp.ones_like(su)

    def pick(c0, c1, c2, c3, c4, c5):
        return jnp.where(
            face == 0, c0,
            jnp.where(face == 1, c1,
                      jnp.where(face == 2, c2,
                                jnp.where(face == 3, c3,
                                          jnp.where(face == 4, c4, c5)))))

    x = pick(one, -one, su, su, su, -su)
    y = pick(-sv, -sv, one, -one, -sv, -sv)
    z = pick(-su, su, sv, -sv, one, -one)
    return normalize(jnp.stack([x, y, z], axis=-1))


def direction_to_cubemap(d):
    """Unit direction -> (face, uv) matching cubemap_to_direction.

    Standard D3D cube addressing: major axis selects the face; uv derived
    from the per-face (u_dir, v_dir) axes above — applied arithmetically
    (sign flips + axis selects, no `[face]` table gathers; same rationale
    and exactness as cubemap_to_direction).
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = jnp.where(
        is_x,
        jnp.where(dx >= 0, 0, 1),
        jnp.where(is_y, jnp.where(dy >= 0, 2, 3), jnp.where(dz >= 0, 4, 5)),
    )
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    sx = jnp.where(dx >= 0, 1.0, -1.0)
    sy = jnp.where(dy >= 0, 1.0, -1.0)
    sz = jnp.where(dz >= 0, 1.0, -1.0)
    # u = d . u_dir[face], v = d . v_dir[face] with the tables inlined:
    # faces 0/1 (+-x): u = -+dz, v = -dy;  2/3 (+-y): u = dx, v = +-dz;
    # faces 4/5 (+-z): u = +-dx, v = -dy.
    u = jnp.where(is_x, -sx * dz, jnp.where(is_y, dx, sz * dx))
    v = jnp.where(is_y, sy * dz, -dy)
    inv = 1.0 / jnp.maximum(ma, 1e-20)
    uv = (jnp.stack([u * inv, v * inv], axis=-1) + 1.0) * 0.5
    return face, uv


# ---------------------------------------------------------------------------
# Tangent-space 10:10:10:2 codec (Vertex.hlsli:5-49)
# ---------------------------------------------------------------------------

def decode_tangent_space(encoded):
    """Decode float4 (normalized 10:10:10:2) -> (normal, tangent[4]).

    Vertex.hlsli DecodeTangentSpace:5-20 — octahedral normal, tangent as an
    angle in the Duff canonical basis, winding in .w.
    """
    normal = decode_octahedral(encoded[..., 0:2] * 2.0 - 1.0)
    ct, cb = create_basis_accurate(normal)
    angle = TAU * encoded[..., 2:3]
    tangent_xyz = jnp.cos(angle) * ct + jnp.sin(angle) * cb
    tangent_w = jnp.where(encoded[..., 3:4] > 0.0, 1.0, -1.0)
    return normal, jnp.concatenate([tangent_xyz, tangent_w], axis=-1)


def encode_tangent_space(normal, tangent):
    """(normal, tangent[4]) -> packed uint32. Vertex.hlsli EncodeTangentSpace:22-44."""
    en = 0.5 * encode_octahedral(normal) + 0.5
    qn = (jnp.clip(en, 0.0, 1.0) * 1023.0 + 0.5).astype(jnp.uint32)
    # Re-decode the quantized normal before deriving the canonical basis.
    n2 = decode_octahedral(2.0 * (qn.astype(jnp.float32) / 1023.0) - 1.0)
    ct, cb = create_basis_accurate(n2)
    angle = jnp.arctan2(
        jnp.sum(tangent[..., 0:3] * cb, axis=-1), jnp.sum(tangent[..., 0:3] * ct, axis=-1)
    )
    et = angle / TAU + 0.5
    qt = (et * 1023.0 + 0.5).astype(jnp.uint32)
    qw = jnp.where(tangent[..., 3] == 1.0, jnp.uint32(3), jnp.uint32(0))
    return qn[..., 0] | (qn[..., 1] << 10) | (qt << 20) | (qw << 30)


def unpack_r10g10b10a2(packed):
    """uint32 -> normalized float4. Vertex.hlsli:46-49."""
    p = packed.astype(jnp.uint32)
    vals = jnp.stack(
        [
            (p & 0x3FF).astype(jnp.float32) / 1023.0,
            ((p >> 10) & 0x3FF).astype(jnp.float32) / 1023.0,
            ((p >> 20) & 0x3FF).astype(jnp.float32) / 1023.0,
            ((p >> 30) & 0x3).astype(jnp.float32) / 3.0,
        ],
        axis=-1,
    )
    return vals


# ---------------------------------------------------------------------------
# Color (Color.hlsli)
# ---------------------------------------------------------------------------

def luminance(color):
    """Rec.709 luminance. Color.hlsli:4-7."""
    w = jnp.array([0.2126, 0.7152, 0.0722], color.dtype)
    return jnp.sum(color * w, axis=-1)


def encode_srgb(c):
    """Linear -> sRGB. Color.hlsli:9-16."""
    return jnp.where(
        c <= 0.0031308, c * 12.92, 1.055 * jnp.power(jnp.maximum(c, 1e-10), 1.0 / 2.4) - 0.055
    )


def decode_srgb(c):
    """sRGB -> linear (inverse of encode_srgb; used for texture uploads)."""
    return jnp.where(
        c <= 0.04045, c / 12.92, jnp.power(jnp.maximum((c + 0.055) / 1.055, 1e-10), 2.4)
    )
