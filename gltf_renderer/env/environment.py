"""Environment-map pipeline: equirect -> cubemap (+mips), GGX-prefiltered cube,
diffuse-convolved cube, luminance importance pyramid; plus sampling/eval fns.

Port of EnvironmentMap.cpp:84-455 and the five compute shaders
(ConvertEquirectangularToCubemap, GenerateMipLevelArray,
FilterEnvironmentCubeMap, GenerateEnvironmentImportanceMap(+Level)) as jitted
array programs. Deviation (documented): the cube resolution is a power of two
(the reference's formula `(W/4)/2 + 1` is flagged `TODO ... not correct`,
EnvironmentMap.cpp:92); importance map stays 1024^2 with a *sum* (not mean)
pyramid (GenerateEnvironmentImportanceMapLevel.cs.hlsl:27-31).
"""

from __future__ import annotations

import functools
import os
from typing import Any, List, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.ops import rng
from gltf_renderer.ops import sampling
from gltf_renderer.ops.bsdf import ggx_d
from gltf_renderer.utils.math import (
    PI,
    cubemap_to_direction,
    direction_to_cubemap,
    direction_to_equirectangular,
    luminance,
    normalize,
    reflect,
    saturate,
    square_to_sphere,
    sphere_to_square,
    to_world,
    unit_square_to_uv,
    uv_to_unit_square,
    create_basis,
)

IMPORTANCE_RESOLUTION = 1024       # EnvironmentMap.cpp:99
DIFFUSE_RESOLUTION = 256           # EnvironmentMap.cpp:114
GGX_SMALLEST_MIP = 4               # EnvironmentMap.cpp:106
GGX_SAMPLES, GGX_MIP_BIAS = 256, 2.0       # EnvironmentMap.cpp:395
DIFFUSE_SAMPLES, DIFFUSE_MIP_BIAS = 512, 3.0  # EnvironmentMap.cpp:400


class EnvMaps(NamedTuple):
    """Device pytree for one environment."""

    cube: List[Any]        # mip list of (6, S, S, 3) f32
    ggx: List[Any]         # mip list (roughness = (i/(n-1))^2)
    diffuse: Any           # (6, D, D, 3)
    importance: List[Any]  # mip list of (S, S) luminance *sums*; [-1] is (1,1)
    equirect: Any          # (H, W, 3) source
    importance_quads: List[Any] = None  # quad-packed mips (one-gather descent)
    alias_rows: Any = None  # (S*S, 4) Walker alias table (O(1) env sampling)
    ggx_quad: Any = None   # (sum 6*S*S, 12) f32: each ggx-pyramid texel with
    # its face-clamped +x/+y/+xy neighbors baked in — raster IBL trilinear
    # then gathers 2 rows/pixel instead of 8 (build_cube_quads; bit-exact,
    # ~4x the pyramid's few MB). GLTF_QUADCUBE=0 disables.
    diffuse_quad: Any = None  # (6*D*D, 12) f32 — same for the diffuse cube
    cube0_quad: Any = None  # (6*S*S, 12) f32 — same for cube level 0 (the
    # PT's miss-radiance + env-NEE color fetches, 2x 4-row gathers/bounce)


# ---------------------------------------------------------------------------
# Sampling helpers over cube/equirect textures
# ---------------------------------------------------------------------------

def sample_equirect(img, uv):
    """Bilinear, wrap-x / clamp-y."""
    h, w = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    def fetch(xi, yi):
        xi = jnp.mod(xi, w)
        yi = jnp.clip(yi, 0, h - 1)
        return img[yi, xi]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def build_cube_quads(mips) -> Any:
    """Bake each cube-pyramid texel's face-clamped 2x2 bilinear neighborhood
    into one flat (sum 6*S*S, 12) array (host numpy, once per scene).

    Cube bilinear is face-CLAMPED (sample_cube_level), so the baked +1
    neighbors are plain clamps inside each face — sample-time corner-select
    (a clamped +1 collapsing onto the same texel takes the center channel)
    reproduces the 4-corner path bit-exactly. Raster IBL's trilinear cube
    fetch then costs 2 gather rows per pixel instead of 8 (the largest
    single cost of the raster frame before the GPU port; not yet measured
    on the H100)."""
    parts = []
    for m in mips:
        img = np.asarray(m)                     # (6, S, S, C)
        s = img.shape[1]
        xp = np.minimum(np.arange(s) + 1, s - 1)
        q = np.concatenate(
            [img, img[:, :, xp], img[:, xp], img[:, xp][:, :, xp]], axis=-1
        )
        parts.append(q.reshape(-1, q.shape[-1]))
    out = np.concatenate(parts, 0)
    if os.environ.get("GLTF_QUADF32", "0") != "1":
        # f16 rows: the reference's cube/ggx/diffuse textures are
        # DXGI_FORMAT_R16G16B16A16_FLOAT (EnvironmentMap.cpp:93-120), so
        # half storage is the MORE faithful precision — and it halves the
        # bytes of the env quad gather, a cache-miss-bound line in profiles
        # taken before the GPU port. Clamp
        # to the f16 range so >65504 radiance texels saturate instead of
        # becoming inf (inf*0 in the bilerp would mint NaNs).
        out = np.clip(out, -65504.0, 65504.0).astype(np.float16)
    return out


def _quad_bilerp(q, xpf, ypf, tx, ty):
    """Bilinear over one quad row [c00, c10, c01, c11] with corner-select.

    xpf/ypf are exactly-0/1 FLOAT corner-select masks, blended
    arithmetically (a bool mask crossing the fusion boundary took a slow
    packed layout before the GPU port). Blend == select bit-exactly for the
    finite corner values here."""
    c = q.shape[-1] // 4
    c00 = q[..., 0:c]
    c10 = q[..., c:2 * c] * xpf + c00 * (1.0 - xpf)
    c01 = q[..., 2 * c:3 * c] * ypf + c00 * (1.0 - ypf)
    c11_x = q[..., 3 * c:4 * c] * ypf + q[..., c:2 * c] * (1.0 - ypf)
    c11 = c11_x * xpf + c01 * (1.0 - xpf)
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (
        c01 * (1 - tx) + c11 * tx) * ty


def sample_cube_level(faces, direction, quad=None):
    """Bilinear within one cube mip (faces (6, S, S, 3)); face-clamped.

    All four corners ride ONE flat row gather instead of 4 separate
    (face, y, x) gathers (a per-gather cost model from before the GPU port;
    not yet measured on the H100). With `quad` (build_cube_quads of [faces]) the
    four corners ride ONE quad row — a single R-row gather."""
    face, uv = direction_to_cubemap(direction)
    s = faces.shape[1]
    fx = uv[..., 0] * s - 0.5
    fy = uv[..., 1] * s - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    base = face * (s * s)

    if quad is not None:
        w0x = jnp.clip(x0, 0, s - 1)
        w0y = jnp.clip(y0, 0, s - 1)
        xpf = (jnp.clip(x0 + 1, 0, s - 1) != w0x).astype(jnp.float32)[..., None]
        ypf = (jnp.clip(y0 + 1, 0, s - 1) != w0y).astype(jnp.float32)[..., None]
        q = quad[(base + w0y * s + w0x).reshape(-1)].reshape(
            face.shape + (quad.shape[-1],)).astype(jnp.float32)
        return _quad_bilerp(q, xpf, ypf, tx, ty)

    flat = faces.reshape(-1, faces.shape[-1])

    def flat_idx(xi, yi):
        return base + jnp.clip(yi, 0, s - 1) * s + jnp.clip(xi, 0, s - 1)

    idx = jnp.stack(
        [flat_idx(x0, y0), flat_idx(x0 + 1, y0),
         flat_idx(x0, y0 + 1), flat_idx(x0 + 1, y0 + 1)]
    )
    c = flat[idx.reshape(-1)].reshape(idx.shape + (faces.shape[-1],))
    c00, c10, c01, c11 = c[0], c[1], c[2], c[3]
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def sample_cube(mips: List[Any], direction, level, quad=None):
    """Trilinear across a mip list; `level` may be fractional (R,).

    ONE fused gather over the flattened mip pyramid: the 8 contributing
    texels (4 bilinear corners x 2 levels) gather together from a
    concatenated flat pyramid with static per-level offsets — the per-level
    loop this replaces paid one full gather PER MIP and kept two.

    quad (build_cube_quads(mips)): corners ride baked quad rows — TWO
    gather rows per ray instead of eight, bit-identical output."""
    n = len(mips)
    if n == 1:
        return sample_cube_level(mips[0], direction, quad=quad)
    level = jnp.clip(level, 0.0, n - 1)
    l0 = jnp.floor(level).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n - 1)
    frac = (level - l0.astype(jnp.float32))[..., None]

    sizes_py = [m.shape[1] for m in mips]
    offs_py = [int(o) for o in np.cumsum([0] + [6 * s * s for s in sizes_py[:-1]])]

    def _level_select(li, vals):
        # Per-level constants via a fused where-chain instead of tiny-table
        # gathers: n-1 selects fuse into the surrounding elementwise kernel.
        out = jnp.full_like(li, vals[0])
        for k in range(1, len(vals)):
            out = jnp.where(li == k, vals[k], out)
        return out

    def sizes(li):
        return _level_select(li, sizes_py)

    def offs(li):
        return _level_select(li, offs_py)

    face, uv = direction_to_cubemap(direction)

    if quad is not None:
        def level_quad(li):
            s = sizes(li)
            off = offs(li)
            sf = s.astype(jnp.float32)
            fx = uv[..., 0] * sf - 0.5
            fy = uv[..., 1] * sf - 0.5
            x0 = jnp.floor(fx).astype(jnp.int32)
            y0 = jnp.floor(fy).astype(jnp.int32)
            tx = (fx - x0)[..., None]
            ty = (fy - y0)[..., None]
            w0x = jnp.clip(x0, 0, s - 1)
            w0y = jnp.clip(y0, 0, s - 1)
            xpf = (jnp.clip(x0 + 1, 0, s - 1) != w0x).astype(jnp.float32)[..., None]
            ypf = (jnp.clip(y0 + 1, 0, s - 1) != w0y).astype(jnp.float32)[..., None]
            return off + face * (s * s) + w0y * s + w0x, xpf, ypf, tx, ty

        i0, xp0, yp0, tx0, ty0 = level_quad(l0)
        i1, xp1, yp1, tx1, ty1 = level_quad(l1)
        ids = jnp.stack([i0, i1])                       # (2, R)
        q = quad[ids.reshape(-1)].reshape(
            ids.shape + (quad.shape[-1],)).astype(jnp.float32)
        out0 = _quad_bilerp(q[0], xp0, yp0, tx0, ty0)
        out1 = _quad_bilerp(q[1], xp1, yp1, tx1, ty1)
        return out0 * (1 - frac) + out1 * frac

    flat = jnp.concatenate([m.reshape(-1, m.shape[-1]) for m in mips])

    def corner_ids(li):
        s = sizes(li)
        off = offs(li)
        sf = s.astype(jnp.float32)
        fx = uv[..., 0] * sf - 0.5
        fy = uv[..., 1] * sf - 0.5
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        tx = (fx - x0)[..., None]
        ty = (fy - y0)[..., None]
        base = off + face * (s * s)

        def fi(xi, yi):
            return base + jnp.clip(yi, 0, s - 1) * s + jnp.clip(xi, 0, s - 1)

        ids = jnp.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1),
                         fi(x0 + 1, y0 + 1)])
        return ids, tx, ty

    ids0, tx0, ty0 = corner_ids(l0)
    ids1, tx1, ty1 = corner_ids(l1)
    ids = jnp.concatenate([ids0, ids1])                 # (8, R)
    c = flat[ids.reshape(-1)].reshape(ids.shape + (flat.shape[-1],))

    def lerp(cs, tx, ty):
        return (cs[0] * (1 - tx) + cs[1] * tx) * (1 - ty) + (
            cs[2] * (1 - tx) + cs[3] * tx
        ) * ty

    out0 = lerp(c[0:4], tx0, ty0)
    out1 = lerp(c[4:8], tx1, ty1)
    return out0 * (1 - frac) + out1 * frac


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _face_pixel_dirs(size):
    uv = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    u, v = jnp.meshgrid(uv, uv, indexing="xy")  # u = x, v = y
    dirs = []
    for f in range(6):
        face = jnp.full(u.shape, f, jnp.int32)
        d = cubemap_to_direction(face, jnp.stack([u, v], -1))
        dirs.append(d)
    return jnp.stack(dirs, 0)  # (6, S, S, 3)


@functools.partial(jax.jit, static_argnums=(1,))
def build_cubemap(equirect, size: int):
    """ConvertEquirectangularToCubemap.cs.hlsl port."""
    dirs = _face_pixel_dirs(size)
    uv = direction_to_equirectangular(dirs)
    uv = jnp.stack([jnp.mod(uv[..., 0], 1.0), uv[..., 1]], -1)
    return sample_equirect(equirect, uv)


def build_cube_mips(cube0) -> List[Any]:
    """GenerateMipLevelArray.cs.hlsl: 2x2 box filter down to 1x1."""
    mips = [cube0]
    cur = cube0
    while cur.shape[1] > 1:
        s = cur.shape[1] // 2
        cur = 0.25 * (
            cur[:, 0::2, 0::2] + cur[:, 1::2, 0::2] + cur[:, 0::2, 1::2] + cur[:, 1::2, 1::2]
        )
        mips.append(cur)
    return mips


def _mip_axis_filter(img, axis: int):
    """One separable pass of GenerateMipLevel.cs.hlsl along `axis`.

    Per-axis kernel (GenerateMipLevel.cs.hlsl:55): input size 1 -> passthrough
    of index 2p+1... (case 1 reads input_texture[pixel + 1]: with size-1 input
    the only in-range read is index 0 after wrap — we pass through); even ->
    2-tap box; odd -> 3-tap trapezoid with weights ((n-x)/(2n+1), n/(2n+1),
    (1+x)/(2n+1)) where x is the output index and n the output size
    (TrapezoidFilter, GenerateMipLevel.cs.hlsl:15-21), taps at 2x, 2x+1 and
    Wrap(2x+2) (the shader wraps instead of clamping — its own TODO)."""
    n_in = img.shape[axis]
    if n_in == 1:
        return img
    img_m = jnp.moveaxis(img, axis, 0)
    if n_in % 2 == 0:
        out = 0.5 * (img_m[0::2] + img_m[1::2])
    else:
        n_out = n_in // 2
        x = jnp.arange(n_out, dtype=jnp.float32).reshape(
            (n_out,) + (1,) * (img_m.ndim - 1)
        )
        n = jnp.float32(n_out)
        s0 = img_m[0 : 2 * n_out : 2]
        s1 = img_m[1 : 2 * n_out + 1 : 2]
        # Wrap(2x+2, n_in): only the last output's third tap wraps to 0.
        idx2 = (np.arange(n_out) * 2 + 2) % n_in
        s2 = img_m[jnp.asarray(idx2)]
        out = (
            (n - x) * s0 + n * s1 + (1.0 + x) * s2
        ) / (2.0 * n + 1.0)
    return jnp.moveaxis(out, 0, axis)


def generate_mip_level(img):
    """GenerateMipLevel.cs.hlsl: one NPOT-correct mip step of an (H, W, C)
    image — separable trapezoid (odd axis) / box (even axis) filter. The
    reference compiles this shader but never dispatches it (no call site in
    Source/*.cpp); ported for NPOT texture mip chains."""
    return _mip_axis_filter(_mip_axis_filter(img, 0), 1)


def build_image_mips(img, min_size: int = 1) -> List[Any]:
    """Full NPOT mip chain of an (H, W, C) image via generate_mip_level."""
    mips = [img]
    while max(mips[-1].shape[0], mips[-1].shape[1]) > min_size and (
        mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1
    ):
        nxt = generate_mip_level(mips[-1])
        if nxt.shape == mips[-1].shape:
            break
        mips.append(nxt)
    return mips


@functools.partial(jax.jit, static_argnums=(1, 3, 4, 5))
def _filter_cube_level(cube_mips, size, a, num_samples, mip_bias, bsdf_ggx: bool):
    """One output mip of FilterEnvironmentCubeMap.cs.hlsl (filtered importance
    sampling over an R2 sequence)."""
    dirs = _face_pixel_dirs(size)  # (6, S, S, 3)
    n = dirs.reshape(-1, 3)
    t, b = create_basis(n)
    input_width = cube_mips[0].shape[1]
    mip_count = len(cube_mips)
    omega_p = (4.0 * PI) / (6.0 * input_width * input_width)

    def body(i, carry):
        total, total_w = carry
        u = rng.r2(jnp.asarray([0.5, 0.5], jnp.float32), i.astype(jnp.float32))
        u = jnp.broadcast_to(u, n.shape[:-1] + (2,))
        if bsdf_ggx:
            h_local = sampling.sample_ggx_normal(a, u)
            pdf = ggx_d(a, h_local[..., 2]) / 4.0
            h = to_world(t, b, n, h_local)
            l = reflect(-n, h)
            w = saturate(jnp.sum(n * l, -1))
        else:
            l = sampling.sample_cosine_hemisphere(n, u)
            pdf = sampling.cosine_hemisphere_pdf(n, l)
            w = jnp.ones(n.shape[0], jnp.float32)
        omega_s = 1.0 / (num_samples * jnp.maximum(pdf, 1e-20))
        mip = 0.5 * jnp.log2(omega_s / omega_p)
        mip = jnp.clip(mip + mip_bias, 0.0, mip_count - 1)
        total = total + w[..., None] * sample_cube(cube_mips, l, mip)
        total_w = total_w + w
        return total, total_w

    total, total_w = jax.lax.fori_loop(
        0, num_samples, body, (jnp.zeros_like(n), jnp.zeros(n.shape[0], jnp.float32))
    )
    out = total / jnp.maximum(total_w[..., None], 1e-20)
    return out.reshape(6, size, size, 3)


def build_ggx_cube(cube_mips) -> List[Any]:
    """GenerateGgxCube (EnvironmentMap.cpp:393-396): per-mip GGX prefilter,
    roughness-squared a = (mip/(mips-1))^2 (MipToRoughness:17-22)."""
    size = cube_mips[0].shape[1]
    n_mips = max(int(np.floor(np.log2(size))) + 1 - GGX_SMALLEST_MIP, 1)
    out = []
    for i in range(n_mips):
        a = (i / max(n_mips - 1, 1)) ** 2
        s = max(size >> i, 1)
        if i == 0:
            out.append(cube_mips[0])  # a=0 -> mirror: the source itself
        else:
            out.append(
                _filter_cube_level(cube_mips, s, jnp.float32(a), GGX_SAMPLES, GGX_MIP_BIAS, True)
            )
    return out


def build_diffuse_cube(cube_mips):
    return _filter_cube_level(
        cube_mips, DIFFUSE_RESOLUTION, jnp.float32(1.0), DIFFUSE_SAMPLES, DIFFUSE_MIP_BIAS, False
    )


@jax.jit
def build_importance_map(cube_mips_0, cube_mips_rest):
    """GenerateEnvironmentImportanceMap(.Level): luminance of the sphere-mapped
    cube at 1024^2, then 2x2 SUM pyramid down to 1x1."""
    cube_mips = [cube_mips_0] + list(cube_mips_rest)
    s = IMPORTANCE_RESOLUTION
    uv = (jnp.arange(s, dtype=jnp.float32) + 0.5) / s
    ux, vy = jnp.meshgrid(uv, uv, indexing="xy")
    square = uv_to_unit_square(jnp.stack([ux, vy], -1))
    d = square_to_sphere(square)
    input_width = cube_mips[0].shape[1]
    # GenerateEnvironmentImportanceMap.cs.hlsl:35: log2((6*size)/res) with
    # UNSIGNED INTEGER division before the log2 — at cube 256 the reference
    # reads 1536/1024 = 1 -> mip 0 (sharp), not log2(1.5) = 0.585.
    ratio = (6 * input_width) // s
    mip = jnp.clip(
        jnp.log2(jnp.float32(max(ratio, 1e-30))), 0.0, len(cube_mips) - 1
    )
    color = sample_cube(cube_mips, d, jnp.full((s, s), mip))
    lum = luminance(color)
    mips = [lum]
    cur = lum
    while cur.shape[0] > 1:
        cur = cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        mips.append(cur)
    return mips


def build_environment(
    equirect: np.ndarray, cube_size: int = None, on_cpu: bool = True
) -> EnvMaps:
    """Full environment build (EnvironmentMap::CreateEnvironmentMap port).

    This is a LOAD-TIME precompute (the reference builds once on the first
    frame after a drop, Renderer.cpp:304-311). By default it runs on the CPU
    backend and the resulting maps are device_put to the default device for
    rendering; whether building on the card is faster is not yet measured.
    """
    import jax

    def _build():
        eq = jnp.asarray(equirect, jnp.float32)
        if cube_size is None:
            w = eq.shape[1]
            cs = int(max(2 ** int(np.floor(np.log2(max(w // 8, 1)))), 64))
            cs = min(cs, 1024)
        else:
            cs = cube_size
        cube0 = build_cubemap(eq, cs)
        cube_mips = build_cube_mips(cube0)
        ggx = build_ggx_cube(cube_mips)
        diffuse = build_diffuse_cube(cube_mips)
        importance = build_importance_map(cube_mips[0], cube_mips[1:])
        quads = sampling.pack_importance_quads(importance)
        # Env radiance at each importance texel's center direction rides the
        # alias row: NEE needs no cube lookup for the sampled direction
        # (sub-texel deviation from the reference's bilinear cube sample at
        # the jittered direction — see docs/PARITY.md).
        # Slim 4-wide rows: env_sample re-fetches radiance from cube level 0
        # at the jittered direction (reference-exact), so texel-center
        # colors would be dead columns of a cache-miss-bound gather.
        alias_rows = jnp.asarray(
            sampling.build_alias_rows(np.asarray(importance[0]))
        )
        return EnvMaps(
            cube=cube_mips, ggx=ggx, diffuse=diffuse, importance=importance,
            equirect=eq, importance_quads=quads, alias_rows=alias_rows,
        )

    # Disk cache: the build is a pure function of (equirect, cube_size) and
    # costs minutes of CPU prefilter compute per process (GpuResources builds
    # once per app run too; we persist across processes). Bump _ENV_CACHE_V
    # when any build kernel changes.
    cache_file = None
    cache_dir = os.environ.get(
        "GLTF_ENV_CACHE",
        os.path.expanduser("~/.cache/gltf_renderer/env"),
    )
    if cache_dir.lower() not in ("0", "off", "none"):
        import hashlib

        eq_np = np.ascontiguousarray(np.asarray(equirect, np.float32))
        key = hashlib.sha1(
            eq_np.tobytes()
            + str((eq_np.shape, cube_size, _ENV_CACHE_V)).encode()
        ).hexdigest()
        cache_file = os.path.join(cache_dir, f"{key}.npz")
        if os.path.exists(cache_file):
            try:
                env = _load_env_npz(cache_file)
                return jax.device_put(env)
            except Exception:
                pass  # corrupt/stale -> rebuild

    try:
        cpu = jax.devices("cpu")[0]
        default = jax.devices()[0]
        run_cpu = on_cpu and cpu != default
    except RuntimeError:
        run_cpu = False
    if not run_cpu:
        env = _build()
    else:
        with jax.default_device(cpu):
            env = jax.tree.map(lambda x: np.asarray(x), _build())
    if cache_file is not None:
        try:
            _save_env_npz(cache_file, jax.tree.map(np.asarray, env))
        except Exception:
            pass
    return jax.device_put(env)


_ENV_CACHE_V = 3  # bump when prefilter/importance/alias construction changes
# (v2: importance source mip uses the reference's integer division)


def _save_env_npz(path, env: EnvMaps) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {}
    for field in ("cube", "ggx", "importance", "importance_quads"):
        seq = getattr(env, field)
        for i, a in enumerate([] if seq is None else seq):
            arrays[f"{field}_{i}"] = np.asarray(a)
    arrays["diffuse"] = np.asarray(env.diffuse)
    arrays["equirect"] = np.asarray(env.equirect)
    arrays["alias_rows"] = np.asarray(env.alias_rows)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def _load_env_npz(path) -> EnvMaps:
    z = np.load(path)
    def lst(field):
        out = []
        i = 0
        while f"{field}_{i}" in z:
            out.append(z[f"{field}_{i}"])
            i += 1
        return out
    return EnvMaps(
        cube=lst("cube"), ggx=lst("ggx"), diffuse=z["diffuse"],
        importance=lst("importance"), equirect=z["equirect"],
        importance_quads=lst("importance_quads"), alias_rows=z["alias_rows"],
    )


# ---------------------------------------------------------------------------
# PT hooks (PathTracer.lib.hlsl:688-710)
# ---------------------------------------------------------------------------

def env_radiance(env: EnvMaps, direction):
    """Miss-shader env lookup: cube level 0 (Miss:1040-1042)."""
    return sample_cube_level(env.cube[0], direction,
                             quad=getattr(env, "cube0_quad", None))


def env_sample(env: EnvMaps, u2):
    """SampleEnvironmentMap (:688-703). Returns (direction, radiance, pdf_sa).

    Fast path: O(1) alias-table texel pick (one gather) — same distribution
    and pdf as the reference's hierarchical descent, which costs one gather
    per mip level. u2 may carry 4 uniform components; the descent paths use
    the first 2 (exactly the reference's consumption), the alias path all 4.
    """
    if env.alias_rows is not None and u2.shape[-1] >= 4:
        size = env.importance[0].shape[0]
        uv, pdf, _texel_color = sampling.sample_importance_alias(
            env.alias_rows, size, env.importance[-1][0, 0], u2
        )
        direction = square_to_sphere(uv_to_unit_square(uv))
        # Radiance is the BILINEAR cube fetch at the jittered direction —
        # exactly the reference's environment_map.SampleLevel(dir, 0)
        # (PathTracer.lib.hlsl:700) and identical to the descent path; the
        # alias row's texel-center color is only a fallback for tables
        # built without a cube map.
        color = sample_cube_level(env.cube[0], direction,
                                  quad=getattr(env, "cube0_quad", None))
        return direction, color, pdf / (4.0 * PI)
    if env.importance_quads:
        uv, pdf = sampling.sample_importance_map_quads(
            env.importance_quads, env.importance[-1][0, 0], u2
        )
    else:
        uv, pdf = sampling.sample_importance_map(env.importance, u2)
    direction = square_to_sphere(uv_to_unit_square(uv))
    pdf = pdf / (4.0 * PI)
    color = sample_cube_level(env.cube[0], direction,
                              quad=getattr(env, "cube0_quad", None))
    return direction, color, pdf


def env_pdf(env: EnvMaps, direction):
    """EnvironmentMapPdf (:705-710)."""
    uv = unit_square_to_uv(sphere_to_square(direction))
    return sampling.importance_map_pdf(
        env.importance, uv, alias_rows=env.alias_rows
    ) / (4.0 * PI)
