"""Monte-Carlo sampling routines (port of Source/Shaders/Sampling.hlsli).

Cosine hemisphere (tangentless trick), GGX NDF iso/anisotropic + visible-normal
sampling, and the hierarchical environment importance-map descent. All pure jnp,
vectorized over leading dims; `u` are uniform [0,1] samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gltf_renderer.utils.math import (
    PI,
    TAU,
    dot,
    normalize,
    saturate,
    square_to_disk,
    uv_to_unit_square,
)
from gltf_renderer.ops.bsdf import ggx_d, ggx_anisotropic_d


def sample_hemisphere(u):
    """Uniform hemisphere. Sampling.hlsli:7-14."""
    sin_t = jnp.sqrt(jnp.maximum(1.0 - u[..., 1] ** 2, 0.0))
    return jnp.stack(
        [sin_t * jnp.cos(u[..., 0] * TAU), sin_t * jnp.sin(u[..., 0] * TAU), u[..., 1]],
        axis=-1,
    )


def sample_cosine_hemisphere_local(u):
    """Cosine hemisphere via concentric disk, local (+z) frame. Sampling.hlsli:16-22."""
    d = square_to_disk(uv_to_unit_square(u))
    z = jnp.sqrt(jnp.maximum(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, 0.0))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def sample_cosine_hemisphere(n, u):
    """Tangentless cosine-weighted sample about n. Sampling.hlsli:26-33."""
    theta = TAU * u[..., 0]
    y = 2.0 * u[..., 1] - 1.0
    s = jnp.sqrt(jnp.maximum(1.0 - y * y, 0.0))
    sphere = jnp.stack([s * jnp.cos(theta), s * jnp.sin(theta), y], axis=-1)
    return normalize(n + sphere)


def cosine_hemisphere_pdf(n, v):
    """Sampling.hlsli:35-38."""
    return saturate(dot(n, v, keepdims=False) / PI)


def sample_ggx_normal(a, u):
    """GGX NDF-proportional half-vector in local frame. Sampling.hlsli:41-52."""
    a = jnp.asarray(a)
    phi = TAU * u[..., 0]
    u2 = u[..., 1]
    cos_t = jnp.sqrt(jnp.maximum((1.0 - u2) / (1.0 + (a * a - 1.0) * u2), 0.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def ggx_normal_pdf(a, n, h):
    """pdf of sample_ggx_normal about world normal n. Sampling.hlsli:54-58."""
    n_dot_h = dot(n, h, keepdims=False)
    return ggx_d(a, n_dot_h) * n_dot_h


def sample_ggx_anisotropic_normal(a, u):
    """Stretched cosine-hemisphere anisotropic GGX NDF sample. Sampling.hlsli:60-65.

    a: (..., 2) roughness^2 along (tangent, bitangent).
    """
    h = sample_cosine_hemisphere_local(u)
    h = jnp.concatenate([h[..., 0:2] * a, h[..., 2:3]], axis=-1)
    return normalize(h)


def ggx_anisotropic_normal_pdf(a, h_local):
    """Sampling.hlsli:67-70."""
    return ggx_anisotropic_d(a, h_local) * h_local[..., 2]


def sample_ggx_visible_normal(a, v_local, u):
    """Visible-normal sampling with spherical caps (arXiv 2306.05044).

    Sampling.hlsli:97-115. a: (...,2); v_local in the surface frame.
    """
    phi = TAU * u[..., 0]
    vz = v_local[..., 2]
    z = (1.0 - u[..., 1]) * (1.0 + vz) - vz
    sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    c = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), z], axis=-1)
    hn = c + v_local
    h = jnp.concatenate(
        [a * hn[..., 0:2], jnp.maximum(hn[..., 2:3], 0.0)], axis=-1
    )
    return normalize(h)


def pack_importance_quads(mips):
    """Host/device: quad-pack each mip for one-gather descent steps.

    quads[i] has shape (S_i/2, S_i/2, 4) = [UL, UR, LL, LR] of mips[i] — the
    2x2 block the hierarchical descent reads at level i (Sampling.hlsli:129).
    """
    quads = []
    for m in mips[:-1]:
        if m.shape[0] < 2:
            break
        quads.append(
            jnp.stack(
                [m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2]], axis=-1
            )
        )
    return quads


def sample_importance_map_quads(quads, total, u):
    """Hierarchical descent with ONE row gather per level.

    quads: list from pack_importance_quads, coarse..fine is quads[-1]..[0]?
    No — quads[i] corresponds to mips[i]; descent runs i = len(quads)-1 .. 0.
    total: mips[-1][0,0] scalar sum. Returns (uv, pdf) like
    sample_importance_map.
    """
    ux = u[..., 0]
    uy = u[..., 1]
    px = jnp.zeros(ux.shape, jnp.int32)
    py = jnp.zeros(ux.shape, jnp.int32)
    size = quads[0].shape[0] * 2
    last_quad = None
    last_kx = None
    last_ky = None
    for level in range(len(quads) - 1, -1, -1):
        q = quads[level]  # (S/2, S/2, 4); pixel (px, py) of mip level+? —
        # at this step the current (px, py) addresses mip[level+1] == quad grid.
        row = q[py, px]
        ul, ur, ll, lr = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        left = ul + ll
        right = ur + lr
        tot = jnp.maximum(left + right, 1e-30)
        prob_left = left / tot
        go_left = ux < prob_left
        ux = jnp.where(
            go_left,
            ux / jnp.maximum(prob_left, 1e-30),
            (ux - prob_left) / jnp.maximum(1.0 - prob_left, 1e-30),
        )
        top = jnp.where(go_left, ul, ur)
        col = jnp.where(go_left, left, right)
        prob_upper = top / jnp.maximum(col, 1e-30)
        go_up = uy < prob_upper
        uy = jnp.where(
            go_up,
            uy / jnp.maximum(prob_upper, 1e-30),
            (uy - prob_upper) / jnp.maximum(1.0 - prob_upper, 1e-30),
        )
        kx = jnp.where(go_left, 0, 1)
        ky = jnp.where(go_up, 0, 1)
        last_quad, last_kx, last_ky = row, kx, ky
        px = px * 2 + kx
        py = py * 2 + ky
    # Final texel value selected from the last quad row — no extra gather.
    value = jnp.where(
        last_ky == 0,
        jnp.where(last_kx == 0, last_quad[..., 0], last_quad[..., 1]),
        jnp.where(last_kx == 0, last_quad[..., 2], last_quad[..., 3]),
    )
    pdf = float(size) * float(size) * value / jnp.maximum(total, 1e-30)
    uv = jnp.stack(
        [(px.astype(jnp.float32) + ux) / size, (py.astype(jnp.float32) + uy) / size],
        axis=-1,
    )
    return uv, pdf


def build_alias_rows(importance_map, texel_rgb=None) -> "np.ndarray":
    """Walker/Vose alias table over the luminance-sum map (host, load time).

    Replacement for the hierarchical descent's 10 dependent
    gathers (Sampling.hlsli:123-163): samples the SAME texel distribution
    (p_i = value_i / total) with ONE row gather. Rows are (S*S, 10) f32:
    [keep_threshold, alias_index (bitcast i32), value_self, value_alias,
     rgb_self(3), rgb_alias(3)] — value columns reproduce
    pdf = S^2 * value / total exactly as importance_map_pdf does, so MIS
    weights stay consistent, and the rgb columns (env radiance at the texel
    center, when given) let NEE skip the cube lookup for the sampled
    direction entirely.
    """
    import numpy as np

    w = np.asarray(importance_map, np.float64).reshape(-1)
    n = w.size
    total = float(w.sum())
    p = w / total if total > 0.0 else np.full(n, 1.0 / n)
    q = p * n
    alias = np.arange(n, dtype=np.int64)
    thresh = np.ones(n, np.float64)
    small = list(np.nonzero(q < 1.0)[0])
    large = list(np.nonzero(q >= 1.0)[0])
    while small and large:
        s = small.pop()
        l = large.pop()
        thresh[s] = q[s]
        alias[s] = l
        q[l] -= 1.0 - q[s]
        (small if q[l] < 1.0 else large).append(l)
    # Leftovers (numerical slack) keep themselves with probability 1.
    vals = np.asarray(importance_map, np.float32).reshape(-1)
    # Without texel colors the rows are 16 B instead of 40 B. Scenes with a
    # cube map never read the color columns (env_sample re-fetches radiance
    # bilinearly from cube level 0), yet the gather still paid for them:
    # the 1024^2 x 40 B table is cache-miss bound (profiled 3.8 GiB/s, 15%
    # of a PT step), so dead columns are real HBM traffic.
    rows = np.zeros((n, 10 if texel_rgb is not None else 4), np.float32)
    rows[:, 0] = thresh.astype(np.float32)
    rows[:, 1] = alias.astype(np.int32).view(np.float32)
    rows[:, 2] = vals
    rows[:, 3] = vals[alias]
    if texel_rgb is not None:
        rgb = np.asarray(texel_rgb, np.float32).reshape(n, 3)
        rows[:, 4:7] = rgb
        rows[:, 7:10] = rgb[alias]
    return rows


def sample_importance_alias(rows, size, total, u4):
    """O(1) alias sampling of the importance map: ONE row gather.

    u4: (R, 4) uniforms — bucket pick, alias branch, in-texel x, in-texel y
    (the reference generates 4 random components per step and the descent
    consumes only 2, Random.hlsli pcg4d; here all 4 are used). Returns
    (uv, pdf, rgb) in square measure, identical in distribution and pdf to
    sample_importance_map; rgb is the chosen texel's env radiance (zeros if
    the table was built without colors)."""
    n = size * size
    b = jnp.minimum((u4[..., 0] * n).astype(jnp.int32), n - 1)
    r = rows[b]
    # 0/1 branch mask as int/float arithmetic, not a bool select (a bool on
    # the gather fusion's output took a slow packed layout before the GPU
    # port; not yet measured on the H100).
    take_i = (u4[..., 1] >= r[..., 0]).astype(jnp.int32)
    take_f = take_i.astype(jnp.float32)
    alias_idx = jax.lax.bitcast_convert_type(r[..., 1], jnp.int32)
    texel = alias_idx * take_i + b * (1 - take_i)
    value = r[..., 3] * take_f + r[..., 2] * (1.0 - take_f)
    if r.shape[-1] >= 10:
        tf = take_f[..., None]
        rgb = r[..., 7:10] * tf + r[..., 4:7] * (1.0 - tf)
    else:  # slim 4-wide table (no baked colors — caller fetches the cube)
        rgb = jnp.zeros(take_f.shape + (3,), r.dtype)
    px = (texel % size).astype(jnp.float32)
    py = (texel // size).astype(jnp.float32)
    uv = jnp.stack(
        [(px + u4[..., 2]) / size, (py + u4[..., 3]) / size], axis=-1
    )
    pdf = float(size) * float(size) * value / jnp.maximum(total, 1e-30)
    return uv, pdf, rgb


def sample_importance_map(mips, u):
    """Hierarchical 2x2 descent over a luminance-sum mip pyramid.

    Port of Sampling.hlsli SampleImportanceMap:123-163. `mips` is a list of
    arrays, mips[0] the full (S, S) map, mips[-1] the (1, 1) total. Each mip is
    the 2x2 *sum* of the previous (GenerateEnvironmentImportanceMapLevel).

    The HLSL indexes textures as [x, y] (column, row); here each mip is stored
    as mips[level][y, x]. Returns (uv, pdf) with pdf in square measure.
    """
    n_mips = len(mips)
    size = mips[0].shape[0]
    ux = u[..., 0]
    uy = u[..., 1]
    px = jnp.zeros(ux.shape, jnp.int32)
    py = jnp.zeros(ux.shape, jnp.int32)
    for level in range(n_mips - 2, -1, -1):
        m = mips[level]
        px = px * 2
        py = py * 2
        ul = m[py, px]
        ur = m[py, px + 1]
        ll = m[py + 1, px]
        lr = m[py + 1, px + 1]
        left = ul + ll
        right = ur + lr
        total = jnp.maximum(left + right, 1e-30)
        prob_left = left / total
        go_left = ux < prob_left
        ux = jnp.where(
            go_left,
            ux / jnp.maximum(prob_left, 1e-30),
            (ux - prob_left) / jnp.maximum(1.0 - prob_left, 1e-30),
        )
        px = jnp.where(go_left, px, px + 1)
        top = jnp.where(go_left, ul, ur)
        col = jnp.where(go_left, left, right)
        prob_upper = top / jnp.maximum(col, 1e-30)
        go_up = uy < prob_upper
        uy = jnp.where(
            go_up,
            uy / jnp.maximum(prob_upper, 1e-30),
            (uy - prob_upper) / jnp.maximum(1.0 - prob_upper, 1e-30),
        )
        py = jnp.where(go_up, py, py + 1)
    total_sum = mips[-1][0, 0]
    pdf = float(size) * float(size) * mips[0][py, px] / jnp.maximum(total_sum, 1e-30)
    uv = jnp.stack(
        [(px.astype(jnp.float32) + ux) / size, (py.astype(jnp.float32) + uy) / size],
        axis=-1,
    )
    return uv, pdf


def importance_map_pdf(mips, uv, alias_rows=None):
    """pdf query for a given uv. Sampling.hlsli ImportanceMapPdf:165-174.

    When alias_rows is given, the texel value comes from its column 2 (the
    texel's own luminance sum, bit-identical to mips[0]) as a ROW gather
    (chosen over a 1-D gather from the (S, S) map before the GPU port)."""
    size = mips[0].shape[0]
    total_sum = jnp.maximum(mips[-1][0, 0], 1e-30)
    # UVToPixel (Common.hlsli:12-15): (int2)(floor(uv * res) - .5). NOTE the
    # quirk: for integer f = floor(uv*res) >= 1 this yields f - 1 (f - 0.5
    # truncates DOWN), i.e. the pdf lookup is offset one texel low on both
    # axes vs a plain floor. Replicated exactly — "simplifying" this to
    # floor(uv*size) would silently change every env MIS weight vs the
    # reference.
    p = jnp.floor(uv * size) - 0.5
    p = jnp.clip(p.astype(jnp.int32), 0, size - 1)
    if alias_rows is not None:
        # Gather the FULL row, then slice column 2: `rows[idx, 2]` lowers to
        # a 1-element gather, which was far slower before the GPU port (not
        # yet measured on the H100).
        value = alias_rows[p[..., 1] * size + p[..., 0]][..., 2]
    else:
        value = mips[0][p[..., 1], p[..., 0]]
    return float(size) * float(size) * value / total_sum
