"""Bindless-style texture sampling from the shared atlas.

The equivalent of Material.hlsli SampleTexture:90-96 (SampleLevel 0, bindless
SRV + sampler heap): per-sample texture ids index the TextureTable; wrap modes
are applied per texel *before* the atlas gather (exact — no bleeding), sRGB
decode happens per texel before bilinear filtering (matches hardware sRGB
views, Gltf.cpp:1048-1078).
"""

from __future__ import annotations

import jax.numpy as jnp

from gltf_renderer.scene.types import TextureTable, WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT
from gltf_renderer.utils.math import decode_srgb


def decode_atlas_linear(tex: TextureTable) -> TextureTable:
    """Pre-decode the u8 sRGB atlas to a flat (AH*AW, 4) f16 LINEAR atlas.

    Host-side (numpy), once per scene: per-texture rects whose srgb flag is
    set get their RGB channels decoded; alpha and linear textures are
    straight u8/255. f16 keeps full u8-decode precision (10-bit mantissa vs
    the 8-bit source) at half the gather bytes of f32.
    """
    import numpy as np

    atlas = np.asarray(tex.atlas)
    if atlas.size == 0:
        return tex._replace(atlas_linear=np.zeros((0, 4), np.float16))
    lin = atlas.astype(np.float32) / 255.0
    xs = np.asarray(tex.x)
    ys = np.asarray(tex.y)
    ws = np.asarray(tex.width)
    hs = np.asarray(tex.height)
    srgb = np.asarray(tex.srgb)
    a = 0.055

    def dec(c):
        return np.where(c <= 0.04045, c / 12.92, ((c + a) / (1 + a)) ** 2.4)

    for i in np.nonzero(srgb == 1)[0]:
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        lin[y : y + h, x : x + w, :3] = dec(lin[y : y + h, x : x + w, :3])
    return tex._replace(
        atlas_linear=lin.reshape(-1, atlas.shape[-1]).astype(np.float16)
    )


QUAD_ATLAS_MAX_TEXELS = 32 * 1024 * 1024  # 1 GB of f16 quad rows


def build_atlas_quad(tex: TextureTable) -> TextureTable:
    """Bake each linear-atlas texel's 2x2 bilinear neighborhood into one
    (AH*AW, 16) f16 row: [c00, c10, c01, c11] with the +1 neighbors wrapped
    under the OWNING texture's wrap mode in ITS rect (host numpy, once per
    scene).

    Sampling then needs ONE row gather per (slot, ray) instead of four
    (sample_slots_fused); exact for REPEAT (seam texel baked) and CLAMP
    (sample-time wrap makes both corners collapse onto the edge texel, and
    the corner-select in sample_slots_fused picks the center). MIRROR flips
    traversal direction on odd replicas (needs -1 neighbors): scenes with any
    mirror-wrapped texture keep atlas_quad=None and take the 4-corner path.
    """
    import numpy as np

    from gltf_renderer.scene.types import WRAP_MIRROR

    if tex.atlas_linear is None:
        return tex
    lin = np.asarray(tex.atlas_linear)
    if lin.size == 0:
        return tex
    ah, aw = np.asarray(tex.atlas).shape[0], np.asarray(tex.atlas).shape[1]
    if ah * aw > QUAD_ATLAS_MAX_TEXELS:
        return tex
    if (np.asarray(tex.wrap_s) == WRAP_MIRROR).any() or (
        np.asarray(tex.wrap_t) == WRAP_MIRROR
    ).any():
        return tex
    img = lin.reshape(ah, aw, 4)
    # Default neighbors: atlas-clamped (only reachable for padding texels).
    xp = np.minimum(np.arange(aw) + 1, aw - 1)
    yp = np.minimum(np.arange(ah) + 1, ah - 1)
    q = np.concatenate(
        [img, img[:, xp], img[yp], img[yp][:, xp]], axis=-1
    )  # (AH, AW, 16)
    xs, ys = np.asarray(tex.x), np.asarray(tex.y)
    ws, hs = np.asarray(tex.width), np.asarray(tex.height)
    for i in range(len(xs)):
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        if w <= 0 or h <= 0:
            continue
        sub = img[y : y + h, x : x + w]
        # Repeat-local +1 (clamp correctness comes from sample-time wrap
        # collapsing the corner onto the same texel -> center selected).
        lxp = (np.arange(w) + 1) % w
        lyp = (np.arange(h) + 1) % h
        q[y : y + h, x : x + w] = np.concatenate(
            [sub, sub[:, lxp], sub[lyp], sub[lyp][:, lxp]], axis=-1
        )
    return tex._replace(atlas_quad=q.reshape(-1, 16).astype(np.float16))


def build_atlas_mips(tex: TextureTable, quad: bool = False) -> TextureTable:
    """Bake every texture's full NPOT mip chain into one flat (M, 4) f16
    array + (T * MAXL, 4) addressing rows (host numpy, once per scene).

    Level 0 is each texture's linear rect (so mip sampling never touches the
    base atlas); deeper levels use the separable trapezoid/box filter of
    GenerateMipLevel.cs.hlsl (env.generate_mip_level — the reference compiles
    that shader for exactly this purpose but never dispatches it). Textures
    whose chain ends early repeat their last level so the row table is
    rectangular and sampling is branch-free.

    quad: also bake each mip texel's 2x2 bilinear neighborhood into a
    (M, 16) f16 mip_quad table (same scheme as build_atlas_quad: +1
    neighbors wrapped REPEAT-locally in the LEVEL rect; CLAMP exactness
    comes from sample-time corner-select; skipped when any texture uses
    MIRROR wrap or the pyramid is huge). Trilinear sampling then costs 2
    gather rows per (slot, ray) instead of 8.
    """
    import numpy as np

    if tex.atlas_linear is None:
        return tex

    def _axis_np(img, axis):
        """Numpy twin of env.generate_mip_level's per-axis filter (load-time
        host path: a jit per level per texture costs seconds of compiles)."""
        n_in = img.shape[axis]
        if n_in == 1:
            return img
        m = np.moveaxis(img, axis, 0)
        if n_in % 2 == 0:
            out = 0.5 * (m[0::2] + m[1::2])
        else:
            n_out = n_in // 2
            x = np.arange(n_out, dtype=np.float32).reshape(
                (n_out,) + (1,) * (m.ndim - 1))
            n = np.float32(n_out)
            s0 = m[0 : 2 * n_out : 2]
            s1 = m[1 : 2 * n_out + 1 : 2]
            s2 = m[(np.arange(n_out) * 2 + 2) % n_in]
            out = ((n - x) * s0 + n * s1 + (1.0 + x) * s2) / (2.0 * n + 1.0)
        return np.moveaxis(out, 0, axis)

    def generate_mip_level(img):
        return _axis_np(_axis_np(img, 0), 1)
    lin = np.asarray(tex.atlas_linear)
    if lin.size == 0:
        return tex
    ah, aw = np.asarray(tex.atlas).shape[0], np.asarray(tex.atlas).shape[1]
    img = lin.reshape(ah, aw, 4).astype(np.float32)
    xs, ys = np.asarray(tex.x), np.asarray(tex.y)
    ws, hs = np.asarray(tex.width), np.asarray(tex.height)
    t = len(xs)
    chains = []
    maxl = 1
    for i in range(t):
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        chain = [img[y : y + h, x : x + w]]
        while chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1:
            nxt = np.asarray(generate_mip_level(chain[-1]), np.float32)
            if nxt.shape == chain[-1].shape:
                break
            chain.append(nxt)
        chains.append(chain)
        maxl = max(maxl, len(chain))
    flat_parts = []
    rows = np.zeros((t, maxl, 4), np.float32)
    bases = np.zeros((t, maxl), np.int32)
    base = 0
    for i, chain in enumerate(chains):
        for l in range(maxl):
            lvl = chain[min(l, len(chain) - 1)]
            if l < len(chain):
                flat_parts.append(lvl.reshape(-1, 4))
                lvl_base = base
                base += lvl.shape[0] * lvl.shape[1]
            else:  # repeat the last stored level (no duplicate storage)
                lvl_base = bases[i, len(chain) - 1]
            bases[i, l] = lvl_base
            rows[i, l] = (0.0, lvl.shape[1], lvl.shape[0], 0.0)
    # flat_base rides BITCAST int32 (f32 integers lose exactness past 2^24
    # — a 4k texture plus change already exceeds 16.7M texels).
    rows[:, :, 0] = bases.view(np.float32)
    flat = (np.concatenate(flat_parts, 0) if flat_parts
            else np.zeros((0, 4), np.float32))
    mip_quad = None
    from gltf_renderer.scene.types import WRAP_MIRROR

    if (quad and flat.shape[0] and flat.shape[0] <= QUAD_ATLAS_MAX_TEXELS
            and not (np.asarray(tex.wrap_s) == WRAP_MIRROR).any()
            and not (np.asarray(tex.wrap_t) == WRAP_MIRROR).any()):
        quad_parts = []
        for chain in chains:
            for lvl in chain:  # stored levels only (repeats share storage)
                h_l, w_l = lvl.shape[0], lvl.shape[1]
                lxp = (np.arange(w_l) + 1) % w_l
                lyp = (np.arange(h_l) + 1) % h_l
                quad_parts.append(np.concatenate(
                    [lvl, lvl[:, lxp], lvl[lyp], lvl[lyp][:, lxp]], axis=-1
                ).reshape(-1, 16))
        mip_quad = np.concatenate(quad_parts, 0).astype(np.float16)
        assert mip_quad.shape[0] == flat.shape[0]
    return tex._replace(
        mip_flat=flat.astype(np.float16),
        mip_rows=rows.reshape(t * maxl, 4),
        mip_quad=mip_quad,
    )


def transform_uv(uv, rotation, offset, scale):
    """KHR_texture_transform (Material.hlsli TransformUv:68-88):
    uv' = translate(offset) * rot(rotation) * scale applied to (u, v, 1)."""
    su = uv[..., 0] * scale[..., 0]
    sv = uv[..., 1] * scale[..., 1]
    c = jnp.cos(rotation)
    s = jnp.sin(rotation)
    ru = c * su + s * sv
    rv = -s * su + c * sv
    return jnp.stack([ru + offset[..., 0], rv + offset[..., 1]], axis=-1)


def _wrap(coord, size, mode, modes=(WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR)):
    """Integer texel wrap. coord (R,), size (R,), mode (R,).

    `modes` (static) lists the wrap modes present among the scene's used
    textures (PTMeta.wrap_modes): only those variants are computed — the
    mirror path alone is two extra mods per coordinate per ray."""
    def rep():
        return jnp.mod(coord, size)

    def clam():
        return jnp.clip(coord, 0, size - 1)

    def mir():
        period = 2 * size
        m = jnp.mod(coord, period)
        return jnp.where(m >= size, period - 1 - m, m)

    variants = {WRAP_REPEAT: rep, WRAP_CLAMP: clam, WRAP_MIRROR: mir}
    present = [m for m in (WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR) if m in modes]
    if len(present) == 1:
        return variants[present[0]]()
    out = variants[present[-1]]()
    for m in reversed(present[:-1]):
        out = jnp.where(mode == m, variants[m](), out)
    return out


def sample_texture(tex: TextureTable, tex_id, uv, rotation=None, offset=None, scale=None):
    """Sample level 0 with bilinear (or per-texture nearest) filtering.

    tex_id: (R,) int32 (-1 = absent -> returns 1.0 white).
    uv: (R, 2). Returns (R, 4) float32 linear-space RGBA.
    """
    if tex.x.shape[0] == 0:  # textureless scene — every slot absent
        return jnp.ones(uv.shape[:-1] + (4,), jnp.float32)

    if rotation is not None:
        uv = transform_uv(uv, rotation, offset, scale)

    present = tex_id >= 0
    tid = jnp.clip(tex_id, 0, max(tex.x.shape[0] - 1, 0))
    w = tex.width[tid]
    h = tex.height[tid]
    ox = tex.x[tid]
    oy = tex.y[tid]
    ws = tex.wrap_s[tid]
    wt = tex.wrap_t[tid]
    nearest = tex.nearest[tid]
    srgb = tex.srgb[tid]

    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    ah, aw = tex.atlas.shape[0], tex.atlas.shape[1]

    def fetch(xi, yi):
        xi = _wrap(xi, w, ws) + ox
        yi = _wrap(yi, h, wt) + oy
        xi = jnp.clip(xi, 0, aw - 1)
        yi = jnp.clip(yi, 0, ah - 1)
        texel = tex.atlas[yi, xi].astype(jnp.float32) / 255.0
        rgb = jnp.where(srgb[..., None] == 1, decode_srgb(texel[..., :3]), texel[..., :3])
        return jnp.concatenate([rgb, texel[..., 3:4]], axis=-1)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    txe = tx[..., None]
    tye = ty[..., None]
    bilinear = (c00 * (1 - txe) + c10 * txe) * (1 - tye) + (c01 * (1 - txe) + c11 * txe) * tye

    # Point sampling: texel = floor(uv * size).
    nx = jnp.clip(_wrap(jnp.floor(uv[..., 0] * w).astype(jnp.int32), w, ws) + ox, 0, aw - 1)
    ny = jnp.clip(_wrap(jnp.floor(uv[..., 1] * h).astype(jnp.int32), h, wt) + oy, 0, ah - 1)
    ptexel = tex.atlas[ny, nx].astype(jnp.float32) / 255.0
    prgb = jnp.where(srgb[..., None] == 1, decode_srgb(ptexel[..., :3]), ptexel[..., :3])
    point = jnp.concatenate([prgb, ptexel[..., 3:4]], axis=-1)

    out = jnp.where((nearest == 1)[..., None], point, bilinear)
    return jnp.where(present[..., None], out, jnp.ones_like(out))
