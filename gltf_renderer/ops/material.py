"""Surface property assembly: material table + textures -> SurfaceProperties.

Port of GetSurfaceProperties (PathTracer.lib.hlsl:318-381) and the per-property
texture getters (Material.hlsli:98-262), vectorized over hits.

Hot path: ONE (M, 144) material-row gather per hit (scene/types.pack_material_rows)
+ one (T, 9) texture-metadata row gather and 4 atlas texel gathers per USED
slot. `used_slots` (static, from PTMeta) skips texture slots no material in the
scene references — the analogue of shader permutations.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gltf_renderer.ops.bsdf import MINIMUM_ROUGHNESS, SurfaceProperties
from gltf_renderer.ops.texture import sample_texture
from gltf_renderer.scene import types as T
from gltf_renderer.utils.math import decode_srgb, dot, normalize, reflect, saturate
from gltf_renderer.scene.types import (
    ALPHA_MODE_BLEND,
    ALPHA_MODE_MASK,
    MATERIAL_ROW_FACTORS,
    MATERIAL_SLOT_STRIDE,
)

ALL_SLOTS = tuple(range(T.N_TEX_SLOTS))


def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


COMPACT_SLOT_STRIDE = 16  # 7 address cols + 9 joined texture-metadata cols


def _slot_base(slot, used_slots, compact):
    """Column of slot `slot` in a material row.

    Full rows store all 15 slots x 7 address cols; PT-scene rows are
    compacted to the scene's static used_slots (sorted) AND carry the 9
    texture-metadata cols joined in per slot (stride 16) — the per-hit
    metadata gather disappears."""
    if compact:
        order = tuple(sorted(used_slots))
        return MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * order.index(slot)
    return MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * slot


def compact_material_rows(rows, used_slots, tex_rows=None):
    """(M, 144) full rows -> (M, 34 + 16k padded to 8) rows with only the
    scene's used slots, in sorted-slot order, each slot's 7 address cols
    followed by the 9 metadata cols of the texture it points at (joined by
    tex id at scene build — host, load time)."""
    import numpy as _np

    rows = _np.asarray(rows)
    order = tuple(sorted(used_slots))
    width = MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * len(order)
    padded = -(-max(width, 1) // 8) * 8
    out = _np.zeros((rows.shape[0], padded), _np.float32)
    out[:, :MATERIAL_ROW_FACTORS] = rows[:, :MATERIAL_ROW_FACTORS]
    tex = None if tex_rows is None else _np.asarray(tex_rows)
    for j, s in enumerate(order):
        src = MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * s
        dst = MATERIAL_ROW_FACTORS + COMPACT_SLOT_STRIDE * j
        out[:, dst : dst + MATERIAL_SLOT_STRIDE] = rows[:, src : src + MATERIAL_SLOT_STRIDE]
        if tex is not None and tex.shape[0]:
            tid = rows[:, src].view(_np.int32)
            meta = tex[_np.clip(tid, 0, tex.shape[0] - 1), :9]
            meta[tid < 0] = 0.0
            out[:, dst + MATERIAL_SLOT_STRIDE : dst + MATERIAL_SLOT_STRIDE + 9] = meta
    return out


def sample_slots_fused(row, textures, slots, uv0, uv1, used_slots=ALL_SLOTS,
                       compact=False, mip_base=None, identity_uv=False,
                       wrap_modes=(0, 1, 2), any_nearest=True):
    """Sample several texture slots with TWO gathers total.

    Replaces per-slot sampling (1 metadata + 4 texel gathers per slot): all
    slots share one (k*R, 9) metadata row gather and one (4*k*R, 4) atlas
    texel gather: ~5x fewer gather ops per used slot (a per-gather cost
    model from before the GPU port; not yet measured on the H100).

    mip_base: optional (R,) f32 log2 of the sampling footprint in NORMALIZED
    uv units (pre texture-transform). When given and the scene carries a mip
    pyramid (build_atlas_mips), slots sample TRILINEARLY at level
    mip_base + 0.5*log2(w*h) + 0.5*log2(|sx*sy|) — the raster backend's
    Forward.ps.hlsl mip-sampling analogue. None = SampleLevel 0 (the path
    tracer's Material.hlsli:95 parity quirk), bit-identical to before.

    Returns {slot: (rgba (R, 4), present (R,) exactly-0/1 f32)}. The
    present mask is float, not bool: it crosses the fusion boundary to
    every consumer (a 1-D bool output took a slow packed layout before the
    GPU port). Consumers blend arithmetically (bit-identical to select for
    finite operands).
    """
    from gltf_renderer.ops.texture import transform_uv
    from gltf_renderer.scene.types import WRAP_CLAMP, WRAP_REPEAT

    k = len(slots)
    ones = jnp.ones(uv0.shape[:-1] + (4,), jnp.float32)
    absent = jnp.zeros(uv0.shape[:-1], bool)
    if k == 0:
        return {}
    if textures.rows is None or textures.rows.shape[0] == 0:
        return {s: (ones, absent) for s in slots}

    bases = [_slot_base(s, used_slots, compact) for s in slots]
    tid = jnp.stack([_bits(row[:, b]) for b in bases])            # (k, R)
    uvset = jnp.stack([_bits(row[:, b + 1]) for b in bases])
    rot = jnp.stack([row[:, b + 2] for b in bases])
    off = jnp.stack([row[:, b + 3 : b + 5] for b in bases])       # (k, R, 2)
    scl = jnp.stack([row[:, b + 5 : b + 7] for b in bases])

    # Float-mask blend, NOT jnp.where: cross-fusion pred tensors took a
    # slow packed layout before the GPU port (not yet measured on the
    # H100). Multiplying by an exactly-0/1 float mask is bit-identical for
    # finite uv (1*x+0*y==x).
    uvsel = (uvset == 1).astype(jnp.float32)[..., None]
    uv = uv1[None] * uvsel + uv0[None] * (1.0 - uvsel)
    if not identity_uv:
        # Skipped when every used slot's KHR_texture_transform is identity
        # (PTMeta.identity_uv): saves the per-ray cos/sin. Identity
        # transform_uv returns uv exactly.
        uv = transform_uv(uv, rot, off, scl)
    present = tid >= 0
    presf = present.astype(jnp.float32)[..., None]  # 0/1 blend mask (see uv)

    if compact:
        # Compact rows carry the 9 texture-metadata cols joined in per slot
        # (compact_material_rows) — zero extra gathers here.
        trow = jnp.stack(
            [row[:, b + MATERIAL_SLOT_STRIDE : b + MATERIAL_SLOT_STRIDE + 9]
             for b in bases]
        )                                                         # (k, R, 9)
    else:
        n_tex = textures.rows.shape[0]
        tid_c = jnp.clip(tid, 0, n_tex - 1)
        trow = textures.rows[tid_c.reshape(-1)].reshape(tid.shape + (-1,))  # 1 gather
    ox = trow[..., 0].astype(jnp.int32)
    oy = trow[..., 1].astype(jnp.int32)
    w = trow[..., 2].astype(jnp.int32)
    h = trow[..., 3].astype(jnp.int32)
    ws = trow[..., 4].astype(jnp.int32)
    wt = trow[..., 5].astype(jnp.int32)
    nearest = trow[..., 6].astype(jnp.int32)
    srgb = trow[..., 7].astype(jnp.int32)

    from gltf_renderer.ops.texture import _wrap  # one wrap impl

    def wrap(coord, size, mode):
        return _wrap(coord, size, mode, modes=wrap_modes)

    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    fx = uv[..., 0] * wf - 0.5
    fy = uv[..., 1] * hf - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    # Nearest filter folds into the corner weights (no extra gather);
    # statically skipped when no used texture is point-sampled
    # (PTMeta.any_nearest).
    if any_nearest:
        nx = jnp.floor(uv[..., 0] * wf).astype(jnp.int32)
        ny = jnp.floor(uv[..., 1] * hf).astype(jnp.int32)
        is_near = nearest == 1
        x0 = jnp.where(is_near, nx, x0)
        y0 = jnp.where(is_near, ny, y0)
        tx = jnp.where(is_near[..., None], 0.0, tx)
        ty = jnp.where(is_near[..., None], 0.0, ty)

    if mip_base is not None and getattr(textures, "mip_flat", None) is not None:
        # Trilinear mip path: per-slot level, TWO (k*R)-row mip-metadata
        # gathers + ONE (8*k*R)-row texel gather from the flat pyramid.
        n_tex = textures.x.shape[0]
        maxl = textures.mip_rows.shape[0] // max(n_tex, 1)
        area = jnp.maximum(wf * hf, 1.0)
        suv = jnp.maximum(jnp.abs(scl[..., 0] * scl[..., 1]), 1e-12)
        lvl = mip_base[None] + 0.5 * jnp.log2(area) + 0.5 * jnp.log2(suv)
        lvl = jnp.clip(lvl, 0.0, maxl - 1.0)
        if any_nearest:
            lvl = jnp.where(nearest == 1, 0.0, lvl)
        l0 = jnp.floor(lvl).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, maxl - 1)
        lfrac = (lvl - l0.astype(jnp.float32))[..., None]
        tid_c = jnp.clip(tid, 0, max(n_tex - 1, 0))

        # ONE fused (2, ...) mip-metadata gather for both trilinear levels
        # instead of two separate R-row gathers.
        meta_ids = jnp.stack([tid_c * maxl + l0, tid_c * maxl + l1])
        mrow2 = textures.mip_rows[meta_ids.reshape(-1)].reshape(
            meta_ids.shape + (-1,)
        )

        def level_corners(li, mrow):
            base_i = _bits(mrow[..., 0])  # bitcast int32 (exact past 2^24)
            lw = mrow[..., 1].astype(jnp.int32)
            lh = mrow[..., 2].astype(jnp.int32)
            lwf = mrow[..., 1]
            lhf = mrow[..., 2]
            fxl = uv[..., 0] * lwf - 0.5
            fyl = uv[..., 1] * lhf - 0.5
            x0l = jnp.floor(fxl).astype(jnp.int32)
            y0l = jnp.floor(fyl).astype(jnp.int32)
            txl = (fxl - x0l)[..., None]
            tyl = (fyl - y0l)[..., None]
            if any_nearest:
                x0l = jnp.where(
                    is_near, jnp.floor(uv[..., 0] * lwf).astype(jnp.int32), x0l)
                y0l = jnp.where(
                    is_near, jnp.floor(uv[..., 1] * lhf).astype(jnp.int32), y0l)
                txl = jnp.where(is_near[..., None], 0.0, txl)
                tyl = jnp.where(is_near[..., None], 0.0, tyl)

            def fi(xi, yi):
                xi = wrap(xi, lw, ws)
                yi = wrap(yi, lh, wt)
                return base_i + yi * lw + xi

            ids = jnp.stack([fi(x0l, y0l), fi(x0l + 1, y0l),
                             fi(x0l, y0l + 1), fi(x0l + 1, y0l + 1)])
            return ids, txl, tyl

        if getattr(textures, "mip_quad", None) is not None:
            # Quad-packed pyramid (GLTF_QUADMIPS): the 2x2 neighborhood
            # is baked per mip texel, so trilinear costs TWO gather rows per
            # (slot, ray) instead of eight. Corner-select exactly as the
            # atlas_quad path: a wrapped +1 that collapses onto the same
            # texel (CLAMP edge / 1-wide level) takes the center channel.
            def level_quad(li, mrow):
                base_i = _bits(mrow[..., 0])
                lw = mrow[..., 1].astype(jnp.int32)
                lh = mrow[..., 2].astype(jnp.int32)
                lwf = mrow[..., 1]
                lhf = mrow[..., 2]
                fxl = uv[..., 0] * lwf - 0.5
                fyl = uv[..., 1] * lhf - 0.5
                x0l = jnp.floor(fxl).astype(jnp.int32)
                y0l = jnp.floor(fyl).astype(jnp.int32)
                txl = (fxl - x0l)[..., None]
                tyl = (fyl - y0l)[..., None]
                if any_nearest:
                    x0l = jnp.where(
                        is_near, jnp.floor(uv[..., 0] * lwf).astype(jnp.int32),
                        x0l)
                    y0l = jnp.where(
                        is_near, jnp.floor(uv[..., 1] * lhf).astype(jnp.int32),
                        y0l)
                    txl = jnp.where(is_near[..., None], 0.0, txl)
                    tyl = jnp.where(is_near[..., None], 0.0, tyl)
                w0x = wrap(x0l, lw, ws)
                w0y = wrap(y0l, lh, wt)
                # 0/1 float corner-select masks (pred-layout rule; see the
                # atlas_quad branch below).
                xpf = (wrap(x0l + 1, lw, ws) != w0x).astype(jnp.float32)[..., None]
                ypf = (wrap(y0l + 1, lh, wt) != w0y).astype(jnp.float32)[..., None]
                return base_i + w0y * lw + w0x, xpf, ypf, txl, tyl

            i0, xp0, yp0, tx0, ty0 = level_quad(l0, mrow2[0])
            i1, xp1, yp1, tx1, ty1 = level_quad(l1, mrow2[1])
            ids = jnp.stack([i0, i1])                             # (2, k, R)
            m = textures.mip_quad.shape[0]
            ids = jnp.clip(ids, 0, max(m - 1, 0))
            q = textures.mip_quad[ids.reshape(-1)].reshape(
                ids.shape + (-1,)
            ).astype(jnp.float32)                                 # 1 gather

            def bilq(qq, xpf, ypf, tx_, ty_):
                c00 = qq[..., 0:4]
                c10 = qq[..., 4:8] * xpf + c00 * (1.0 - xpf)
                c01 = qq[..., 8:12] * ypf + c00 * (1.0 - ypf)
                c11_x = qq[..., 12:16] * ypf + qq[..., 4:8] * (1.0 - ypf)
                c11 = c11_x * xpf + c01 * (1.0 - xpf)
                return (c00 * (1 - tx_) + c10 * tx_) * (1 - ty_) + (
                    c01 * (1 - tx_) + c11 * tx_) * ty_

            out = bilq(q[0], xp0, yp0, tx0, ty0) * (1 - lfrac) + bilq(
                q[1], xp1, yp1, tx1, ty1) * lfrac
            out = out * presf + (1.0 - presf)
            return {s: (out[i], presf[i, ..., 0]) for i, s in enumerate(slots)}

        ids0, tx0, ty0 = level_corners(l0, mrow2[0])
        ids1, tx1, ty1 = level_corners(l1, mrow2[1])
        ids = jnp.concatenate([ids0, ids1])                       # (8, k, R)
        m = textures.mip_flat.shape[0]
        ids = jnp.clip(ids, 0, max(m - 1, 0))
        texel = textures.mip_flat[ids.reshape(-1)].reshape(
            ids.shape + (-1,)
        ).astype(jnp.float32)                                     # 1 gather

        def bil(c, tx_, ty_):
            return (c[0] * (1 - tx_) + c[1] * tx_) * (1 - ty_) + (
                c[2] * (1 - tx_) + c[3] * tx_) * ty_

        out = bil(texel[0:4], tx0, ty0) * (1 - lfrac) + bil(
            texel[4:8], tx1, ty1) * lfrac
        out = out * presf + (1.0 - presf)
        return {s: (out[i], presf[i, ..., 0]) for i, s in enumerate(slots)}

    ah, aw = textures.atlas.shape[0], textures.atlas.shape[1]

    def flat_idx(xi, yi):
        xi = jnp.clip(wrap(xi, w, ws) + ox, 0, aw - 1)
        yi = jnp.clip(wrap(yi, h, wt) + oy, 0, ah - 1)
        return yi * aw + xi

    if textures.atlas_quad is not None:
        # Quad-packed atlas: the 2x2 neighborhood is baked per texel
        # (build_atlas_quad), so bilinear needs ONE (k*R)-row gather instead
        # of one (4*k*R)-row gather. Corner selection: if the wrapped +1
        # coordinate collapses onto the same texel (CLAMP edge), take the
        # center channel instead of the baked neighbor.
        w0x = wrap(x0, w, ws)
        w0y = wrap(y0, h, wt)
        # Exactly-0/1 float corner-select masks, blended arithmetically
        # (bool masks took a slow packed layout before the GPU port).
        # Blend == select bit-exactly for the finite texel values here.
        xpf = (wrap(x0 + 1, w, ws) != w0x).astype(jnp.float32)[..., None]
        ypf = (wrap(y0 + 1, h, wt) != w0y).astype(jnp.float32)[..., None]
        idx0 = (jnp.clip(w0y + oy, 0, ah - 1) * aw
                + jnp.clip(w0x + ox, 0, aw - 1))                  # (k, R)
        quad = textures.atlas_quad[idx0.reshape(-1)].reshape(
            idx0.shape + (-1,)
        ).astype(jnp.float32)                                     # (k, R, 16)
        c00 = quad[..., 0:4]
        c10 = quad[..., 4:8] * xpf + c00 * (1.0 - xpf)
        c01 = quad[..., 8:12] * ypf + c00 * (1.0 - ypf)
        c11_x = quad[..., 12:16] * ypf + quad[..., 4:8] * (1.0 - ypf)
        c11 = c11_x * xpf + c01 * (1.0 - xpf)
        out = (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (
            c01 * (1 - tx) + c11 * tx) * ty
        out = out * presf + (1.0 - presf)
        return {s: (out[i], presf[i, ..., 0]) for i, s in enumerate(slots)}

    idx = jnp.stack(
        [flat_idx(x0, y0), flat_idx(x0 + 1, y0),
         flat_idx(x0, y0 + 1), flat_idx(x0 + 1, y0 + 1)]
    )                                                             # (4, k, R)
    if textures.atlas_linear is not None:
        # Pre-decoded linear atlas (decode_atlas_linear): the gather IS the
        # decode — no sRGB pow over the 4*k*R fetched texels.
        flat = textures.atlas_linear
        texel = flat[idx.reshape(-1)].reshape(idx.shape + (-1,))  # 1 gather
        texel = texel.astype(jnp.float32)
    else:
        flat = textures.atlas.reshape(-1, textures.atlas.shape[-1])
        texel = flat[idx.reshape(-1)].reshape(idx.shape + (-1,))  # 1 gather
        texel = texel.astype(jnp.float32) / 255.0
        rgb = jnp.where(
            srgb[None, ..., None] == 1, decode_srgb(texel[..., :3]), texel[..., :3]
        )
        texel = jnp.concatenate([rgb, texel[..., 3:4]], axis=-1)
    c00, c10, c01, c11 = texel[0], texel[1], texel[2], texel[3]
    out = (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty
    out = out * presf + (1.0 - presf)
    return {s: (out[i], presf[i, ..., 0]) for i, s in enumerate(slots)}


def sample_texture_row(textures, tex_id, uv, rotation, offset, scale):
    """Atlas sample using the packed (T, 9) texture metadata rows.

    One metadata row gather + 4 texel gathers (bilinear) or 1 (nearest mix).
    """
    from gltf_renderer.ops.texture import transform_uv
    from gltf_renderer.scene.types import WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT

    if textures.rows is None or textures.rows.shape[0] == 0:
        return jnp.ones(uv.shape[:-1] + (4,), jnp.float32)

    uv = transform_uv(uv, rotation, offset, scale)
    present = tex_id >= 0
    tid = jnp.clip(tex_id, 0, textures.rows.shape[0] - 1)
    trow = textures.rows[tid]
    ox = trow[:, 0].astype(jnp.int32)
    oy = trow[:, 1].astype(jnp.int32)
    w = trow[:, 2].astype(jnp.int32)
    h = trow[:, 3].astype(jnp.int32)
    ws = trow[:, 4].astype(jnp.int32)
    wt = trow[:, 5].astype(jnp.int32)
    nearest = trow[:, 6].astype(jnp.int32)
    srgb = trow[:, 7].astype(jnp.int32)

    from gltf_renderer.ops.texture import _wrap as wrap  # one wrap impl

    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    fx = uv[..., 0] * wf - 0.5
    fy = uv[..., 1] * hf - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    ah, aw = textures.atlas.shape[0], textures.atlas.shape[1]

    # Nearest filter folds into the corner weights (avoids a 5th gather).
    nx = jnp.floor(uv[..., 0] * wf).astype(jnp.int32)
    ny = jnp.floor(uv[..., 1] * hf).astype(jnp.int32)
    is_near = (nearest == 1)
    x0 = jnp.where(is_near, nx, x0)
    y0 = jnp.where(is_near, ny, y0)
    tx = jnp.where(is_near[..., None], 0.0, tx)
    ty = jnp.where(is_near[..., None], 0.0, ty)

    def fetch(xi, yi):
        xi = jnp.clip(wrap(xi, w, ws) + ox, 0, aw - 1)
        yi = jnp.clip(wrap(yi, h, wt) + oy, 0, ah - 1)
        texel = textures.atlas[yi, xi].astype(jnp.float32) / 255.0
        rgb = jnp.where(srgb[..., None] == 1, decode_srgb(texel[..., :3]), texel[..., :3])
        return jnp.concatenate([rgb, texel[..., 3:4]], axis=-1)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    out = (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty
    return jnp.where(present[..., None], out, jnp.ones_like(out))


def _slot_from_row(row, slot, used_slots=ALL_SLOTS, compact=False):
    b = _slot_base(slot, used_slots, compact)
    tid = _bits(row[:, b])
    uvset = _bits(row[:, b + 1])
    rot = row[:, b + 2]
    off = row[:, b + 3 : b + 5]
    scl = row[:, b + 5 : b + 7]
    return tid, uvset, rot, off, scl


def slot_sample_row(row, textures, slot, uv0, uv1, used_slots=ALL_SLOTS,
                    compact=False, identity_uv=False, wrap_modes=(0, 1, 2),
                    any_nearest=True):
    """Sample one slot from packed rows. Static skip when the slot is unused
    by every material in the scene."""
    if slot not in used_slots:
        ones = jnp.ones(uv0.shape[:-1] + (4,), jnp.float32)
        return ones, jnp.zeros(uv0.shape[:-1], jnp.float32)
    out = sample_slots_fused(row, textures, (slot,), uv0, uv1, used_slots, compact,
                             identity_uv=identity_uv, wrap_modes=wrap_modes,
                             any_nearest=any_nearest)
    return out[slot]


def slot_sample(materials, textures, mat_id, slot, uv0, uv1):
    """Legacy unpacked-slot sampling (kept for tools/tests)."""
    tid = materials.tex_index[mat_id, slot]
    uvset = materials.tex_uvset[mat_id, slot]
    rot = materials.tex_rotation[mat_id, slot]
    off = materials.tex_offset[mat_id, slot]
    scl = materials.tex_scale[mat_id, slot]
    uv = jnp.where((uvset == 1)[..., None], uv1, uv0)
    rgba = sample_texture(textures, tid, uv, rot, off, scl)
    return rgba, tid >= 0


def get_base_color_row(row, textures, uv0, uv1, vertex_color, used_slots=ALL_SLOTS,
                       compact=False, identity_uv=False, wrap_modes=(0, 1, 2),
                       any_nearest=True):
    base = row[:, 0:4] * vertex_color
    rgba, _ = slot_sample_row(row, textures, T.TEX_ALBEDO, uv0, uv1, used_slots,
                              compact, identity_uv=identity_uv,
                              wrap_modes=wrap_modes, any_nearest=any_nearest)
    return base * rgba


def get_base_color(materials, textures, mat_id, uv0, uv1, vertex_color):
    """Material.hlsli GetBaseColor:98-106."""
    row = materials.rows[mat_id]
    return get_base_color_row(row, textures, uv0, uv1, vertex_color)


def get_alpha_row(row, base_color):
    """Material.hlsli GetAlpha:108-117 using the packed row."""
    mode = _bits(row[:, 33])
    cutoff = row[:, 10]
    a = base_color[..., 3]
    return jnp.where(
        mode == ALPHA_MODE_BLEND,
        a,
        jnp.where(mode == ALPHA_MODE_MASK, jnp.where(a < cutoff, 0.0, 1.0), 1.0),
    )


def get_alpha(materials, mat_id, base_color):
    """Material.hlsli GetAlpha:108-117."""
    mode = materials.alpha_mode[mat_id]
    cutoff = materials.alpha_cutoff[mat_id]
    a = base_color[..., 3]
    return jnp.where(
        mode == ALPHA_MODE_BLEND,
        a,
        jnp.where(mode == ALPHA_MODE_MASK, jnp.where(a < cutoff, 0.0, 1.0), 1.0),
    )


def _perturb_normal(sample_rgb, presf, scale, base_normal, t2w_t, t2w_b, t2w_n):
    """presf: exactly-0/1 f32 present mask (blend == select, pred-layout rule)."""
    nm = sample_rgb * 2.0 - 1.0
    nm = jnp.concatenate([nm[..., 0:2] * scale[..., None], nm[..., 2:3]], -1)
    n = nm[..., 0:1] * t2w_t + nm[..., 1:2] * t2w_b + nm[..., 2:3] * t2w_n
    n = normalize(n)
    m = presf[..., None]
    return n * m + base_normal * (1.0 - m)


def normal_adaptation(ng, ns, v):
    """Iray local shading-normal adaptation (PathTracer.lib.hlsl:304-316)."""
    r = reflect(-v, ns)
    r_dot_ng = dot(r, ng)
    adapted = normalize(v + normalize(r - r_dot_ng * ng))
    return jnp.where(r_dot_ng < 0.0, adapted, ns)


class SurfaceExtras(NamedTuple):
    emissive: jnp.ndarray   # (R, 3)
    occlusion: jnp.ndarray  # (R,)
    base_color: jnp.ndarray  # (R, 4)
    flags: jnp.ndarray      # (R,) material flags
    alpha_mode: jnp.ndarray  # (R,)
    alpha_cutoff: jnp.ndarray  # (R,)


def get_surface_properties(
    materials,
    textures,
    mat_id,
    uv0,
    uv1,
    vertex_color,
    normal,            # (R, 3) interpolated shading-basis normal (world)
    tangent,           # (R, 4) world tangent + winding
    bitangent,         # (R, 3)
    geometric_normal,  # (R, 3)
    view,              # (R, 3) unit, toward camera
    use_geometric_normals: bool = False,
    shading_normal_adaptation: bool = True,
    used_slots: Tuple[int, ...] = ALL_SLOTS,
    rows_compact: bool = False,
    mip_base=None,
    identity_uv: bool = False,
    wrap_modes: Tuple[int, ...] = (0, 1, 2),
    any_nearest: bool = True,
):
    """Returns (SurfaceProperties, SurfaceExtras).

    One material-row gather + ONE fused metadata gather + ONE fused atlas
    gather across every used texture slot (sample_slots_fused). mip_base:
    optional (R,) log2 uv footprint for trilinear mip sampling (raster).
    identity_uv / wrap_modes: static scene facts (PTMeta) that specialize
    away per-ray uv-transform and unused wrap variants."""
    row = materials.rows[mat_id]

    active = tuple(s for s in used_slots if s in ALL_SLOTS)
    tex = sample_slots_fused(row, textures, active, uv0, uv1, used_slots,
                             rows_compact, mip_base=mip_base,
                             identity_uv=identity_uv, wrap_modes=wrap_modes,
                             any_nearest=any_nearest)
    ones = jnp.ones(uv0.shape[:-1] + (4,), jnp.float32)
    no = jnp.zeros(uv0.shape[:-1], jnp.float32)  # absent slot: presf == 0

    def slot(s):
        return tex.get(s, (ones, no))

    base_color = row[:, 0:4] * vertex_color * slot(T.TEX_ALBEDO)[0]
    albedo = base_color[..., :3]
    alpha = get_alpha_row(row, base_color)

    # Shading normal (Material.hlsli GetShadingNormal:119-128).
    nrm_s, nrm_p = slot(T.TEX_NORMAL)
    shading_normal = _perturb_normal(
        nrm_s[..., :3], nrm_p, row[:, 12], normal,
        tangent[..., :3], bitangent, normal,
    )
    if shading_normal_adaptation:
        shading_normal = normal_adaptation(geometric_normal, shading_normal, view)

    # Metalness / roughness.
    mr_s, mr_p = slot(T.TEX_METALLIC_ROUGHNESS)
    metalness = row[:, 4] * mr_s[..., 2]
    roughness = row[:, 5] * mr_s[..., 1]
    rough2 = jnp.maximum(roughness * roughness, MINIMUM_ROUGHNESS)

    # Occlusion (Material.hlsli:142-150).
    occ_s, occ_p = slot(T.TEX_OCCLUSION)
    occlusion = (1.0 + row[:, 6] * (occ_s[..., 0] - 1.0)) * occ_p + (1.0 - occ_p)

    # Emissive.
    em_s, _ = slot(T.TEX_EMISSIVE)
    emissive = row[:, 7:10] * em_s[..., :3]

    ior = row[:, 11]

    sp_s, _ = slot(T.TEX_SPECULAR)
    specular_factor = row[:, 13] * sp_s[..., 3]
    spc_s, _ = slot(T.TEX_SPECULAR_COLOR)
    specular_color = row[:, 14:17] * spc_s[..., :3]

    cc_s, _ = slot(T.TEX_CLEARCOAT)
    clearcoat = row[:, 17] * cc_s[..., 0]
    ccr_s, _ = slot(T.TEX_CLEARCOAT_ROUGHNESS)
    clearcoat_roughness = row[:, 18] * ccr_s[..., 1]
    ccn_s, ccn_p = slot(T.TEX_CLEARCOAT_NORMAL)
    clearcoat_normal = _perturb_normal(
        ccn_s[..., :3], ccn_p, row[:, 19], normal,
        tangent[..., :3], bitangent, normal,
    )
    if shading_normal_adaptation:
        clearcoat_normal = normal_adaptation(geometric_normal, clearcoat_normal, view)

    # Anisotropy (Material.hlsli:245-262).
    an_s, an_p = slot(T.TEX_ANISOTROPY)
    an_m = an_p[..., None]
    an_tex = (
        jnp.concatenate([an_s[..., 0:2] * 2.0 - 1.0, an_s[..., 2:3]], -1) * an_m
        + jnp.broadcast_to(jnp.asarray([1.0, 0.0, 1.0]), an_s[..., :3].shape)
        * (1.0 - an_m)
    )
    a_rot = row[:, 21]
    ca, sa = jnp.cos(a_rot), jnp.sin(a_rot)
    adx = ca * an_tex[..., 0] - sa * an_tex[..., 1]
    ady = sa * an_tex[..., 0] + ca * an_tex[..., 1]
    a_dir = normalize(jnp.stack([adx, ady], -1))
    a_strength = row[:, 20] * an_tex[..., 2]

    # Shading tangent frame (Material.hlsli:264-280).
    shading_bitangent = normalize(jnp.cross(shading_normal, tangent[..., :3]))
    shading_tangent = normalize(jnp.cross(shading_bitangent, shading_normal))
    shading_bitangent = shading_bitangent * tangent[..., 3:4]

    anis_tangent = normalize(
        a_dir[..., 0:1] * shading_tangent + a_dir[..., 1:2] * shading_bitangent
    )
    anis_bitangent = normalize(jnp.cross(anis_tangent, shading_normal))
    rough2_t = jnp.maximum(
        rough2 + (1.0 - rough2) * a_strength * a_strength, MINIMUM_ROUGHNESS
    )

    shc_s, _ = slot(T.TEX_SHEEN_COLOR)
    sheen_color = row[:, 22:25] * shc_s[..., :3]
    shr_s, _ = slot(T.TEX_SHEEN_ROUGHNESS)
    sheen_roughness = row[:, 25] * shr_s[..., 3]
    sheen_rough2 = jnp.maximum(sheen_roughness * sheen_roughness, MINIMUM_ROUGHNESS)

    tr_s, _ = slot(T.TEX_TRANSMISSION)
    transmissive = row[:, 26] * tr_s[..., 0]

    th_s, _ = slot(T.TEX_THICKNESS)
    thickness = row[:, 27] * th_s[..., 1]

    if use_geometric_normals:
        shading_normal = geometric_normal
        clearcoat_normal = geometric_normal

    sp = SurfaceProperties(
        albedo=albedo,
        alpha=alpha[..., None],
        metalness=metalness[..., None],
        roughness_squared=jnp.stack([rough2_t, rough2], -1),
        shading_normal=shading_normal,
        anisotropy_tangent=anis_tangent,
        anisotropy_bitangent=anis_bitangent,
        ior=ior[..., None],
        specular_color=specular_color,
        specular_factor=specular_factor[..., None],
        clearcoat=clearcoat[..., None],
        clearcoat_roughness=jnp.maximum(clearcoat_roughness, MINIMUM_ROUGHNESS)[..., None],
        clearcoat_normal=clearcoat_normal,
        sheen_color=sheen_color,
        sheen_roughness_squared=sheen_rough2[..., None],
        transmissive=transmissive[..., None],
        thickness=thickness[..., None],
        attenuation_distance=row[:, 28:29],
        attenuation_color=row[:, 29:32],
    )
    extras = SurfaceExtras(
        emissive=emissive,
        occlusion=occlusion,
        base_color=base_color,
        flags=_bits(row[:, 32]),
        alpha_mode=_bits(row[:, 33]),
        alpha_cutoff=row[:, 10],
    )
    return sp, extras
