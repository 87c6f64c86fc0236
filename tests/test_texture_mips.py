"""Raster-backend mip-mapped texture sampling.

build_atlas_mips packs every texture's NPOT trapezoid mip chain
(GenerateMipLevel.cs.hlsl port) into a flat pyramid; sample_slots_fused with
mip_base samples it trilinearly (the Forward.ps.hlsl derivative-mips
analogue). mip_base=None must stay bit-identical to the level-0 path
(Material.hlsli:95 SampleLevel-0 PT parity).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gltf_renderer.ops.material import (
    compact_material_rows, sample_slots_fused, MATERIAL_ROW_FACTORS,
    MATERIAL_SLOT_STRIDE,
)
from gltf_renderer.ops.texture import build_atlas_mips, decode_atlas_linear
from gltf_renderer.scene import types as T


def _one_texture_table(img_u8, wrap=T.WRAP_REPEAT, srgb=0):
    h, w = img_u8.shape[:2]
    tex = T.TextureTable(
        atlas=img_u8,
        x=np.array([0], np.int32), y=np.array([0], np.int32),
        width=np.array([w], np.int32), height=np.array([h], np.int32),
        wrap_s=np.array([wrap], np.int32), wrap_t=np.array([wrap], np.int32),
        nearest=np.array([0], np.int32), srgb=np.array([srgb], np.int32),
        rows=np.array([[0, 0, w, h, wrap, wrap, 0, srgb, 0]], np.float32),
    )
    tex = decode_atlas_linear(tex)
    return build_atlas_mips(tex)


def _material_rows_with_slot0():
    rows = np.zeros((1, MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * 15),
                    np.float32)
    rows[0, 0:4] = 1.0
    # slot 0 address cols: tid=0, uvset=0, rot=0, off=(0,0), scale=(1,1)
    b = MATERIAL_ROW_FACTORS
    rows[0, b + 0] = np.frombuffer(np.int32(0).tobytes(), np.float32)[0]
    rows[0, b + 1] = np.frombuffer(np.int32(0).tobytes(), np.float32)[0]
    rows[0, b + 5] = 1.0
    rows[0, b + 6] = 1.0
    tex_rows = np.array([[0, 0, 16, 16, T.WRAP_REPEAT, T.WRAP_REPEAT, 0, 0, 0]],
                        np.float32)
    return compact_material_rows(rows, (0,), tex_rows)


def test_mip_chain_shapes():
    img = (np.random.RandomState(0).rand(16, 16, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img)
    assert tex.mip_rows.shape == (5, 4)  # 16,8,4,2,1
    total = 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1
    assert tex.mip_flat.shape == (total, 4)
    # level 0 slab equals the linear rect
    lin = np.asarray(tex.atlas_linear).reshape(16, 16, 4)
    np.testing.assert_allclose(
        np.asarray(tex.mip_flat[: 16 * 16]).reshape(16, 16, 4), lin)


def test_mip_base_none_is_level0_bit_identical():
    img = (np.random.RandomState(1).rand(16, 16, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img)
    rows = jnp.asarray(_material_rows_with_slot0())
    uv = jnp.asarray(np.random.RandomState(2).rand(64, 2).astype(np.float32))
    row = rows[jnp.zeros(64, jnp.int32)]
    out0 = sample_slots_fused(row, tex, (0,), uv, uv, (0,), True)[0][0]
    # tex without the pyramid -> identical result
    tex_np = tex._replace(mip_flat=None, mip_rows=None)
    out1 = sample_slots_fused(row, tex_np, (0,), uv, uv, (0,), True,
                              mip_base=jnp.zeros(64))[0][0]
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(out1))


def test_mip_level0_matches_base_path():
    """mip_base far below 0 clamps to level 0 == the non-mip bilinear."""
    img = (np.random.RandomState(3).rand(16, 16, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img)
    rows = jnp.asarray(_material_rows_with_slot0())
    uv = jnp.asarray(np.random.RandomState(4).rand(64, 2).astype(np.float32))
    row = rows[jnp.zeros(64, jnp.int32)]
    base = sample_slots_fused(row, tex, (0,), uv, uv, (0,), True)[0][0]
    mip0 = sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                              mip_base=jnp.full(64, -30.0))[0][0]
    np.testing.assert_allclose(np.asarray(base), np.asarray(mip0),
                               atol=2e-3)  # f16 pyramid vs f16 linear atlas


def test_mip_top_level_is_mean():
    """mip_base far above the chain clamps to the 1x1 level = image mean
    under the trapezoid chain (weights sum to 1 per step)."""
    img = (np.random.RandomState(5).rand(16, 16, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img)
    rows = jnp.asarray(_material_rows_with_slot0())
    uv = jnp.asarray(np.random.RandomState(6).rand(8, 2).astype(np.float32))
    row = rows[jnp.zeros(8, jnp.int32)]
    out = np.asarray(sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                                        mip_base=jnp.full(8, 30.0))[0][0])
    top = np.asarray(tex.mip_flat[-1])
    np.testing.assert_allclose(out, np.broadcast_to(top, out.shape), atol=1e-3)
    # every sample identical (1x1 level has no uv dependence)
    assert np.abs(out - out[0]).max() < 1e-6


def test_trilinear_is_between_levels():
    img = np.zeros((8, 8, 4), np.uint8)
    img[0::2] = 255  # horizontal stripes; level 1+ averages toward 127.5
    tex = _one_texture_table(img)
    rows = jnp.asarray(_material_rows_with_slot0())
    uv = jnp.asarray(np.tile([[0.25, 0.25]], (4, 1)).astype(np.float32))
    row = rows[jnp.zeros(4, jnp.int32)]
    v0 = np.asarray(sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                                       mip_base=jnp.full(4, -10.0))[0][0])[0, 0]
    v2 = np.asarray(sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                                       mip_base=jnp.full(4, 10.0))[0][0])[0, 0]
    # a fractional level between 0 and max sits between the extremes
    mid_lvl = -0.5 * np.log2(8.0 * 8.0) + 1.5  # level 1.5
    vm = np.asarray(sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                                       mip_base=jnp.full(4, mid_lvl))[0][0])[0, 0]
    lo, hi = min(v0, v2), max(v0, v2)
    assert lo - 1e-3 <= vm <= hi + 1e-3


@pytest.mark.parametrize("wrap", [T.WRAP_REPEAT, T.WRAP_CLAMP])
def test_quad_mips_bit_match_four_corner(wrap):
    """GLTF_QUADMIPS path (2 gather rows/sample) must reproduce the
    8-row trilinear path exactly — the baked neighbors ARE the wrapped
    corners, and on CLAMP collapse the corner-select picks the center."""
    img = (np.random.RandomState(7).rand(13, 9, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img, wrap=wrap)
    tex_q = build_atlas_mips(
        tex._replace(mip_flat=None, mip_rows=None, mip_quad=None), quad=True)
    assert tex_q.mip_quad is not None
    np.testing.assert_array_equal(
        np.asarray(tex_q.mip_flat), np.asarray(tex.mip_flat))
    rows = np.zeros((1, MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * 15),
                    np.float32)
    rows[0, 0:4] = 1.0
    b = MATERIAL_ROW_FACTORS
    rows[0, b + 5] = 1.0
    rows[0, b + 6] = 1.0
    tex_rows = np.array([[0, 0, 9, 13, wrap, wrap, 0, 0, 0]], np.float32)
    rows = jnp.asarray(compact_material_rows(rows, (0,), tex_rows))
    rs = np.random.RandomState(8)
    n = 256
    uv = jnp.asarray((rs.rand(n, 2) * 2.5 - 0.75).astype(np.float32))
    row = rows[jnp.zeros(n, jnp.int32)]
    mip_base = jnp.asarray(rs.uniform(-8, 6, n).astype(np.float32))
    ref = sample_slots_fused(row, tex, (0,), uv, uv, (0,), True,
                             mip_base=mip_base)[0][0]
    got = sample_slots_fused(row, tex_q, (0,), uv, uv, (0,), True,
                             mip_base=mip_base)[0][0]
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_quad_mips_skipped_on_mirror():
    img = (np.random.RandomState(9).rand(8, 8, 4) * 255).astype(np.uint8)
    tex = _one_texture_table(img, wrap=T.WRAP_MIRROR)
    tex_q = build_atlas_mips(
        tex._replace(mip_flat=None, mip_rows=None, mip_quad=None), quad=True)
    assert tex_q.mip_quad is None  # mirror replicas need -1 neighbors


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
