"""NPOT-correct mip generation (GenerateMipLevel.cs.hlsl port).

The reference compiles this shader but never dispatches it; the port backs
NPOT texture mip chains. Semantics per axis (GenerateMipLevel.cs.hlsl:55):
even size -> 2-tap box; odd size -> 3-tap trapezoid (TrapezoidFilter,
:15-21) with taps 2x, 2x+1, Wrap(2x+2); size 1 -> passthrough (the shader's
case-1 read is out of range — a benign bug in unused code — we pass
through, documented deviation).
"""

import numpy as np
import pytest

from gltf_renderer.env.environment import (
    build_image_mips,
    generate_mip_level,
)


def _trapezoid_ref(row):
    """Direct per-output evaluation of TrapezoidFilter along one axis."""
    n_in = row.shape[0]
    n = n_in // 2
    out = np.zeros((n,) + row.shape[1:], np.float64)
    for x in range(n):
        s0 = row[2 * x]
        s1 = row[2 * x + 1]
        s2 = row[(2 * x + 2) % n_in]
        w0 = (n - x) / (2 * n + 1)
        w1 = n / (2 * n + 1)
        w2 = (1 + x) / (2 * n + 1)
        out[x] = w0 * s0 + w1 * s1 + w2 * s2
    return out


def test_even_axis_is_box():
    img = np.random.RandomState(0).rand(8, 6, 3).astype(np.float32)
    out = np.asarray(generate_mip_level(img))
    ref = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2])
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_odd_axis_matches_trapezoid():
    rs = np.random.RandomState(1)
    img = rs.rand(9, 7, 3).astype(np.float32)
    out = np.asarray(generate_mip_level(img))
    # separable: vertical (odd 9 -> 4) then horizontal (odd 7 -> 3)
    v = _trapezoid_ref(img.astype(np.float64))
    h = np.moveaxis(_trapezoid_ref(np.moveaxis(v, 1, 0)), 0, 1)
    assert out.shape == (4, 3, 3)
    np.testing.assert_allclose(out, h, rtol=1e-5)


def test_mixed_axes():
    rs = np.random.RandomState(2)
    img = rs.rand(8, 5, 3).astype(np.float32)  # even x odd
    out = np.asarray(generate_mip_level(img))
    v = 0.5 * (img[0::2] + img[1::2]).astype(np.float64)
    h = np.moveaxis(_trapezoid_ref(np.moveaxis(v, 1, 0)), 0, 1)
    assert out.shape == (4, 2, 3)
    np.testing.assert_allclose(out, h, rtol=1e-5)


def test_energy_preserved_on_constant():
    """A constant image stays constant through any mip step (weights sum 1)."""
    img = np.full((11, 6, 3), 0.7, np.float32)
    out = np.asarray(generate_mip_level(img))
    np.testing.assert_allclose(out, 0.7, rtol=1e-6)


def test_size_one_axis_passthrough():
    img = np.random.RandomState(3).rand(1, 8, 3).astype(np.float32)
    out = np.asarray(generate_mip_level(img))
    np.testing.assert_allclose(out, 0.5 * (img[:, 0::2] + img[:, 1::2]), rtol=1e-6)


def test_build_image_mips_chain_npot():
    img = np.random.RandomState(4).rand(13, 21, 3).astype(np.float32)
    mips = build_image_mips(img)
    shapes = [m.shape[:2] for m in mips]
    assert shapes[0] == (13, 21)
    assert shapes[1] == (6, 10)
    assert shapes[-1] == (1, 1)
    # every level halves (floor) until 1
    for a, b in zip(shapes, shapes[1:]):
        assert b == (max(a[0] // 2, 1), max(a[1] // 2, 1))


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))


def test_numpy_twin_matches_jax():
    """ops/texture.build_atlas_mips' load-time numpy filter must match the
    jax generate_mip_level exactly (two implementations of the same shader
    port — this pins them together)."""
    from gltf_renderer.ops import texture as TX
    from gltf_renderer.scene import types as T

    rs = np.random.RandomState(9)
    img = (rs.rand(11, 14, 4) * 255).astype(np.uint8)
    tex = T.TextureTable(
        atlas=img,
        x=np.array([0], np.int32), y=np.array([0], np.int32),
        width=np.array([14], np.int32), height=np.array([11], np.int32),
        wrap_s=np.array([0], np.int32), wrap_t=np.array([0], np.int32),
        nearest=np.array([0], np.int32), srgb=np.array([0], np.int32),
        rows=np.array([[0, 0, 14, 11, 0, 0, 0, 0, 0]], np.float32),
    )
    from gltf_renderer.ops.texture import decode_atlas_linear
    tex = decode_atlas_linear(tex)
    tex = TX.build_atlas_mips(tex)
    lin = np.asarray(tex.atlas_linear).reshape(11, 14, 4).astype(np.float32)
    # level 1 slab == jax generate_mip_level(level 0)
    base0 = 11 * 14
    lvl1 = np.asarray(tex.mip_flat[base0 : base0 + 5 * 7]).reshape(5, 7, 4)
    ref = np.asarray(generate_mip_level(lin)).astype(np.float16).astype(np.float32)
    np.testing.assert_allclose(lvl1.astype(np.float32), ref, atol=2e-3)
