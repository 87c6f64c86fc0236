import numpy as np
import jax.numpy as jnp
import pytest

from gltf_renderer.env import environment as E
from gltf_renderer.env import hdr_io
from gltf_renderer.ops import rng
from gltf_renderer.utils.math import square_to_sphere, uv_to_unit_square


def _test_equirect(h=64, w=128):
    """Smooth analytic environment: bright patch toward +x, gradient by z."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    # Invert the equirect mapping (Transforms.hlsli:3-8): z = 1-2v, phi = 2*pi*u.
    z = 1.0 - 2.0 * vv
    phi = 2 * np.pi * uu
    s = np.sqrt(np.maximum(1 - z * z, 0))
    d = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    col = 0.3 + 2.0 * np.maximum(d[..., 0], 0) ** 4
    img = np.stack([col, 0.5 * col + 0.1, 0.2 + 0.3 * (d[..., 2] * 0.5 + 0.5)], -1)
    return img.astype(np.float32)


def test_hdr_roundtrip(tmp_path):
    img = _test_equirect(32, 64)
    p = str(tmp_path / "t.hdr")
    hdr_io.write_hdr(p, img)
    back = hdr_io.read_hdr(p)
    assert back.shape == (32, 64, 3)
    err = np.abs(back - img) / np.maximum(img, 1e-3)
    assert np.percentile(err, 99) < 0.02  # 8-bit mantissa RGBE


def test_exr_roundtrip(tmp_path):
    img = _test_equirect(16, 32)
    p = str(tmp_path / "t.exr")
    hdr_io.write_exr(p, img)
    back = hdr_io.read_exr(p)
    np.testing.assert_allclose(back, img, atol=1e-6)


@pytest.mark.parametrize("comp", [1, 2, 3])
def test_exr_compressed_roundtrip_lossless(tmp_path, comp):
    """RLE/ZIPS/ZIP decode to the exact pixels of the NONE encoding
    (tinyexr's envelope minus PIZ, EnvironmentMap.cpp:148-251)."""
    # 33 rows: ZIP's 16-line blocks get a partial last block.
    img = _test_equirect(33, 32)
    p0 = str(tmp_path / "none.exr")
    pc = str(tmp_path / f"c{comp}.exr")
    hdr_io.write_exr(p0, img, compression=0)
    hdr_io.write_exr(pc, img, compression=comp)
    np.testing.assert_array_equal(hdr_io.read_exr(pc), hdr_io.read_exr(p0))


@pytest.mark.parametrize("comp", [0, 2, 3, 4, 5])
def test_exr_tiled_roundtrip(tmp_path, comp):
    """ONE_LEVEL tiled single-part decode matches the scanline encoding of
    the same pixels — the reference's tinyexr loads tiled files
    (EnvironmentMap.cpp:148-251); real 4k HDRIs from the wild are often
    tiled. 37x53 with 16x16 tiles exercises partial edge tiles."""
    rng = np.random.default_rng(7)
    img = rng.normal(size=(37, 53, 3)).astype(np.float16).astype(np.float32)
    ps = str(tmp_path / "scan.exr")
    pt = str(tmp_path / "tile.exr")
    hdr_io.write_exr(ps, img, compression=0, half=True)
    hdr_io.write_exr(pt, img, compression=comp, half=True, tile=(16, 16))
    np.testing.assert_array_equal(hdr_io.read_exr(pt), hdr_io.read_exr(ps))


def test_exr_tiled_float_piz_roundtrip(tmp_path):
    """Full-float PIZ tiles (hi/lo half split) survive the tile layout."""
    rng = np.random.default_rng(11)
    img = (rng.normal(size=(40, 40, 3)) * 10).astype(np.float32)
    pt = str(tmp_path / "tile.exr")
    hdr_io.write_exr(pt, img, compression=4, tile=(32, 32))
    np.testing.assert_array_equal(hdr_io.read_exr(pt), img)


def test_exr_tile_offset_counts():
    """Mip/rip chunk-count bookkeeping (needed to locate the tile chunks
    after the offset table) matches the OpenEXR level formulas."""
    # ONE_LEVEL: ceil(W/tx) * ceil(H/ty)
    assert hdr_io._tile_offset_count(100, 60, 32, 32, 0, False) == 4 * 2
    # MIPMAP round-down on a 4x4 image with 2x2 tiles:
    # level0 4x4 -> 2x2 tiles, level1 2x2 -> 1 tile, level2 1x1 -> 1 tile
    assert hdr_io._tile_offset_count(4, 4, 2, 2, 1, False) == 4 + 1 + 1
    # MIPMAP round-up on 5x3, 2x2 tiles: levels 5x3, 3x2, 2x1, 1x1
    # -> ceil counts (3*2) + (2*1) + (1*1) + (1*1)
    assert hdr_io._tile_offset_count(5, 3, 2, 2, 1, True) == 6 + 2 + 1 + 1
    # RIPMAP round-down 4x4, 2x2 tiles: (2x2, 1x1 levels each axis)^2
    # lx,ly in {0,1,2}: sizes 4,2,1 -> tiles 2,1,1 per axis -> (2+1+1)^2
    assert hdr_io._tile_offset_count(4, 4, 2, 2, 2, False) == 16


def test_exr_multipart_rejected(tmp_path):
    import struct

    p = str(tmp_path / "mp.exr")
    with open(p, "wb") as f:
        f.write(struct.pack("<iI", 20000630, 2 | 0x1000))
    with pytest.raises(ValueError, match="multi-part"):
        hdr_io.read_exr(p)


def test_exr_rle_constant_rows_compress(tmp_path):
    """A constant image actually exercises the run path of the RLE codec
    (file materially smaller than raw) and still decodes exactly."""
    img = np.full((8, 64, 3), 0.25, np.float16)
    p = str(tmp_path / "runs.exr")
    hdr_io.write_exr(p, img, compression=1, half=True)
    import os

    assert os.path.getsize(p) < img.nbytes // 4
    np.testing.assert_array_equal(hdr_io.read_exr(p), img.astype(np.float32))


def test_exr_pxr24_float_roundtrip(tmp_path):
    """PXR24 float channels lose exactly the low mantissa byte — decoded
    bits must equal the source bits with the bottom 8 zeroed. PXR24 is
    BEYOND the reference's tinyexr envelope (tinyexr has no PXR24)."""
    img = _test_equirect(33, 32)
    p = str(tmp_path / "t24.exr")
    hdr_io.write_exr(p, img, compression=5)
    back = hdr_io.read_exr(p)
    want = (img.view(np.uint32) & np.uint32(0xFFFFFF00)).view(np.float32)
    np.testing.assert_array_equal(back, want)
    # And the truncation error is bounded by 2^-16 relative.
    np.testing.assert_allclose(back, img, rtol=2.0**-15)


def test_exr_pxr24_half_lossless(tmp_path):
    img = _test_equirect(16, 32).astype(np.float16)
    p = str(tmp_path / "th.exr")
    hdr_io.write_exr(p, img, compression=5, half=True)
    np.testing.assert_array_equal(hdr_io.read_exr(p), img.astype(np.float32))


def test_exr_half_rle_roundtrip(tmp_path):
    img = _test_equirect(16, 32).astype(np.float16)
    p = str(tmp_path / "th1.exr")
    hdr_io.write_exr(p, img, compression=1, half=True)
    np.testing.assert_array_equal(hdr_io.read_exr(p), img.astype(np.float32))


def test_exr_piz_half_roundtrip(tmp_path):
    """PIZ half channels: lossless, incl. a partial last 32-line block."""
    img = _test_equirect(40, 32).astype(np.float16)
    p = str(tmp_path / "tp.exr")
    hdr_io.write_exr(p, img, compression=4, half=True)
    np.testing.assert_array_equal(hdr_io.read_exr(p), img.astype(np.float32))


def test_exr_piz_float_roundtrip(tmp_path):
    """PIZ FLOAT channels exercise the per-16-bit-slice wavelet (ox=size) —
    round 4 fixed the decoder's single-wavelet-over-2x-columns bug."""
    img = _test_equirect(16, 32)  # float32
    p = str(tmp_path / "tpf.exr")
    hdr_io.write_exr(p, img, compression=4)
    np.testing.assert_array_equal(hdr_io.read_exr(p), img)


def test_piz_native_matches_python():
    """native/exr_piz.cpp must decode byte-identically to the pure-Python
    reference path on half, float, and wide-value-range blocks."""
    from gltf_renderer.env import piz

    if piz._native_piz() is None:
        pytest.skip("native lib unavailable")
    rs = np.random.RandomState(7)
    cases = []
    h16 = rs.uniform(0, 4, (24, 20, 3)).astype(np.float16)
    cases.append(([("B", 1), ("G", 1), ("R", 1)], h16.view(np.uint16), 20, 24))
    f32 = rs.uniform(0, 4, (12, 20, 3)).astype(np.float32)
    cases.append(([("B", 2), ("G", 2), ("R", 2)], f32.view(np.uint16), 20, 12))
    bits = np.arange(0x7C00, dtype=np.uint16)
    rs.shuffle(bits)
    # ONE block, >=2^14 distinct values: native and Python must agree on
    # the 16-bit wavelet path too (A_OFFSET mismatch regression).
    wide = bits[: 32 * 200 * 3].reshape(32, 200, 3)
    assert len(np.unique(wide)) >= (1 << 14)
    cases.append(([("B", 1), ("G", 1), ("R", 1)], wide, 200, 32))
    for channels, arr, w, n_lines in cases:
        raw = arr.reshape(n_lines, -1).tobytes()
        blob = piz.piz_compress(raw, channels, w, n_lines)
        via_py = piz.piz_uncompress(blob, channels, w, n_lines, allow_native=False)
        via_cc = piz.piz_uncompress(blob, channels, w, n_lines, allow_native=True)
        assert via_py == raw
        assert via_cc == raw


def test_exr_piz_wide_value_range(tmp_path):
    """>=2^14 distinct half bit patterns forces the wdec16 wavelet branch —
    round 4 fixed maxValue to the global compacted-LUT max (OpenEXR
    semantics), not the per-plane data max."""
    # Deterministic: every finite positive half bit pattern once, shuffled.
    # 32 rows = ONE PIZ block holding >=2^14 distinct values, so the 16-bit
    # wavelet (wdec16/wenc16, A_OFFSET = 1<<15) runs — the round-3 code
    # never reached it (per-plane maxValue bug) and had A_OFFSET = 1<<14.
    bits = np.arange(0x7C00, dtype=np.uint16)  # exponents 0..30, positive
    rs = np.random.RandomState(3)
    rs.shuffle(bits)
    n = 32 * 200 * 3
    assert n >= (1 << 14)
    vals = bits[:n].reshape(32, 200, 3).view(np.float16)
    distinct = len(np.unique(vals.view(np.uint16)))
    assert distinct >= (1 << 14), distinct
    p = str(tmp_path / "tw.exr")
    hdr_io.write_exr(p, vals, compression=4, half=True)
    np.testing.assert_array_equal(hdr_io.read_exr(p), vals.astype(np.float32))


@pytest.fixture(scope="module")
def env():
    return E.build_environment(_test_equirect(), cube_size=64)


def test_cubemap_matches_equirect(env):
    # Sample a few directions: cube lookup must match analytic color.
    dirs = np.asarray(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0.7, 0.7, 0.1]], np.float32
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = np.asarray(E.env_radiance(env, jnp.asarray(dirs)))
    want_r = 0.3 + 2.0 * np.maximum(dirs[:, 0], 0) ** 4
    np.testing.assert_allclose(got[:, 0], want_r, rtol=0.1, atol=0.02)


def test_importance_pyramid_is_sum(env):
    mips = [np.asarray(m) for m in env.importance]
    assert mips[0].shape == (E.IMPORTANCE_RESOLUTION, E.IMPORTANCE_RESOLUTION)
    assert mips[-1].shape == (1, 1)
    np.testing.assert_allclose(mips[-1][0, 0], mips[0].sum(), rtol=1e-3)
    np.testing.assert_allclose(mips[1].sum(), mips[0].sum(), rtol=1e-4)


def test_env_sample_pdf_consistency(env):
    """sample() then pdf() must agree, and the estimator must integrate to ~1:
    E[1/(4*pi*pdf)] over importance samples = 1 (pdf integrates to 1)."""
    n = 4096
    u = rng.r2(jnp.asarray([0.3, 0.8]), jnp.arange(n))
    d, c, pdf = E.env_sample(env, u)
    pdf = np.asarray(pdf)
    assert np.all(pdf > 0)
    # pdf query can land on a neighboring texel after the sphere<->square
    # roundtrip at texel boundaries; 99% must agree tightly.
    pdf_q = np.asarray(E.env_pdf(env, d))
    rel = np.abs(pdf_q - pdf) / np.maximum(pdf, 1e-9)
    assert np.percentile(rel, 99) < 0.05
    assert np.median(rel) < 1e-3
    est = np.mean(1.0 / (4 * np.pi * pdf))
    assert abs(est - 1.0) < 0.05, est


def test_env_sampling_estimates_integral(env):
    """MC with env importance sampling must estimate total irradiance =
    integral of radiance over sphere; compare against direct pixel sum."""
    n = 8192
    u = rng.r2(jnp.asarray([0.1, 0.6]), jnp.arange(n))
    d, c, pdf = E.env_sample(env, u)
    lum = np.asarray(c).mean(-1)
    est = np.mean(lum / np.maximum(np.asarray(pdf), 1e-12))
    # Ground truth via fine uniform sphere sampling of the analytic env.
    m = 1 << 16
    g = np.random.default_rng(0).normal(size=(m, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    col_r = 0.3 + 2.0 * np.maximum(g[:, 0], 0) ** 4
    col = np.stack([col_r, 0.5 * col_r + 0.1, 0.2 + 0.3 * (g[:, 2] * 0.5 + 0.5)], -1)
    truth = 4 * np.pi * col.mean(-1).mean()
    assert abs(est - truth) / truth < 0.1, (est, truth)


def test_ggx_and_diffuse_cubes(env):
    assert len(env.ggx) >= 1
    assert env.diffuse.shape == (6, E.DIFFUSE_RESOLUTION, E.DIFFUSE_RESOLUTION, 3)
    d = np.asarray(env.diffuse)
    assert np.all(np.isfinite(d)) and d.min() >= 0
    # Diffuse convolution preserves rough energy scale (average radiance).
    avg_env = np.asarray(env.cube[0]).mean()
    assert abs(d.mean() - avg_env) / avg_env < 0.25


def test_exr_piz_sheen_lut():
    """PIZ-compressed EXR decode, cross-validated against our computed
    Charlie-sheen directional-albedo LUT (reference Resources/Sheen_E.exr)."""
    import os
    ref_path = "/root/reference/Resources/Sheen_E.exr"
    if not os.path.exists(ref_path):
        pytest.skip("reference EXR not available")
    from gltf_renderer.ops.bsdf import sheen_e_table, sheen_e_table_mc

    img = hdr_io.read_exr(ref_path)
    assert img.shape == (16, 16, 1)
    assert 0.0 <= float(img.min()) and float(img.max()) < 1.0
    # The embedded table IS the reference EXR, decoded by this PIZ reader.
    np.testing.assert_allclose(sheen_e_table(), img[..., 0], atol=1e-6)
    # And the self-contained MC rebuild cross-validates both.
    ours = sheen_e_table_mc()
    h, w = img.shape[:2]
    yi = np.clip(((np.arange(h) + 0.5) / h * ours.shape[0]).astype(int), 0, ours.shape[0] - 1)
    xi = np.clip(((np.arange(w) + 0.5) / w * ours.shape[1]).astype(int), 0, ours.shape[1] - 1)
    ours_rs = ours[yi][:, xi]
    corr = np.corrcoef(ours_rs.ravel(), img[..., 0].ravel())[0, 1]
    assert corr > 0.97, corr


def test_piz_corrupt_bitmap_span_rejected():
    """Malicious/corrupt PIZ header (bitmap span past the 8192-byte table)
    must fail CLEANLY on both decoders — the native path returns an error
    (no OOB write, exr_piz.cpp rc=-10) and the Python fallback raises."""
    import struct

    from gltf_renderer.env import piz

    bad = struct.pack("<HH", 60000, 60001) + b"\x01\x01" + struct.pack("<i", 24) + b"\x00" * 24
    with pytest.raises(Exception):
        piz.piz_uncompress(bad, [("R", 1)], 4, 4)


def test_cube_quad_sampling_bit_exact(env, monkeypatch):
    """build_cube_quads + quad sampling (the raster IBL 2-row path) must be
    bit-identical to the 8-row fused trilinear gather, including face-edge
    clamps and level endpoints — with f32 rows (GLTF_QUADF32=1), which
    isolates the indexing/corner-select logic from storage precision."""
    monkeypatch.setenv("GLTF_QUADF32", "1")
    rs = np.random.RandomState(11)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    n = len(env.ggx)
    quad = jnp.asarray(E.build_cube_quads(env.ggx))
    for lvl in [
        jnp.zeros(512),
        jnp.full(512, n - 1.0),
        jnp.asarray(rs.uniform(-1.0, n + 1.0, 512).astype(np.float32)),
    ]:
        ref = E.sample_cube(env.ggx, d, lvl)
        got = E.sample_cube(env.ggx, d, lvl, quad=quad)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    dq = jnp.asarray(E.build_cube_quads([env.diffuse]))
    ref = E.sample_cube([env.diffuse], d, jnp.zeros(512))
    got = E.sample_cube([env.diffuse], d, jnp.zeros(512), quad=dq)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_cube_quad_f16_default_within_half_precision(env):
    """Default quad rows are f16 (reference parity: the DX12 cube/ggx/
    diffuse textures are R16G16B16A16_FLOAT, EnvironmentMap.cpp:93-120).
    The quad path must match the f32 trilinear within f16 quantization of
    the corner texels (relative 2^-11 per corner, summed over the lerp)."""
    assert E.build_cube_quads([env.diffuse]).dtype == np.float16
    rs = np.random.RandomState(13)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    n = len(env.ggx)
    quad = jnp.asarray(E.build_cube_quads(env.ggx))
    lvl = jnp.asarray(rs.uniform(0.0, n - 1.0, 512).astype(np.float32))
    ref = np.asarray(E.sample_cube(env.ggx, d, lvl))
    got = np.asarray(E.sample_cube(env.ggx, d, lvl, quad=quad))
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -10, atol=1e-6)
