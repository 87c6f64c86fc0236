"""The numpy+zlib PNG codec (utils/png.py): round trips, and decoding of
PNGs written by another encoder with every filter, color type and depth."""

import io

import numpy as np
import pytest

from gltf_renderer.utils.png import decode_png, encode_png, load_png, save_png


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 1), (6, 9, 2), (5, 8, 3), (4, 3, 4)])
def test_roundtrip(shape, tmp_path):
    rs = np.random.RandomState(sum(shape))
    img = rs.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    out = load_png(path)
    np.testing.assert_array_equal(out.reshape(img.shape), img)


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError):
        decode_png(b"not a png at all")


def _smooth(h, w, c, seed):
    """Gradient + noise: gives every PNG filter type something to win."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3 + 40 * k) % 256 for k in range(c)], -1)
    noise = rs.randint(0, 3, (h, w, c))
    return ((base + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1", "I;16"])
def test_decodes_other_encoder(mode):
    Image = pytest.importorskip("PIL.Image")
    rgba = _smooth(33, 47, 4, seed=len(mode))
    if mode == "I;16":
        src = Image.fromarray(rgba[..., 0].astype(np.uint16) * 257)
        expect = rgba[..., 0:1]
    elif mode == "P":
        src = Image.fromarray(rgba[..., :3], "RGB").quantize(16)
        expect = np.asarray(src.convert("RGB"))
    elif mode == "1":
        src = Image.fromarray(rgba[..., 0], "L").convert("1")
        expect = np.asarray(src.convert("L"))[..., None]
    else:
        n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = rgba[..., :n]
        src = Image.fromarray(arr[..., 0] if n == 1 else arr, mode)
        expect = arr
    buf = io.BytesIO()
    src.save(buf, format="PNG", optimize=True)  # adaptive filters
    got = decode_png(buf.getvalue())
    np.testing.assert_array_equal(got.reshape(expect.shape), expect)


def test_palette_transparency():
    Image = pytest.importorskip("PIL.Image")
    idx = (np.arange(64).reshape(8, 8) % 4).astype(np.uint8)
    src = Image.fromarray(idx, "P")
    src.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9])
    buf = io.BytesIO()
    src.save(buf, format="PNG", transparency=bytes([0, 128, 255, 64]))
    got = decode_png(buf.getvalue())
    assert got.shape == (8, 8, 4)
    np.testing.assert_array_equal(got[..., 3], np.asarray([0, 128, 255, 64])[idx])
    np.testing.assert_array_equal(got[0, 1, :3], [0, 255, 0])
