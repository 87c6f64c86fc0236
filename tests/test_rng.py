import numpy as np
import jax.numpy as jnp

from gltf_renderer.ops import rng

M32 = 0xFFFFFFFF


def pcg4d_py(v):
    """Independent pure-Python uint32 model of pcg4d (Random.hlsli:17-30)."""
    v = [(x * 1664525 + 1013904223) & M32 for x in v]
    x, y, z, w = v
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    x ^= x >> 16
    y ^= y >> 16
    z ^= z >> 16
    w ^= w >> 16
    x = (x + y * w) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    w = (w + y * z) & M32
    return [x, y, z, w]


def pcg3d_py(v):
    v = [(x * 1664525 + 1013904223) & M32 for x in v]
    x, y, z = v
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    x ^= x >> 16
    y ^= y >> 16
    z ^= z >> 16
    x = (x + y * z) & M32
    y = (y + z * x) & M32
    z = (z + x * y) & M32
    return [x, y, z]


def test_pcg4d_bit_exact():
    cases = [[0, 0, 0, 0], [1, 2, 3, 4], [640, 360, 12345, 7], [M32, M32, M32, M32]]
    got = np.asarray(rng.pcg4d(jnp.asarray(cases, jnp.uint32)))
    want = np.asarray([pcg4d_py(c) for c in cases], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_pcg3d_bit_exact():
    cases = [[0, 0, 0], [11, 22, 33], [M32, 0, 123456789]]
    got = np.asarray(rng.pcg3d(jnp.asarray(cases, jnp.uint32)))
    want = np.asarray([pcg3d_py(c) for c in cases], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_random_float_range_and_uniformity():
    xs = np.arange(64)
    ys = np.arange(64)
    gx, gy = np.meshgrid(xs, ys)
    u = np.asarray(
        rng.pt_random(jnp.asarray(gx.ravel()), jnp.asarray(gy.ravel()), 1234, 0)
    )
    assert u.shape == (64 * 64, 4)
    assert u.min() >= 0.0 and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.01


def test_r_sequences():
    n = jnp.arange(1024)
    x = np.asarray(rng.r1(0.5, n))
    assert x.min() >= 0 and x.max() < 1
    xy = np.asarray(rng.r2(jnp.array([0.5, 0.5]), n))
    assert xy.shape == (1024, 2)
    assert abs(xy.mean() - 0.5) < 0.02


def test_radical_inverse():
    got = np.asarray(rng.radical_inverse(jnp.asarray([0, 1, 2, 3, 4], jnp.uint32)))
    np.testing.assert_allclose(got, [0.0, 0.5, 0.25, 0.75, 0.125], atol=1e-7)
