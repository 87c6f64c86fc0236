import numpy as np
import jax.numpy as jnp

from gltf_renderer.utils import math as m


def random_unit_vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_octahedral_roundtrip():
    v = random_unit_vectors(4096)
    dec = np.asarray(m.decode_octahedral(m.encode_octahedral(jnp.asarray(v))))
    assert np.max(np.abs(dec - v)) < 1e-5


def test_square_sphere_roundtrip():
    rng = np.random.default_rng(1)
    sq = rng.uniform(-1, 1, size=(4096, 2)).astype(np.float32)
    s = np.asarray(m.square_to_sphere(jnp.asarray(sq)))
    assert np.max(np.abs(np.linalg.norm(s, axis=-1) - 1.0)) < 1e-4
    back = np.asarray(m.sphere_to_square(jnp.asarray(s)))
    assert np.max(np.abs(back - sq)) < 1e-3


def test_sphere_square_covers_sphere():
    v = random_unit_vectors(4096, seed=2)
    sq = np.asarray(m.sphere_to_square(jnp.asarray(v)))
    assert np.all(np.abs(sq) <= 1.0 + 1e-5)
    s = np.asarray(m.square_to_sphere(jnp.asarray(sq)))
    assert np.max(np.abs(s - v)) < 1e-3


def test_square_to_disk_inside():
    rng = np.random.default_rng(3)
    sq = rng.uniform(-1, 1, size=(4096, 2)).astype(np.float32)
    d = np.asarray(m.square_to_disk(jnp.asarray(sq)))
    assert np.all(np.linalg.norm(d, axis=-1) <= 1.0 + 1e-5)


def test_cubemap_direction_roundtrip():
    v = random_unit_vectors(4096, seed=4)
    face, uv = m.direction_to_cubemap(jnp.asarray(v))
    d = np.asarray(m.cubemap_to_direction(face, uv))
    assert np.max(np.abs(d - v)) < 1e-5


def test_equirect_range():
    v = random_unit_vectors(1000, seed=5)
    uv = np.asarray(m.direction_to_equirectangular(jnp.asarray(v)))
    assert np.all(uv[:, 0] >= -0.5) and np.all(uv[:, 0] <= 0.5)
    assert np.all(uv[:, 1] >= 0.0) and np.all(uv[:, 1] <= 1.0)


def test_basis_orthonormal():
    v = random_unit_vectors(1024, seed=6)
    for fn in (m.create_basis, m.create_basis_accurate):
        t, b = fn(jnp.asarray(v))
        t, b = np.asarray(t), np.asarray(b)
        assert np.max(np.abs(np.sum(t * v, axis=-1))) < 1e-4
        assert np.max(np.abs(np.sum(b * v, axis=-1))) < 1e-4
        assert np.max(np.abs(np.sum(t * b, axis=-1))) < 1e-4
        assert np.max(np.abs(np.linalg.norm(t, axis=-1) - 1)) < 1e-4


def test_tangent_space_codec_roundtrip():
    n = random_unit_vectors(2048, seed=7)
    # Build valid tangents orthogonal to n.
    t_raw = random_unit_vectors(2048, seed=8)
    t = t_raw - np.sum(t_raw * n, axis=-1, keepdims=True) * n
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    w = np.where(np.arange(2048) % 2 == 0, 1.0, -1.0).astype(np.float32)
    tangent = np.concatenate([t, w[:, None]], axis=-1)

    packed = m.encode_tangent_space(jnp.asarray(n), jnp.asarray(tangent))
    unpacked = m.unpack_r10g10b10a2(packed)
    n2, t2 = m.decode_tangent_space(unpacked)
    n2, t2 = np.asarray(n2), np.asarray(t2)
    # 10-bit quantization: allow ~0.01 error.
    assert np.max(np.sum(n2 * n, axis=-1)) <= 1.0 + 1e-6
    assert np.percentile(np.abs(1 - np.sum(n2 * n, axis=-1)), 99) < 1e-4
    # Reference quirk (kept for image parity): EncodeTangentSpace stores
    # angle/TAU + 0.5 (Vertex.hlsli:37) but DecodeTangentSpace reads
    # angle = TAU * z (Vertex.hlsli:14) — decoded tangents come back rotated
    # a half turn in the tangent plane: decode(encode(t)) == -t.
    assert np.percentile(np.abs(1 - np.sum(t2[:, :3] * (-t), axis=-1)), 99) < 5e-4
    assert np.all(t2[:, 3] == w)


def test_srgb_roundtrip():
    x = np.linspace(0, 1, 256).astype(np.float32)
    y = np.asarray(m.decode_srgb(m.encode_srgb(jnp.asarray(x))))
    assert np.max(np.abs(y - x)) < 1e-5


def test_reflect():
    v = np.array([[1.0, -1.0, 0.0]], np.float32)
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    r = np.asarray(m.reflect(jnp.asarray(v), jnp.asarray(n)))
    np.testing.assert_allclose(r, [[1.0, 1.0, 0.0]], atol=1e-6)
