import numpy as np
import jax.numpy as jnp

from gltf_renderer.ops import bsdf
from gltf_renderer.ops import sampling
from gltf_renderer.ops import rng


def test_ggx_d_normalized():
    """∫ D(h) (n·h) dω = 1 over the hemisphere (GGX NDF normalization)."""
    n_theta, n_phi = 512, 256
    theta = (np.arange(n_theta) + 0.5) / n_theta * (np.pi / 2)
    phi = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    for a in [0.05, 0.2, 0.5, 1.0]:
        d = np.asarray(bsdf.ggx_d(a, jnp.asarray(np.cos(t))))
        integrand = d * np.cos(t) * np.sin(t)
        val = integrand.sum() * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)
        assert abs(val - 1.0) < 2e-2, (a, val)


def test_ggx_anisotropic_d_normalized():
    n_theta, n_phi = 1024, 512
    theta = (np.arange(n_theta) + 0.5) / n_theta * (np.pi / 2)
    phi = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    h = np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], axis=-1
    ).astype(np.float32)
    a = jnp.asarray([0.3, 0.6], jnp.float32)
    d = np.asarray(bsdf.ggx_anisotropic_d(jnp.broadcast_to(a, h.shape[:-1] + (2,)), jnp.asarray(h)))
    integrand = d * np.cos(t) * np.sin(t)
    val = integrand.sum() * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi)
    assert abs(val - 1.0) < 2e-2, val


def test_ggx_sampling_consistency():
    """MC estimate of ∫ D (n·h) dω with h ~ sample_ggx_normal must be ~1."""
    n = 1 << 16
    i = jnp.arange(n)
    u = rng.r2(jnp.array([0.25, 0.7]), i)
    for a in [0.1, 0.4, 0.9]:
        h = sampling.sample_ggx_normal(a, u)
        pdf = np.asarray(sampling.ggx_normal_pdf(a, jnp.asarray([0.0, 0.0, 1.0]), h))
        d = np.asarray(bsdf.ggx_d(a, np.asarray(h)[..., 2])) * np.asarray(h)[..., 2]
        est = np.mean(d / np.maximum(pdf, 1e-12))
        assert abs(est - 1.0) < 2e-2, (a, est)


def test_anisotropic_ggx_sampling_consistency():
    n = 1 << 16
    u = rng.r2(jnp.array([0.33, 0.11]), jnp.arange(n))
    a = jnp.asarray([0.2, 0.7], jnp.float32)
    h = sampling.sample_ggx_anisotropic_normal(a, u)
    a_b = jnp.broadcast_to(a, (h.shape[0], 2))
    pdf = np.asarray(sampling.ggx_anisotropic_normal_pdf(a_b, h))
    d = np.asarray(bsdf.ggx_anisotropic_d(a_b, h)) * np.asarray(h)[:, 2]
    est = np.mean(d / np.maximum(pdf, 1e-12))
    assert abs(est - 1.0) < 2e-2, est


def test_cosine_hemisphere_sampling():
    """E[1/pdf] over cosine samples = hemisphere area of cos-weighted = pi...
    MC check: estimate ∫ cosθ dω = π using pdf = cosθ/π."""
    n = 1 << 16
    u = rng.r2(jnp.array([0.8, 0.2]), jnp.arange(n))
    normal = jnp.asarray([0.0, 0.0, 1.0])
    d = sampling.sample_cosine_hemisphere(jnp.broadcast_to(normal, (n, 3)), u)
    pdf = np.asarray(sampling.cosine_hemisphere_pdf(jnp.broadcast_to(normal, (n, 3)), d))
    cos = np.maximum(np.asarray(d)[:, 2], 0.0)
    est = np.mean(cos / np.maximum(pdf, 1e-12))
    assert abs(est - np.pi) < 0.05


def test_sheen_e_table_bounds():
    t = bsdf.sheen_e_table()
    assert t.shape == (16, 16)
    assert t.min() >= 0.0 and t.max() <= 1.0
    # Grazing view at high roughness should scatter noticeably.
    assert t[-1, 0] > 0.05


def test_sheen_e_lookup_matches_table():
    t = bsdf.sheen_e_table()
    res_a, res_c = t.shape
    # Texel centers.
    cos = (np.arange(res_c) + 0.5) / res_c
    alpha = np.full(res_c, (10 + 0.5) / res_a, np.float32)
    got = np.asarray(bsdf.sheen_e(jnp.asarray(alpha), jnp.asarray(cos.astype(np.float32))))
    np.testing.assert_allclose(got, t[10], atol=1e-5)


def _default_surface(n_batch, **overrides):
    z = lambda k: jnp.zeros((n_batch, k), jnp.float32)
    o = lambda k: jnp.ones((n_batch, k), jnp.float32)
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n_batch, 3))
    tangent = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n_batch, 3))
    bitangent = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n_batch, 3))
    sp = dict(
        albedo=o(3),
        alpha=o(1),
        metalness=z(1),
        roughness_squared=o(2) * 0.25,
        shading_normal=normal,
        anisotropy_tangent=tangent,
        anisotropy_bitangent=bitangent,
        ior=o(1) * 1.5,
        specular_color=o(3),
        specular_factor=o(1),
        clearcoat=z(1),
        clearcoat_roughness=o(1) * 0.1,
        clearcoat_normal=normal,
        sheen_color=z(3),
        sheen_roughness_squared=o(1) * 0.25,
        transmissive=z(1),
        thickness=z(1),
        attenuation_distance=z(1),
        attenuation_color=o(3),
    )
    sp.update(overrides)
    return bsdf.SurfaceProperties(**sp)


def test_gltf_bsdf_white_furnace_diffuse():
    """Pure white Lambertian (rough=1, no specular weight contributions beyond
    Fresnel) must conserve <=1 energy; sanity check: finite, non-negative."""
    n = 1 << 14
    u = rng.r2(jnp.array([0.5, 0.5]), jnp.arange(n))
    normal = jnp.asarray([0.0, 0.0, 1.0])
    l = sampling.sample_cosine_hemisphere(jnp.broadcast_to(normal, (n, 3)), u)
    v = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    sp = _default_surface(n)
    f = np.asarray(bsdf.gltf_bsdf(sp, v, l))
    assert np.all(np.isfinite(f))
    assert np.all(f >= 0)
    pdf = np.asarray(sampling.cosine_hemisphere_pdf(jnp.broadcast_to(normal, (n, 3)), l))
    albedo_est = np.mean(f / np.maximum(pdf[:, None], 1e-9), axis=0)
    # Dielectric white: energy below 1, above 0.5.
    assert np.all(albedo_est <= 1.05) and np.all(albedo_est >= 0.4), albedo_est


def test_gltf_bsdf_metal_reflectance():
    n = 4
    sp = _default_surface(n, metalness=jnp.ones((n, 1)))
    v = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    l = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    f = np.asarray(bsdf.gltf_bsdf(sp, v, l))
    assert np.all(np.isfinite(f)) and np.all(f >= 0)


def test_attenuate():
    att = np.asarray(
        bsdf.attenuate(
            jnp.asarray([[2.0]]), jnp.asarray([[0.5, 0.25, 1.0]]), jnp.asarray([[2.0]])
        )
    )
    np.testing.assert_allclose(att, [[0.5, 0.25, 1.0]], atol=1e-6)
    att0 = np.asarray(
        bsdf.attenuate(
            jnp.asarray([[0.0]]), jnp.asarray([[0.5, 0.25, 1.0]]), jnp.asarray([[2.0]])
        )
    )
    np.testing.assert_allclose(att0, [[1.0, 1.0, 1.0]], atol=1e-6)


def test_clearcoat_eval_uses_shading_normal():
    """Reference quirk (Bsdf.hlsli:275-279 vs PathTracer.lib.hlsl:394-411):
    clearcoat EVALUATION is about the SHADING normal even though sampling/
    pdf use clearcoat_normal. With a tilted clearcoat_normal the evaluated
    BSDF must be invariant; with a tilted shading_normal it must change."""
    import jax.numpy as jnp

    n = 4
    v = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    ld = jnp.asarray([0.3, 0.0, 0.954], jnp.float32)
    l = jnp.broadcast_to(ld / jnp.linalg.norm(ld), (n, 3))
    tilt = jnp.asarray([0.35, 0.0, 0.937], jnp.float32)
    tilt = jnp.broadcast_to(tilt / jnp.linalg.norm(tilt), (n, 3))

    base = _default_surface(n, clearcoat=jnp.ones((n, 1)))
    f0 = np.asarray(bsdf.gltf_bsdf(base, v, l))
    # Tilting clearcoat_normal alone: evaluation unchanged.
    cc_tilt = _default_surface(n, clearcoat=jnp.ones((n, 1)),
                               clearcoat_normal=tilt)
    f1 = np.asarray(bsdf.gltf_bsdf(cc_tilt, v, l))
    np.testing.assert_array_equal(f0, f1)
    # Tilting shading_normal (same frame otherwise): clearcoat lobe moves.
    sn_tilt = _default_surface(n, clearcoat=jnp.ones((n, 1)),
                               shading_normal=tilt)
    f2 = np.asarray(bsdf.gltf_bsdf(sn_tilt, v, l))
    assert not np.allclose(f2, f0)
