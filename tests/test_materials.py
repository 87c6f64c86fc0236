"""BASELINE configs 4-5: transmission/clearcoat/sheen/anisotropy materials
(DragonAttenuation/ToyCar-class) and alpha-masked foliage with alpha shadows
(Sponza-class)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gltf_renderer.env import environment as E
from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import settings as S
from gltf_renderer.scene import flatten
from gltf_renderer.scene import types as T
from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.camera import Camera, look_at
from tests.scenes import write_materials_gltf, write_foliage_gltf
from tests.test_env import _test_equirect


def _setup(path, env=True):
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    envmaps = E.build_environment(_test_equirect(), cube_size=32) if env else None
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
        env=envmaps,
    )
    return scene, ptscene, meta


def _render(ptscene, meta, cam, settings, spp=8, res=(64, 40), seed0=0):
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    trace_j = jax.jit(pt.trace, static_argnums=(1, 2, 5))
    acc = np.zeros((res[1], res[0], 3), np.float64)
    for s in range(spp):
        acc += np.asarray(
            trace_j(ptscene, meta, settings, params, c2w, res, jnp.uint32(seed0 + s))
        )
    return acc / spp


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "zoo.gltf")
    write_materials_gltf(path)
    scene, ptscene, meta = _setup(path)
    cam = Camera(y_fov=np.pi / 4, aspect_ratio=64 / 40, z_near=0.01)
    cam.world_to_view = look_at([0.0, -5.0, 1.5], [0.0, 0.0, 0.0])
    return scene, ptscene, meta, cam


def test_material_zoo_loads(zoo):
    scene, ptscene, meta, cam = zoo
    assert meta.has_blend          # transmissive sphere groups as blended
    assert meta.has_sheen
    m = scene.materials
    assert m.transmission_factor[1] == 1.0
    assert m.attenuation_distance[1] == pytest.approx(0.5)
    assert m.clearcoat_factor[2] == 1.0
    assert np.all(np.asarray(m.sheen_color_factor[3]) > 0)
    assert m.anisotropy_strength[4] == pytest.approx(0.8)
    np.testing.assert_allclose(m.emissive_factor[5], [0.4, 0.4, 0.4], atol=1e-6)


def test_material_zoo_renders(zoo):
    scene, ptscene, meta, cam = zoo
    settings = S.PathTracerSettings(max_bounces=3, min_bounces=3, point_lights=False)
    img = _render(ptscene, meta, cam, settings, spp=6)
    assert np.all(np.isfinite(img))
    assert img.mean() > 0.01
    # The clearcoat sphere's red base and the sheen sphere's blue base must
    # both be visible somewhere in the frame.
    red_dominant = (img[..., 0] > 1.5 * img[..., 2]) & (img[..., 0] > 0.02)
    blue_dominant = (img[..., 2] > 1.5 * img[..., 0]) & (img[..., 2] > 0.02)
    assert red_dominant.sum() > 10, red_dominant.sum()
    assert blue_dominant.sum() > 10, blue_dominant.sum()


def test_transmission_passes_light(zoo):
    """The transmissive sphere transmits the environment: disabling
    transmission darkens/changes what's seen through it."""
    scene, ptscene, meta, cam = zoo
    base = S.PathTracerSettings(max_bounces=4, min_bounces=4, point_lights=False)
    img_t = _render(ptscene, meta, cam, base, spp=8)
    # Zero out transmission in the material table.
    m2 = ptscene.materials._replace(
        transmission_factor=jnp.zeros_like(ptscene.materials.transmission_factor)
    )
    m2 = m2._replace(rows=jnp.asarray(T.pack_material_rows(jax.tree.map(np.asarray, m2))))
    pt2 = ptscene._replace(materials=m2)
    img_o = _render(pt2, meta, cam, base, spp=8)
    glass_region_t = img_t[12:28, 6:16]
    glass_region_o = img_o[12:28, 6:16]
    assert not np.allclose(glass_region_t, glass_region_o, atol=5e-3)


@pytest.fixture(scope="module")
def foliage(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("f") / "foliage.gltf")
    write_foliage_gltf(path)
    scene, ptscene, meta = _setup(path, env=False)
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([0.0, -4.0, 1.0], [0.0, 0.0, -0.5])
    return scene, ptscene, meta, cam


def test_foliage_masked_anyhit(foliage):
    """Alpha-masked leaf: rays through alpha holes must pass to the floor
    (IgnoreHit semantics), rays hitting leaf texels must shade the leaf."""
    scene, ptscene, meta, cam = foliage
    assert meta.has_masked
    settings = S.PathTracerSettings(
        max_bounces=0, min_bounces=0, environment_map=False,
        debug_output=S.DEBUG_COLOR,
    )
    img = _render(ptscene, meta, cam, settings, spp=4, res=(48, 48))
    # Both leaf green and floor grey must appear in the leaf's screen area.
    mid = img[16:32, 16:32]
    greens = (mid[..., 1] > mid[..., 0] * 1.5).sum()
    greys = (np.abs(mid[..., 0] - mid[..., 1]) < 0.1).sum()
    assert greens > 5, greens
    assert greys > 5, greys


def test_foliage_alpha_shadows(foliage):
    """Alpha shadows: the masked leaf casts a hole-punched shadow; with
    alpha_shadows off, the shadow treats any hit as opaque.

    Binary mode occludes on ANY geometry in the way (ShadowAnyHit semantics:
    transmission starts at 0) — so the floor under the leaf is darker there."""
    scene, ptscene, meta, cam = foliage
    base = S.PathTracerSettings(
        max_bounces=1, min_bounces=1, environment_map=False,
        luminance_clamp_enabled=False,
    )
    with_alpha = _render(ptscene, meta, cam, base, spp=12, res=(48, 48))
    no_alpha = _render(
        ptscene, meta, cam, dataclasses.replace(base, alpha_shadows=False),
        spp=12, res=(48, 48),
    )
    # The shadowed floor band behind the leaf (light at world (0,-2.5,1.5)
    # crosses the leaf plane y=0 for floor points with y>0): alpha shadows
    # leak light through the mask holes -> brighter than binary shadows.
    band_a = with_alpha[24:32, :].mean()
    band_b = no_alpha[24:32, :].mean()
    assert band_a > band_b * 1.02, (band_a, band_b)
    # Outside the band the two modes agree.
    np.testing.assert_allclose(with_alpha[36:, :], no_alpha[36:, :], atol=1e-5)
