"""Multi-chip correctness on the emulated 8-device CPU mesh (SURVEY.md §4):
the sharded render must match the single-device render."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gltf_renderer.parallel import sharding
from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import settings as S
from gltf_renderer.scene import flatten
from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.camera import Camera, look_at
from tests.scenes import write_box_gltf


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scenes") / "box.gltf")
    write_box_gltf(path)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
    )
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    return ptscene, meta, cam


def test_tile_sharded_matches_single(setup):
    ptscene, meta, cam = setup
    settings = S.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False)
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    res = (32, 32)

    single = np.asarray(
        pt.trace(ptscene, meta, settings, params, c2w, res, jnp.uint32(3))
    )
    mesh = sharding.make_mesh(n_sample=1, n_tile=8)
    fn = jax.jit(
        lambda sc, c, s: sharding.render_sharded(sc, meta, settings, params, c, res, s, mesh)
    )
    shard = np.asarray(fn(ptscene, c2w, jnp.uint32(3)))
    np.testing.assert_allclose(shard, single, atol=2e-5)


def test_tile_sharded_nondivisible_height(setup):
    """Heights that don't divide the tile axis pad up and crop (the round-3
    assert is gone): live rows stay bit-identical to single-device."""
    ptscene, meta, cam = setup
    settings = S.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False)
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    res = (32, 36)  # 36 % 8 != 0 -> tile_h = 5, two pad rows cropped

    single = np.asarray(
        pt.trace(ptscene, meta, settings, params, c2w, res, jnp.uint32(3))
    )
    mesh = sharding.make_mesh(n_sample=1, n_tile=8)
    fn = jax.jit(
        lambda sc, c, s: sharding.render_sharded(sc, meta, settings, params, c, res, s, mesh)
    )
    shard = np.asarray(fn(ptscene, c2w, jnp.uint32(3)))
    assert shard.shape == (36, 32, 3)
    np.testing.assert_allclose(shard, single, atol=2e-5)


def test_raster_sharded_matches_single(tmp_path_factory):
    """Raster backend multi-chip path: one sharded DrawScene frame (opaque +
    background + transmission backdrop all_gather + blend layers) must match
    the single-device frame bit-for-bit-close on the 8-device CPU mesh."""
    from gltf_renderer.env.environment import build_environment
    from gltf_renderer.render import rasterizer
    from gltf_renderer.scene.procedural import write_materials_gltf
    from tests.test_env import _test_equirect

    path = str(tmp_path_factory.mktemp("scenes") / "zoo.gltf")
    write_materials_gltf(path)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    env = build_environment(_test_equirect(16, 32), cube_size=16)
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
        env=env,
    )
    assert meta.has_blend, "materials zoo must exercise the backdrop all_gather"
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([0.0, -6.0, 2.0], [0, 0, 0])
    c2w = jnp.asarray(cam.clip_to_world())
    cam_pos = jnp.asarray([0.0, -6.0, 2.0], jnp.float32)
    rs = S.RenderSettings()
    params = S.PathTracerParams()
    res = (32, 36)  # non-divisible height on the raster path too

    single = np.asarray(rasterizer.render(
        ptscene, meta, rs, params, c2w, cam_pos, res, 0
    ))
    mesh = sharding.make_mesh(n_sample=1, n_tile=8)
    fn = jax.jit(lambda sc, c: sharding.render_raster_sharded(
        sc, meta, rs, params, c, cam_pos, res, 0, mesh
    ))
    shard = np.asarray(fn(ptscene, c2w))
    assert shard.shape == single.shape == (36, 32, 3)
    np.testing.assert_allclose(shard, single, atol=2e-5)


def test_distributed_single_process_and_replicate(setup):
    """Multi-host story (SURVEY §2.3): initialize() is a no-op single-
    process; replicate() produces globally-replicated arrays that feed
    render_sharded unchanged."""
    from gltf_renderer.parallel import distributed

    idx, count = distributed.initialize()
    assert (idx, count) == (0, 1)

    ptscene, meta, cam = setup
    settings = S.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False)
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    res = (32, 32)
    mesh = sharding.make_mesh(n_sample=1, n_tile=8)
    scene_g = distributed.replicate(ptscene, mesh)
    leaf = scene_g.packed.nodes
    assert leaf.sharding.is_fully_replicated
    single = np.asarray(
        pt.trace(ptscene, meta, settings, params, c2w, res, jnp.uint32(3))
    )
    shard = np.asarray(sharding.render_sharded(
        scene_g, meta, settings, params, c2w, res, jnp.uint32(3), mesh
    ))
    np.testing.assert_allclose(shard, single, atol=2e-5)


def test_sample_sharded_mean(setup):
    ptscene, meta, cam = setup
    settings = S.PathTracerSettings(max_bounces=1, min_bounces=1, environment_map=False)
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    res = (32, 32)

    mesh = sharding.make_mesh(n_sample=4, n_tile=2)
    fn = jax.jit(
        lambda sc, c, s: sharding.render_sharded(sc, meta, settings, params, c, res, s, mesh)
    )
    shard = np.asarray(fn(ptscene, c2w, jnp.uint32(11)))
    # Mean over 4 independent sample seeds computed manually.
    singles = []
    for k in range(4):
        s = (11 + k * 0x9E3779B9) & 0xFFFFFFFF
        singles.append(
            np.asarray(pt.trace(ptscene, meta, settings, params, c2w, res, jnp.uint32(s)))
        )
    np.testing.assert_allclose(shard, np.mean(singles, 0), atol=1e-4)
