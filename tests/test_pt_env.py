"""Integration: path tracer + environment importance sampling + MIS.

The estimator check: with an HDR environment, rendering with environment
NEE+MIS enabled must converge to the same mean image as BSDF-sampling-only —
MIS reweights but must not bias (PathTracer.lib.hlsl:928-942, 1043-1047).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gltf_renderer.env import environment as E
from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import settings as S
from gltf_renderer.scene import flatten
from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.camera import Camera, look_at
from tests.scenes import write_box_gltf
from tests.test_env import _test_equirect


@pytest.fixture(scope="module")
def env_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scenes") / "box.gltf")
    write_box_gltf(path, base_color=(0.7, 0.7, 0.7, 1.0), roughness=0.9, with_light=False)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    env = E.build_environment(_test_equirect(), cube_size=64)
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
        env=env,
    )
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([1.8, -1.8, 1.2], [0.0, 0.0, 0.0])
    return ptscene, meta, cam


def _mean_render(ptscene, meta, cam, settings, spp, res=32):
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    trace_j = jax.jit(pt.trace, static_argnums=(1, 2, 5))
    acc = np.zeros((res, res, 3), np.float64)
    for s in range(spp):
        acc += np.asarray(
            trace_j(ptscene, meta, settings, params, c2w, (res, res), jnp.uint32(s))
        )
    return acc / spp


def test_env_miss_background(env_scene):
    ptscene, meta, cam = env_scene
    settings = S.PathTracerSettings(max_bounces=0, min_bounces=0, environment_mis=False)
    img = _mean_render(ptscene, meta, cam, settings, 4)
    assert np.all(np.isfinite(img))
    # Background pixels show the env (bright-ish, colorful).
    assert img[0, 0].max() > 0.05


def test_env_mis_unbiased(env_scene):
    ptscene, meta, cam = env_scene
    spp = 48
    base = S.PathTracerSettings(
        max_bounces=2, min_bounces=2, luminance_clamp_enabled=False, point_lights=False
    )
    import dataclasses

    with_mis = _mean_render(ptscene, meta, cam, base, spp)
    no_nee = _mean_render(
        ptscene, meta, cam, dataclasses.replace(base, environment_mis=False), spp
    )
    # Means must agree within MC noise on the lit box area.
    a = with_mis[8:24, 8:24].mean(axis=(0, 1))
    b = no_nee[8:24, 8:24].mean(axis=(0, 1))
    rel = np.abs(a - b) / np.maximum(b, 1e-3)
    assert np.all(rel < 0.12), (a, b)


def test_env_nee_reduces_variance(env_scene):
    """Sanity: NEE should not catastrophically increase variance."""
    ptscene, meta, cam = env_scene
    base = S.PathTracerSettings(
        max_bounces=1, min_bounces=1, luminance_clamp_enabled=False, point_lights=False
    )
    params = S.PathTracerParams()
    c2w = jnp.asarray(cam.clip_to_world())
    trace_j = jax.jit(pt.trace, static_argnums=(1, 2, 5))
    frames = np.stack([
        np.asarray(trace_j(ptscene, meta, base, params, c2w, (32, 32), jnp.uint32(s)))
        for s in range(16)
    ])
    var = frames.var(0).mean()
    assert np.isfinite(var)
