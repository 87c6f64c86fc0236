"""Cross-validation: rasterizer vs converged path tracer on the same scene
(SURVEY.md §4 — the reference's implicit golden check), plus SSIM helper.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gltf_renderer.env import environment as E
from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import rasterizer
from gltf_renderer.render import settings as S
from gltf_renderer.scene import flatten
from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.camera import Camera, look_at
from tests.scenes import write_box_gltf


def ssim(a, b, c1=0.01**2, c2=0.03**2):
    """Global SSIM (single window) on luminance — adequate for small frames."""
    la = a.mean(-1)
    lb = b.mean(-1)
    mu_a, mu_b = la.mean(), lb.mean()
    va, vb = la.var(), lb.var()
    cov = ((la - mu_a) * (lb - mu_b)).mean()
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s") / "box.gltf")
    # Diffuse-ish box so raster's split-sum IBL approximation is tight.
    write_box_gltf(path, base_color=(0.6, 0.55, 0.5, 1.0), roughness=1.0, with_light=False)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    # Smooth low-dynamic-range environment for small MC noise.
    h, w = 32, 64
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    z = 1.0 - 2.0 * vv
    eq = np.stack(
        [0.5 + 0.2 * z, 0.5 + 0.1 * z, 0.5 - 0.1 * z], -1
    ).astype(np.float32)
    env = E.build_environment(eq, cube_size=32)
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
        env=env,
    )
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    return ptscene, meta, cam


def test_raster_vs_pathtracer_ssim(setup):
    ptscene, meta, cam = setup
    res = 32
    c2w = jnp.asarray(cam.clip_to_world())

    raster = np.asarray(
        rasterizer.render(
            ptscene, meta, S.RenderSettings(), S.PathTracerParams(), c2w,
            jnp.asarray(cam.position()), (res, res), jnp.uint32(0),
        )
    )

    settings = S.PathTracerSettings(
        max_bounces=3, min_bounces=3, point_lights=False, luminance_clamp_enabled=False
    )
    trace_j = jax.jit(pt.trace, static_argnums=(1, 2, 5))
    acc = np.zeros((res, res, 3), np.float64)
    spp = 48
    for s in range(spp):
        acc += np.asarray(
            trace_j(ptscene, meta, settings, S.PathTracerParams(), c2w, (res, res),
                    jnp.uint32(s))
        )
    traced = acc / spp

    s = ssim(raster, traced)
    assert s > 0.9, s
    # Mean intensity agreement (split-sum vs ground truth) within 15%.
    rel = abs(raster.mean() - traced.mean()) / traced.mean()
    assert rel < 0.15, (raster.mean(), traced.mean())


@pytest.fixture(scope="module")
def setup_multislot(tmp_path_factory):
    """Multi-texture-slot scene (albedo + UV1 occlusion): locks the
    compact-row addressing shared by both backends (a raster call that reads
    compact rows with full-row offsets mis-addresses every slot past the
    first — the round-3 bug this guards against)."""
    from gltf_renderer.scene.procedural import write_multiuv_gltf

    path = str(tmp_path_factory.mktemp("m") / "multiuv.gltf")
    write_multiuv_gltf(path)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
    pools = jax.tree.map(jnp.asarray, scene.pools)
    world = flatten.build_world_geometry(
        pools, plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)), tri_flags
    )
    lights = flatten.gather_lights(scene, tf)
    h, w = 32, 64
    vv = ((np.arange(h) + 0.5) / h)[:, None] * np.ones((1, w))
    z = 1.0 - 2.0 * vv
    eq = np.stack([0.5 + 0.2 * z, 0.5 + 0.1 * z, 0.5 - 0.1 * z], -1).astype(np.float32)
    env = E.build_environment(eq, cube_size=32)
    ptscene, meta = pt.make_pt_scene(
        world, jax.tree.map(jnp.asarray, scene.materials),
        jax.tree.map(jnp.asarray, scene.textures), jax.tree.map(jnp.asarray, lights),
        env=env,
    )
    cam = Camera(y_fov=np.pi / 3, aspect_ratio=1.0, z_near=0.01)
    cam.world_to_view = look_at([1.5, -1.5, 1.2], [0, 0, 0])
    return scene, ptscene, meta, cam


def test_multislot_raster_vs_pt(setup_multislot):
    """Raster vs converged PT on a scene with >= 2 used texture slots."""
    scene, ptscene, meta, cam = setup_multislot
    assert len(meta.used_slots) >= 2, meta.used_slots
    res = 32
    c2w = jnp.asarray(cam.clip_to_world())
    raster = np.asarray(
        rasterizer.render(
            ptscene, meta, S.RenderSettings(), S.PathTracerParams(), c2w,
            jnp.asarray(cam.position()), (res, res), jnp.uint32(0),
        )
    )
    settings = S.PathTracerSettings(
        max_bounces=3, min_bounces=3, point_lights=False,
        luminance_clamp_enabled=False,
    )
    trace_j = jax.jit(pt.trace, static_argnums=(1, 2, 5))
    acc = np.zeros((res, res, 3), np.float64)
    spp = 48
    for s in range(spp):
        acc += np.asarray(
            trace_j(ptscene, meta, settings, S.PathTracerParams(), c2w,
                    (res, res), jnp.uint32(s))
        )
    traced = acc / spp
    s = ssim(raster, traced)
    assert s > 0.85, s
    rel = abs(raster.mean() - traced.mean()) / traced.mean()
    assert rel < 0.15, (raster.mean(), traced.mean())


def test_compact_rows_match_full_rows(setup_multislot):
    """sample_slots_fused(compact=True) on the PT scene's compacted rows ==
    the same slots sampled from the loader's FULL rows (compact=False)."""
    from gltf_renderer.ops.material import sample_slots_fused

    scene, ptscene, meta, _cam = setup_multislot
    slots = meta.used_slots
    n = 64
    rng = np.random.RandomState(7)
    uv = jnp.asarray(rng.rand(n, 2).astype(np.float32))
    for mat in range(int(np.asarray(scene.materials.rows).shape[0])):
        ids = jnp.full(n, mat, jnp.int32)
        row_c = ptscene.materials.rows[ids]
        out_c = sample_slots_fused(row_c, ptscene.textures, slots, uv, uv,
                                   slots, True)
        row_f = jnp.asarray(scene.materials.rows)[ids]
        out_f = sample_slots_fused(row_f, ptscene.textures, slots, uv, uv,
                                   slots, False)
        for s in slots:
            np.testing.assert_allclose(
                np.asarray(out_c[s][0]), np.asarray(out_f[s][0]),
                atol=1e-6, err_msg=f"slot {s} material {mat}")
            np.testing.assert_array_equal(
                np.asarray(out_c[s][1]), np.asarray(out_f[s][1]))
