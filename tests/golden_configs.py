"""The five BASELINE.json config stand-ins as deterministic small renders.

Shared by tools/make_goldens.py (golden generation) and
tests/test_ssim_baseline.py (the >=0.99-SSIM gate). Each config returns a
tonemapped (H, W, 3) u8 frame rendered with pinned seeds, so a re-render on
the same backend is reproducible and any image-affecting regression trips
the SSIM gate.

Configs (BASELINE.json "configs"; official assets are not fetchable in this
offline environment — docs/PARITY.md "BASELINE assets" notes the stand-ins):
  1 box_raster      Box raster 256x256, one KHR punctual light, no textures
  2 helmet_raster   textured-sphere GLB raster + HDR env IBL + AgX + bloom
  3 anim_pose       skinned strip + morph cube mid-animation (t=0.5)
  4 materials_pt    material-zoo path traced (transmission/clearcoat/sheen,
                    NEE+MIS+RR)
  5 courtyard_pt    Sponza-class courtyard path traced, env importance
                    sampling, alpha shadows
"""

from __future__ import annotations

import os

import numpy as np

from gltf_renderer.camera import look_at
from gltf_renderer.render import settings as S
from gltf_renderer.render.renderer import Renderer


def _analytic_equirect(h=32, w=64):
    """Smooth low-dynamic-range environment (matches tests/test_env.py)."""
    v = (np.arange(h) + 0.5) / h
    z = 1.0 - 2.0 * v
    eq = np.stack(
        [0.5 + 0.2 * z, 0.5 + 0.1 * z, 0.5 - 0.1 * z], -1
    ).astype(np.float32)
    return np.broadcast_to(eq[:, None, :], (h, w, 3)).copy()


def _renderer(path, w, h, backend, pt_kw=None, env=False):
    settings = S.RenderSettings(
        backend=backend, width=w, height=h,
        pt=S.PathTracerSettings(**(pt_kw or {})),
    )
    r = Renderer(settings)
    r.load_scene(path)
    if env:
        r.load_environment(_analytic_equirect())
    r.camera.aspect_ratio = w / h
    r.camera.z_near = 0.01
    return r


def _pt_frames(r, spp):
    img = None
    for _ in range(spp):
        img = r.draw_frame()
    return img


def render_box_raster(tmp):
    from tests.scenes import write_box_gltf

    path = write_box_gltf(os.path.join(tmp, "box.gltf"))
    r = _renderer(path, 256, 256, "rasterizer")
    r.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    return r.draw_frame()


def render_helmet_raster(tmp):
    from tests.scenes import write_textured_sphere_glb

    path = write_textured_sphere_glb(os.path.join(tmp, "sphere.glb"),
                                     metallic=0.4, roughness=0.35)
    r = _renderer(path, 192, 108, "rasterizer", env=True)
    r.camera.world_to_view = look_at([1.2, -1.2, 0.8], [0, 0, 0])
    return r.draw_frame()


def render_anim_pose(tmp):
    from tests.scenes import write_morph_gltf, write_skinned_gltf

    path = write_skinned_gltf(os.path.join(tmp, "skin.gltf"))
    r = _renderer(path, 128, 96, "pathtracer",
                  pt_kw=dict(max_bounces=1, min_bounces=1))
    r.select_animation(0)
    r.camera.world_to_view = look_at([0.0, -3.0, 1.0], [0, 0, 1.0])
    r.draw_frame(delta=0.5)  # advance to mid-animation pose
    skinned = _pt_frames(r, 3)

    path2 = write_morph_gltf(os.path.join(tmp, "morph.gltf"))
    r2 = _renderer(path2, 128, 96, "pathtracer",
                   pt_kw=dict(max_bounces=1, min_bounces=1))
    r2.select_animation(0)
    r2.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    r2.draw_frame(delta=0.5)
    morphed = _pt_frames(r2, 3)
    return np.concatenate([skinned, morphed], axis=1)


def render_materials_pt(tmp):
    from tests.scenes import write_materials_gltf

    path = write_materials_gltf(os.path.join(tmp, "zoo.gltf"))
    r = _renderer(path, 160, 120, "pathtracer",
                  pt_kw=dict(max_bounces=2, min_bounces=2), env=True)
    r.camera.world_to_view = look_at([0.0, -6.0, 3.0], [0.0, 0.0, 0.5])
    return _pt_frames(r, 8)


def render_courtyard_pt(tmp):
    from gltf_renderer.scene.procedural import write_courtyard_glb

    path = write_courtyard_glb(os.path.join(tmp, "courtyard.glb"), tex_size=64)
    r = _renderer(path, 128, 72, "pathtracer",
                  pt_kw=dict(max_bounces=2, min_bounces=2, alpha_shadows=True),
                  env=True)
    # Same interior colonnade view as bench.py's courtyard config.
    r.camera.world_to_view = look_at([-9.0, 0.0, 1.7], [1.0, 0.0, 1.6])
    return _pt_frames(r, 2)


def render_debug_channels(tmp, res=(64, 48)):
    """All 28 PT debug channels (PathTracer.lib.hlsl:806-990 switch) on the
    materials zoo: raw per-channel float images BEFORE tonemap, the cheapest
    reference-parity evidence per channel — a BSDF/attribute regression pins
    to the exact channel instead of washing into a beauty-render SSIM.

    Returns (28, h, w, 3) float32 (channel 0 = DEBUG_NONE beauty render).
    """
    import jax.numpy as jnp

    from gltf_renderer.render import pathtracer as pt
    from tests.scenes import write_materials_gltf

    path = write_materials_gltf(os.path.join(tmp, "zoo.gltf"))
    r = _renderer(path, res[0], res[1], "pathtracer", env=True)
    r.camera.world_to_view = look_at([0.0, -6.0, 3.0], [0.0, 0.0, 0.5])
    r.draw_frame()  # builds PTScene/meta once; reused across channel renders
    c2w = jnp.asarray(r.camera.clip_to_world())
    out = []
    for dbg in range(28):
        settings = S.PathTracerSettings(
            max_bounces=1, min_bounces=1, debug_output=dbg
        )
        img = pt.trace(
            r._ptscene, r._meta, settings, S.PathTracerParams(), c2w, res,
            jnp.uint32(5),
        )
        out.append(np.asarray(img, np.float32))
    return np.stack(out)


CONFIGS = {
    "box_raster": render_box_raster,
    "helmet_raster": render_helmet_raster,
    "anim_pose": render_anim_pose,
    "materials_pt": render_materials_pt,
    "courtyard_pt": render_courtyard_pt,
}

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
