import dataclasses

import numpy as np
import pytest

from gltf_renderer.render.renderer import Renderer
from gltf_renderer.render import settings as S
from gltf_renderer.camera import look_at
from tests.scenes import write_box_gltf, write_skinned_gltf, write_morph_gltf
from tests.test_env import _test_equirect


def _make_renderer(path, w=48, h=32, backend="pathtracer", max_bounces=1):
    settings = S.RenderSettings(
        backend=backend, width=w, height=h,
        pt=S.PathTracerSettings(max_bounces=max_bounces, min_bounces=max_bounces),
    )
    r = Renderer(settings)
    r.load_scene(path)
    r.camera.aspect_ratio = w / h
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    return r


def test_renderer_pt_box(tmp_path):
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    r = _make_renderer(path)
    img = r.draw_frame()
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8
    assert r.accumulated_frames == 1
    img2 = r.draw_frame()
    assert r.accumulated_frames == 2
    # Progressive accumulation with a static camera converges (not identical
    # noise, but valid image).
    assert img2.mean() > 0


def test_renderer_env(tmp_path):
    path = write_box_gltf(str(tmp_path / "box.gltf"), with_light=False)
    r = _make_renderer(path)
    r.load_environment(_test_equirect())
    img = r.draw_frame()
    assert img.mean() > 5  # env lights the frame


def test_renderer_accum_reset_on_camera_move(tmp_path):
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    r = _make_renderer(path)
    r.draw_frame()
    r.draw_frame()
    assert r.accumulated_frames == 2
    r.camera.world_to_view = look_at([2.2, -2.0, 1.5], [0, 0, 0])
    r.draw_frame()
    assert r.accumulated_frames == 1  # reset then one new sample


def test_renderer_skinned_animation(tmp_path):
    path = write_skinned_gltf(str(tmp_path / "skin.gltf"))
    r = _make_renderer(path, max_bounces=0)
    r.camera.world_to_view = look_at([0.0, -3.0, 1.0], [0, 0, 1.0])
    img0 = r.draw_frame(delta=0.0)
    img1 = r.draw_frame(delta=1.0)  # animation bends the strip
    assert img0.shape == img1.shape
    assert not np.array_equal(img0, img1)


def test_renderer_morph_animation(tmp_path):
    path = write_morph_gltf(str(tmp_path / "morph.gltf"))
    r = _make_renderer(path, max_bounces=0)
    img0 = r.draw_frame(delta=0.0)
    img1 = r.draw_frame(delta=1.0)  # weight 0 -> 1
    assert not np.array_equal(img0, img1)


def test_orthographic_camera(tmp_path):
    """Orthographic projection renders the box without perspective."""
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    r = _make_renderer(path, max_bounces=0)
    r.camera.type = "orthographic"
    r.camera.x_mag = 0.8
    r.camera.y_mag = 0.8
    r.camera.z_near = 0.05
    r.camera.z_far = 10.0
    img = r.draw_frame()
    assert img.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    assert img.std() > 0  # box visible against background


def test_checkpoint_resume(tmp_path):
    """Progressive accumulation survives save/load (bit-exact continuation)."""
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    r1 = _make_renderer(path)
    r1.draw_frame()
    r1.draw_frame()
    ckpt = str(tmp_path / "state.npz")
    r1.save_state(ckpt)
    expected = r1.draw_frame()  # 3rd sample

    r2 = _make_renderer(path)
    r2.draw_frame()  # prime derived state (different accumulation)
    r2.load_state(ckpt)
    assert r2.accumulated_frames == 2
    resumed = r2.draw_frame()
    np.testing.assert_array_equal(resumed, expected)


def test_free_controller():
    """FreeController fly-cam: moving forward shrinks distance to target."""
    from gltf_renderer.camera import FreeController

    fc = FreeController(position=np.asarray([0.0, -5.0, 0.0], np.float32))
    w2v0 = fc.world_to_view()
    # Looking along +y (world forward for azimuth 0): origin is 5 in front.
    p = w2v0 @ np.asarray([0, 0, 0, 1.0], np.float32)
    d0 = -p[2]  # view-space forward distance
    fc.move(forward=1.0, right=0.0, up=0.0, dt=1.0)
    p1 = fc.world_to_view() @ np.asarray([0, 0, 0, 1.0], np.float32)
    assert -p1[2] < d0
    fc.rotate(0.3, 0.1)
    assert np.isfinite(fc.world_to_view()).all()


def test_animated_camera_node(tmp_path):
    """A glTF camera riding an animated node: the view tracks the node's
    global transform per tick (Gltf.cpp:1015-1041 -> Camera.h:70-73)."""
    from tests.scenes import write_camera_anim_gltf

    path = write_camera_anim_gltf(str(tmp_path / "camanim.gltf"))
    settings = S.RenderSettings(
        backend="pathtracer", width=48, height=32,
        pt=S.PathTracerSettings(max_bounces=0, min_bounces=0),
    )
    r = Renderer(settings)
    scene = r.load_scene(path)
    assert scene.cameras, "camera def loaded"
    r.select_animation(0)
    r.select_camera(0, viewport_aspect=48 / 32)
    assert r.camera.y_fov == pytest.approx(0.8)
    img0 = r.draw_frame(delta=0.0)
    pose0 = r.camera.world_to_view.copy()
    # At t=0 the camera sits at glTF (0,0,4) looking at the box: view-space
    # position of the origin is ~(0, 0, -4).
    origin_vs = pose0 @ np.asarray([0, 0, 0, 1.0], np.float32)
    np.testing.assert_allclose(origin_vs[:3], [0.0, 0.0, -4.0], atol=1e-4)
    img1 = r.draw_frame(delta=1.0)  # camera pans +X by 2
    pose1 = r.camera.world_to_view.copy()
    assert not np.allclose(pose0, pose1), "view matrix tracked the animation"
    origin_vs1 = pose1 @ np.asarray([0, 0, 0, 1.0], np.float32)
    np.testing.assert_allclose(origin_vs1[:3], [-2.0, 0.0, -4.0], atol=1e-4)
    assert (img0 != img1).any(), "image changed with the camera animation"
    # Accumulation restarted when the camera moved.
    assert r.accumulated_frames == 1


def test_use_frame_as_seed_off(tmp_path):
    """use_frame_as_seed=False (Pathtracer.cpp:316): every accumulation pass
    reuses the pinned seed, so two passes average to the first frame."""
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    settings = S.RenderSettings(
        backend="pathtracer", width=48, height=32,
        pt=S.PathTracerSettings(max_bounces=0, min_bounces=0,
                                use_frame_as_seed=False),
    )
    r = Renderer(settings)
    r.load_scene(path)
    r.camera.aspect_ratio = 48 / 32
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    r.draw_frame()
    accum0 = np.asarray(r._accum)
    r.draw_frame()
    accum1 = np.asarray(r._accum)
    # Same seed -> identical sample -> the running-mean HDR accumulator is
    # bit-identical (only the frame-indexed tonemap dither varies per draw).
    np.testing.assert_array_equal(accum0, accum1)

    settings_on = dataclasses.replace(
        settings, pt=dataclasses.replace(settings.pt, use_frame_as_seed=True)
    )
    r2 = Renderer(settings_on)
    r2.load_scene(path)
    r2.camera.aspect_ratio = 48 / 32
    r2.camera.z_near = 0.01
    r2.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    r2.draw_frame()
    b0 = np.asarray(r2._accum)
    r2.draw_frame()
    b1 = np.asarray(r2._accum)
    assert (b0 != b1).any(), "frame-seeded accumulation jitters"


def test_multi_scene_document_select(tmp_path):
    """glTF documents with several scenes: select_scene re-plans (the UI's
    scene combo, Main.cpp:190-200); out-of-range indices raise BEFORE any
    state mutates."""
    import json

    import pytest as _pytest

    from tests.scenes import write_box_gltf

    path = str(tmp_path / "two_scenes.gltf")
    write_box_gltf(path)
    doc = json.load(open(path))
    # Scene 1: the box translated away, no light.
    doc["nodes"].append({"mesh": 0, "name": "box2", "translation": [0.0, 0.0, 3.0]})
    doc["scenes"].append({"nodes": [len(doc["nodes"]) - 1]})
    json.dump(doc, open(path, "w"))

    from gltf_renderer.render.renderer import Renderer
    from gltf_renderer.render.settings import RenderSettings

    r = Renderer(RenderSettings(width=48, height=32))
    r.load_scene(path)
    assert len(r.scene.scenes) == 2 and r.scene_id == 0
    img0 = np.asarray(r.draw_frame())

    r.select_scene(1)
    assert r.scene_id == 1
    img1 = np.asarray(r.draw_frame())
    assert np.abs(img0.astype(int) - img1.astype(int)).max() > 0

    with _pytest.raises(IndexError):
        r.select_scene(99)
    assert r.scene_id == 1  # unchanged after the failed select


def test_renderer_sharded_matches_single(tmp_path):
    """Renderer(mesh="auto") on the 8-device CPU mesh: both backends must
    match the single-device renderer (PT tiles bit-parity; raster tiles +
    backdrop all_gather)."""
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    for backend in ("pathtracer", "rasterizer"):
        imgs = {}
        for mesh in (None, "auto"):
            settings = S.RenderSettings(
                backend=backend, width=48, height=36,  # 36 % 8 != 0: pad path
                pt=S.PathTracerSettings(max_bounces=1, min_bounces=1),
            )
            r = Renderer(settings, mesh=mesh)
            r.load_scene(path)
            r.camera.aspect_ratio = 48 / 36
            r.camera.z_near = 0.01
            r.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
            imgs[mesh] = r.draw_frame()
        assert r.mesh is not None  # auto picked up the 8 virtual devices
        # u8 output: identical up to 1 count of tonemap rounding jitter.
        diff = np.abs(imgs[None].astype(int) - imgs["auto"].astype(int))
        assert diff.max() <= 1, (backend, diff.max())
