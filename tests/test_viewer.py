"""Interactive viewer (app/viewer.py): render loop + HTTP blit + input."""

import json
import time
import urllib.error
import urllib.request

import numpy as np

from tests.scenes import write_box_gltf


def test_viewer_serves_frames_and_input(tmp_path):
    from gltf_renderer.app import viewer

    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=64, height=32, port=0, block=False
    )
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"

        # Wait for the first frame.
        deadline = time.time() + 120
        png = b""
        while time.time() < deadline:
            try:
                r = urllib.request.urlopen(base + "/frame.png", timeout=5)
                png = r.read()
                break
            except Exception:
                time.sleep(0.5)
        assert png[:8] == b"\x89PNG\r\n\x1a\n"

        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"pointerdown" in page

        st = json.loads(urllib.request.urlopen(base + "/state", timeout=5).read())
        assert st["backend"] == "pathtracer"
        assert st["spp"] >= 1
        # Always-on counter ring (Tracy counter-plot analogue).
        assert st["history"] and st["history"][-1]["frame_ms"] > 0
        assert st["stats"]["scene_bytes"] > 0
        # Scene selector (glTF-tab combo, Main.cpp:190-200).
        assert st["scenes"] >= 1
        req = urllib.request.Request(
            base + "/input",
            data=json.dumps({"type": "scene", "index": 0}).encode(),
            method="POST",
        )
        assert urllib.request.urlopen(req, timeout=5).read() == b"ok"

        # Orbit input moves the camera and resets progressive accumulation
        # (reference CameraController -> accumulation reset semantics).
        # The reset is observed deterministically via the renderer's
        # reset-on-change key (HTTP polling can miss the brief low-spp
        # window on a fast CPU render).
        key0 = state.renderer._last_reset_key
        azi0 = state.orbit.azimuth
        req = urllib.request.Request(
            base + "/input", data=json.dumps({"type": "orbit", "dx": 80, "dy": 0}).encode(),
            method="POST",
        )
        assert urllib.request.urlopen(req, timeout=5).read() == b"ok"
        deadline = time.time() + 60
        while time.time() < deadline and (
            state.orbit.azimuth == azi0 or state.renderer._last_reset_key == key0
        ):
            time.sleep(0.2)
        assert state.orbit.azimuth != azi0
        assert state.renderer._last_reset_key != key0
    finally:
        state.running = False
        server.shutdown()
        thread.join(timeout=60)


def _post(base, payload):
    req = urllib.request.Request(
        base + "/input", data=json.dumps(payload).encode(), method="POST"
    )
    assert urllib.request.urlopen(req, timeout=5).read() == b"ok"


def test_viewer_fly_camera(tmp_path):
    """FreeController reachable from the app shell (CameraController.h:
    124-243): switch to fly mode (seeded seamlessly at the orbit eye),
    drive WASD key + look events over HTTP, observe the camera move."""
    from gltf_renderer.app import viewer

    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=64, height=32, port=0, block=False
    )
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        view_before = None
        deadline = time.time() + 120
        while time.time() < deadline and view_before is None:
            try:
                urllib.request.urlopen(base + "/frame.png", timeout=5)
                view_before = np.array(state.renderer.camera.world_to_view)
            except Exception:
                time.sleep(0.5)
        assert view_before is not None

        _post(base, {"type": "mode", "value": "free"})
        deadline = time.time() + 60
        while time.time() < deadline and state.cam_mode != "free":
            time.sleep(0.1)
        assert state.cam_mode == "free"
        # Seamless handoff: the free controller starts at the orbit eye with
        # the same rotation, so the view matrix is (numerically) unchanged.
        np.testing.assert_allclose(
            state.free.world_to_view(), state.orbit.world_to_view(),
            atol=1e-4)

        pos0 = np.array(state.free.position)
        speed0 = state.free.speed
        _post(base, {"type": "key", "keys": ["w", "d"], "shift": True,
                     "dt": 0.25})
        _post(base, {"type": "orbit", "dx": 40, "dy": -10})   # fly look
        _post(base, {"type": "dolly", "amount": -120})        # speed up
        deadline = time.time() + 60
        while time.time() < deadline and state.free.speed == speed0:
            time.sleep(0.1)
        assert not np.allclose(state.free.position, pos0)
        assert state.free.speed > speed0            # wheel = IncreaseSpeed
        assert state.free.azimuth != 0.0            # look drag landed
        # The renderer camera follows the fly controller now.
        assert not np.allclose(
            np.array(state.renderer.camera.world_to_view), view_before)
        st = json.loads(
            urllib.request.urlopen(base + "/state", timeout=5).read())
        assert st["cam_mode"] == "free"

        # Switching back re-activates the orbit rig.
        _post(base, {"type": "mode", "value": "orbit"})
        deadline = time.time() + 60
        while time.time() < deadline and state.cam_mode != "orbit":
            time.sleep(0.1)
        assert state.cam_mode == "orbit"
    finally:
        state.running = False
        server.shutdown()
        thread.join(timeout=60)


def test_viewer_graphics_tab(tmp_path):
    """Graphics-tab parity (Main.cpp:224-340): drive a debug-channel change
    and a bounce change end-to-end over HTTP and observe them land in the
    renderer settings + a fresh frame."""
    from gltf_renderer.app import viewer

    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=64, height=32, port=0, block=False
    )
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"

        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                urllib.request.urlopen(base + "/frame.png", timeout=5)
                break
            except Exception:
                time.sleep(0.5)

        st = json.loads(urllib.request.urlopen(base + "/state", timeout=5).read())
        assert st["settings"]["debug_output"] == 0
        assert st["settings"]["use_frame_as_seed"] is True

        # Debug channel -> shading normal (S.DEBUG_SHADING_NORMAL == 11).
        _post(base, {"type": "set", "field": "debug_output", "value": 11})
        # Bounce change + RR + exposure + luminance clamp + seed pinning.
        _post(base, {"type": "set", "field": "max_bounces", "value": 4})
        _post(base, {"type": "set", "field": "min_russian_roulette_continue_prob",
                     "value": 0.25})
        _post(base, {"type": "set", "field": "exposure", "value": 2.0})
        _post(base, {"type": "set", "field": "luminance_clamp", "value": 5.0})
        _post(base, {"type": "set", "field": "use_frame_as_seed", "value": False})
        _post(base, {"type": "set", "field": "tonemapper", "value": 0})

        deadline = time.time() + 90
        while time.time() < deadline:
            st = json.loads(urllib.request.urlopen(base + "/state", timeout=5).read())
            s = st["settings"]
            if (s["debug_output"] == 11 and s["max_bounces"] == 4
                    and s["use_frame_as_seed"] is False):
                break
            time.sleep(0.2)
        s = st["settings"]
        assert s["debug_output"] == 11
        assert s["max_bounces"] == 4
        assert s["min_russian_roulette_continue_prob"] == 0.25
        assert s["exposure"] == 2.0
        assert s["luminance_clamp"] == 5.0
        assert s["use_frame_as_seed"] is False
        assert s["tonemapper"] == 0

        # A frame rendered with the new settings arrives (debug channel 11 is
        # a normals visualization -- a recognizably different image).
        seq0 = state.frame_seq
        deadline = time.time() + 90
        while time.time() < deadline and state.frame_seq <= seq0 + 1:
            time.sleep(0.2)
        assert state.frame_seq > seq0
        assert state.renderer.settings.pt.debug_output == 11

        # min > max bounce clamps (reference slider coupling).
        _post(base, {"type": "set", "field": "min_bounces", "value": 5})
        deadline = time.time() + 30
        while time.time() < deadline and state.renderer.settings.pt.min_bounces != 5:
            time.sleep(0.2)
        assert state.renderer.settings.pt.max_bounces == 5

        # Page advertises the panel.
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"Graphics" in page and b"Debug Output" in page
    finally:
        state.running = False
        server.shutdown()
        thread.join(timeout=60)


def test_viewer_drag_drop_upload(tmp_path):
    """Drag-drop parity (Main.cpp:367-406): POST /upload with raw file bytes
    replaces the scene (.gltf/.glb) and rejects unsupported extensions."""
    from gltf_renderer.app import viewer
    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=48, height=24, port=0, block=False
    )
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"

        # Wait until the render loop is alive.
        deadline = time.time() + 120
        while time.time() < deadline and state.frame_seq == 0:
            time.sleep(0.2)
        assert state.frame_seq > 0

        # Upload a different scene as raw bytes (the browser drop handler).
        other = str(tmp_path / "other.gltf")
        write_box_gltf(other, base_color=(0.1, 0.9, 0.1, 1.0))
        body = open(other, "rb").read()
        req = urllib.request.Request(
            base + "/upload?name=dropped.gltf", data=body, method="POST"
        )
        assert urllib.request.urlopen(req, timeout=5).read() == b"ok"
        deadline = time.time() + 90
        while time.time() < deadline and "dropped.gltf" not in state.scene_path:
            time.sleep(0.2)
        assert "dropped.gltf" in state.scene_path
        assert state.renderer.scene is not None

        # Unsupported extension -> 415, scene unchanged.
        req = urllib.request.Request(
            base + "/upload?name=evil.exe", data=b"xx", method="POST"
        )
        try:
            urllib.request.urlopen(req, timeout=5)
            assert False, "expected HTTP 415"
        except urllib.error.HTTPError as e:
            assert e.code == 415

        # Page wires the drop handler.
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"drop" in page and b"/upload" in page
    finally:
        state.running = False
        server.shutdown()
        thread.join(timeout=60)


def test_viewer_drop_hdr_swaps_environment(tmp_path):
    """Dropping an .hdr replaces the ENVIRONMENT, not the scene
    (Main.cpp:367-406 drop semantics)."""
    import numpy as np_

    import jax
    from jax._src import compilation_cache as cc

    from gltf_renderer.app import viewer
    from gltf_renderer.env.hdr_io import write_hdr

    # The env build's big XLA:CPU graphs hit the persistent-cache segfault
    # inside long-lived pytest processes (see test_ssim_baseline's fixture);
    # cache off for this test.
    old_cache = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()

    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=48, height=24, port=0, block=False
    )
    try:
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while time.time() < deadline and state.frame_seq == 0:
            time.sleep(0.2)
        env0 = state.renderer.env
        scene0 = state.renderer.scene

        hdr_path = str(tmp_path / "sky.hdr")
        eq = np_.full((8, 16, 3), 0.25, np_.float32)
        eq[:4] = [2.0, 1.0, 0.5]
        write_hdr(hdr_path, eq)
        req = urllib.request.Request(
            base + "/upload?name=sky.hdr", data=open(hdr_path, "rb").read(),
            method="POST",
        )
        assert urllib.request.urlopen(req, timeout=5).read() == b"ok"
        deadline = time.time() + 90
        while time.time() < deadline and state.renderer.env is env0:
            time.sleep(0.2)
        assert state.renderer.env is not env0   # environment swapped
        assert state.renderer.scene is scene0   # scene untouched
    finally:
        state.running = False
        server.shutdown()
        # Join: tearing down the interpreter while the render thread is
        # inside an XLA env build aborts the process at exit.
        thread.join(timeout=120)
        jax.config.update("jax_enable_compilation_cache", old_cache)
        cc.reset_cache()


def test_viewer_sharded(tmp_path):
    """shard="auto" on the 8-device CPU mesh: the viewer's render thread
    runs the sharded step functions and still serves valid frames."""
    from gltf_renderer.app import viewer

    path = str(tmp_path / "box.gltf")
    write_box_gltf(path)
    server, state, thread = viewer.serve(
        path, width=64, height=32, port=0, block=False, shard="auto"
    )
    try:
        assert state.renderer.mesh is not None
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 180
        png = b""
        while time.time() < deadline:
            try:
                r = urllib.request.urlopen(base + "/frame.png", timeout=5)
                png = r.read()
                break
            except Exception:
                time.sleep(0.5)
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        state.running = False
        server.shutdown()
        thread.join(timeout=60)
