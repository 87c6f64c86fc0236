#!/usr/bin/env python
"""BASELINE config 5: courtyard (Sponza-class) @1080p path traced to 1024
accumulated spp with alpha shadows — the converged artifact.

A long render is what the renderer's checkpoint machinery exists for (renderer.save_state /
load_state, the progressive-accumulation state the reference CANNOT
persist, Pathtracer.cpp:259-272): the render runs in resumable sessions,
checkpointing every --ckpt-every frames, and can be killed/restarted at
any point.

    python tools/render_config5.py [--frames 1024] [--out docs/artifacts]

Writes: config5_courtyard.ckpt.npz (resume state), config5_courtyard.png
(tonemapped), config5_progress.json (frames, wall-clock seconds, rates).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--ckpt-every", type=int, default=32)
    ap.add_argument("--out", default="docs/artifacts")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, "config5_courtyard.ckpt.npz")
    png = os.path.join(args.out, "config5_courtyard.png")
    prog = os.path.join(args.out, "config5_progress.json")

    import bench
    import jax
    from gltf_renderer.render import settings as S
    from gltf_renderer.render.renderer import Renderer
    from gltf_renderer.camera import look_at
    from gltf_renderer.scene.procedural import write_courtyard_glb

    # The bench courtyard (BASELINE config-5 analogue: ~274k tris, alpha-
    # MASKED banners, alpha shadows on) + the bench analytic HDR sky.
    import tempfile

    d = tempfile.mkdtemp(prefix="config5_")
    glb = write_courtyard_glb(os.path.join(d, "courtyard.glb"), density=1)

    rs = S.RenderSettings(
        backend="pathtracer", width=args.width, height=args.height,
        pt=S.PathTracerSettings(max_bounces=2, min_bounces=2,
                                alpha_shadows=True),
    )
    r = Renderer(rs)
    r.load_scene(glb)
    # Same analytic sky equirect as bench.build_bench_scene.
    h, w = 256, 512
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    z = 1.0 - 2.0 * vv
    phi = 2 * np.pi * uu
    s = np.sqrt(np.maximum(1 - z * z, 0))
    d3 = np.stack([s * np.cos(phi), s * np.sin(phi), z], -1)
    sun = np.asarray([0.5, 0.3, 0.8])
    sun /= np.linalg.norm(sun)
    hotspot = 50.0 * np.maximum((d3 * sun).sum(-1), 0.0) ** 200
    sky = 0.4 + 0.6 * np.maximum(d3[..., 2], 0)
    eq = np.stack(
        [hotspot + 0.8 * sky, hotspot + 0.85 * sky, hotspot + sky], -1
    ).astype(np.float32)
    r.load_environment(eq)
    r.camera.y_fov = np.pi / 3
    r.camera.aspect_ratio = args.width / args.height
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([-9.0, 0.0, 1.7], [1.0, 0.0, 1.6])

    prior_s = 0.0
    if os.path.exists(ckpt):
        # draw one frame first so the reset key machinery and ptscene exist,
        # then restore the accumulation state over it.
        img = r.draw_frame()
        r.load_state(ckpt)
        if os.path.exists(prog):
            prior_s = float(json.load(open(prog)).get("wall_s", 0.0))
        print(f"[config5] resumed at {r.accumulated_frames} spp "
              f"({prior_s:.0f}s prior wall-clock)", flush=True)

    t0 = time.time()
    t_report = t0
    last = None
    while r.accumulated_frames < args.frames:
        last = r.draw_frame()
        if (r.accumulated_frames % args.ckpt_every == 0
                or r.accumulated_frames >= args.frames):
            r.save_state(ckpt)
            wall = prior_s + (time.time() - t0)
            state = {
                "spp": r.accumulated_frames,
                "target_spp": args.frames,
                "wall_s": round(wall, 1),
                "resolution": [args.width, args.height],
                "scene": "courtyard (Sponza-class, alpha shadows)",
                "s_per_sample_this_session": round(
                    (time.time() - t0) / max(r.accumulated_frames, 1), 3),
            }
            json.dump(state, open(prog, "w"), indent=1)
            if time.time() - t_report > 60:
                print(f"[config5] {state}", flush=True)
                t_report = time.time()
            from gltf_renderer.utils.png import save_png

            save_png(png, last)
    print(f"[config5] DONE: {r.accumulated_frames} spp in "
          f"{prior_s + time.time() - t0:.0f}s total -> {png}", flush=True)


if __name__ == "__main__":
    main()
