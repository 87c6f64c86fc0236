#!/usr/bin/env python
"""Smoke check of the renderer on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

One process drives the card(s); no phase falls back to the CPU or to the
Pallas interpreter. Phases (one card):
  kernel   the per-ray traversal kernel (ops/triton_trace) against the XLA
           reference (bvh.intersect_*_p) on the bench helmet at 262,144
           rays: coherent primary, incoherent bounce, shadow any-hit and a
           mixed per-lane-mode dispatch, over every cull_sign and blend_mode
           (the parity rule of triton_trace.compare_hits); per-call times.
  pt       app/cli.main path-traces the helmet GLB at 1920x1080 to a PNG;
           bench.py's fidelity probe (SSIM >= 0.995 against the CPU golden)
           and a NaN count of a 1080p frame (must be 0).
  courtyard  one 1080p path-traced frame of the ~274k-triangle courtyard
           through Renderer, alpha shadows on (alpha retry + shadow hops).
  raster   app/cli.main --backend rasterizer at 1080p (IBL, bloom, AgX).
  anim     a skinned glTF through Renderer at two animation times (skinning,
           BVH refit, pack_update), then kernel-vs-XLA parity on the refitted
           tables.
  timings  bench Mrays/s of the helmet at 1080p with each traversal route,
           selected through PTMeta.traversal (informational).
With --cards 4: render_sharded on a 1x4 tile mesh and a 2x2 sample x tile
mesh, and render_raster_sharded on 1x4, each against the single-card render
of the same seeds.

Every timing line carries the card's name and power limit (nvidia-smi).
PNGs and a JSON of the numbers go to chiprun_out/chip_smoke/. The last line
of standard output is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}; it is printed only
when every phase passed. Without a GPU the script exits non-zero at once.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

W, H = 1920, 1080
N_RAYS = 262144
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
RESULTS = {}


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return " | ".join(line.strip() for line in out.splitlines()) or "unknown"


CARD = None


def report(label, value):
    """One measurement line, with the card beside it."""
    print(f"{label}: {value}   [{CARD}]", flush=True)
    RESULTS[label] = value


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def block(x):
    import jax

    return jax.block_until_ready(x)


def median_time(fn, reps=5):
    block(fn())  # warm-up (compile)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def sky_equirect(h=256, w=512):
    """bench.py's analytic HDR sky (sun hotspot + gradient)."""
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
    return np.stack([hotspot + 0.8 * sky, hotspot + 0.85 * sky, hotspot + sky],
                    -1).astype(np.float32)


class Ctx:
    """Lazily built inputs shared by the phases."""

    def __init__(self):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        self._helmet = None

    def helmet(self):
        if self._helmet is None:
            from bench import build_bench_scene

            t0 = time.perf_counter()
            self._helmet = build_bench_scene(W, H, "helmet")
            print(f"helmet scene built in {time.perf_counter() - t0:.1f}s "
                  f"({self._helmet[5]} triangles)", flush=True)
        return self._helmet

    def helmet_glb(self):
        from gltf_renderer.scene.procedural import write_textured_sphere_glb

        path = os.path.join(self.tmp, "helmet_class.glb")
        if not os.path.exists(path):
            write_textured_sphere_glb(path, tex_size=512, n_lat=128, n_lon=192,
                                      metallic=0.3, roughness=0.45)
        return path

    def sky_hdr(self):
        from gltf_renderer.env.hdr_io import write_hdr

        path = os.path.join(self.tmp, "sky.hdr")
        if not os.path.exists(path):
            write_hdr(path, sky_equirect())
        return path


# ---------------------------------------------------------------------------
# Phase: traversal kernel against the XLA reference
# ---------------------------------------------------------------------------

def make_rays(packed, c2w, seed=0):
    """N_RAYS rays of each population on the bench helmet: primary (tile
    order, coherent, around the image centre), bounce and shadow (random directions from the primary
    hit points; misses become dead lanes)."""
    import jax
    import jax.numpy as jnp

    from gltf_renderer.ops import bvh as bvh_ops
    from gltf_renderer.render import pathtracer as pt

    px_t, py_t, _ = pt._tile_order(W, H)
    # The window of tiles around the image centre, where the helmet is.
    c = int(np.argmin(np.abs(px_t - W // 2) + np.abs(py_t - H // 2)))
    s = int(np.clip(c - N_RAYS // 2, 0, px_t.size - N_RAYS)) // 1024 * 1024
    px = jnp.asarray(px_t[s:s + N_RAYS])
    py = jnp.asarray(py_t[s:s + N_RAYS])
    o, d_raw = pt.generate_camera_rays(px, py, (W, H), c2w,
                                       jnp.zeros((N_RAYS, 2), jnp.float32))
    ln = jnp.sqrt(jnp.sum(d_raw ** 2, -1))
    d = d_raw / ln[:, None]
    zero = jnp.zeros(N_RAYS, jnp.float32)
    hit = jax.jit(bvh_ops.intersect_closest_p)(packed, o, d, zero, ln)
    hitm = hit.tri >= 0
    check(int(hitm.sum()) > N_RAYS // 10, "primary rays should see the helmet")
    p = o + d * (hit.t * 0.999)[:, None]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))

    def unit(k):
        v = jax.random.normal(k, (N_RAYS, 3), jnp.float32)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    dead_min = jnp.where(hitm, 1e-4, 1.0)
    rays = {
        "primary": (o, d, zero, ln),
        "bounce": (p, unit(k1), dead_min, jnp.where(hitm, 1e4, 0.0)),
        "shadow": (p, unit(k2), dead_min, jnp.where(hitm, 1e4, 0.0)),
    }
    bo, bd, bmin, bmax = rays["bounce"]
    so, sd, smin, smax = rays["shadow"]
    rays["mixed"] = (jnp.concatenate([bo, so]), jnp.concatenate([bd, sd]),
                     jnp.concatenate([bmin, smin]), jnp.concatenate([bmax, smax]))
    mode = jnp.concatenate([jnp.zeros(N_RAYS, jnp.int32), jnp.ones(N_RAYS, jnp.int32)])
    return rays, mode


def with_random_flags(packed, seed=1):
    """The helmet's tables with BLEND and DOUBLE_SIDED bits set on ~30% of
    the triangles each, so every blend_mode / cull_sign filter decides."""
    from gltf_renderer.ops import bvh as bvh_ops

    words = np.asarray(packed.words)
    rs = np.random.RandomState(seed)
    valid = words >= 0
    flags = (np.where(rs.rand(*words.shape) < 0.3, bvh_ops.FLAG_BLEND, 0)
             | np.where(rs.rand(*words.shape) < 0.3, bvh_ops.FLAG_DOUBLE_SIDED, 0))
    import jax.numpy as jnp

    return packed._replace(words=jnp.asarray(np.where(valid, words | flags, words)
                                             .astype(np.int32)))


def kernel_parity(packed, rays, mode, label, cases):
    """Run each (population, kind, kwargs) case through the kernel and the
    reference; raise on any parity violation."""
    import jax

    from gltf_renderer.ops import bvh as bvh_ops
    from gltf_renderer.ops import triton_trace

    closest = jax.jit(bvh_ops.intersect_closest_p,
                      static_argnames=("blend_mode", "cull_sign"))
    anyhit = jax.jit(bvh_ops.intersect_any_p,
                     static_argnames=("blend_mode", "cull_sign"))
    bad = []
    for pop, kind, kw in cases:
        o, d, t_min, t_max = rays[pop]
        name = f"{label} {pop} {kind} {kw}"
        if kind == "any":
            ref = np.asarray(anyhit(packed, o, d, t_min, t_max, **kw))
            _, word, _, _ = triton_trace.traverse(packed, o, d, t_min, t_max,
                                                  any_hit=True, **kw)
            diff = int((np.asarray(word >= 0) != ref).sum())
            rep = {"lanes": ref.size, "occluded": int(ref.sum()),
                   "occlusion_differs": diff}
            ok = diff == 0
        elif kind == "lane":
            out = triton_trace.traverse(packed, o, d, t_min, t_max,
                                        any_hit="lane", mode=mode, **kw)
            m_any = np.asarray(mode) > 0
            ref_c = closest(packed, o, d, t_min, t_max, **kw)
            cull0 = {k: v for k, v in kw.items() if k != "cull_sign"}
            ref_a = np.asarray(anyhit(packed, o, d, t_min, t_max, **cull0))
            rep = triton_trace.compare_hits(ref_c, *out, sel=~m_any)
            rep["occlusion_differs"] = int(
                ((np.asarray(out[1]) >= 0) != ref_a)[m_any].sum())
            ok = triton_trace.hits_agree(rep)
        else:
            ref = closest(packed, o, d, t_min, t_max, **kw)
            out = triton_trace.traverse(packed, o, d, t_min, t_max, **kw)
            rep = triton_trace.compare_hits(ref, *out)
            ok = triton_trace.hits_agree(rep)
        print(f"parity {name}: {'ok' if ok else 'FAIL'} {rep}", flush=True)
        RESULTS[f"parity {name}"] = rep
        if not ok:
            bad.append(name)
    check(not bad, f"kernel/XLA parity failed: {bad}")


def phase_kernel(ctx):
    import jax

    from gltf_renderer.ops import bvh as bvh_ops
    from gltf_renderer.ops import triton_trace

    ptscene, meta, _settings, _params, c2w, n_tris = ctx.helmet()
    check(meta.traversal == "kernel", f"GPU must take the kernel route, got {meta.traversal}")
    packed = ptscene.packed
    rays, mode = make_rays(packed, c2w)
    flagged = with_random_flags(packed)
    cases = ([("primary", "closest", dict(cull_sign=c)) for c in (-1, 0, 1)]
             + [("bounce", "closest", dict(blend_mode=b))
                for b in (bvh_ops.BLEND_ANY, bvh_ops.BLEND_EXCLUDE, bvh_ops.BLEND_ONLY)]
             + [("shadow", "any", {}), ("mixed", "lane", dict(cull_sign=-1))])
    kernel_parity(flagged, rays, mode, "helmet", cases)

    # Per-call times, kernel against the XLA reference.
    closest = jax.jit(bvh_ops.intersect_closest_p)
    anyhit = jax.jit(bvh_ops.intersect_any_p)
    for pop in ("primary", "bounce", "shadow"):
        o, d, t_min, t_max = rays[pop]
        any_hit = pop == "shadow"
        ref_fn = anyhit if any_hit else closest
        t_x = median_time(lambda: ref_fn(packed, o, d, t_min, t_max))
        t_k = median_time(lambda: triton_trace.traverse(
            packed, o, d, t_min, t_max, any_hit=any_hit))
        report(f"traversal {pop} {N_RAYS} rays ms (xla / kernel)",
               f"{t_x * 1e3:.3f} / {t_k * 1e3:.3f}")
    o, d, t_min, t_max = rays["bounce"]
    for blk in (64, 128, 256):
        t_k = median_time(lambda: triton_trace.traverse(
            packed, o, d, t_min, t_max, block=blk))
        report(f"kernel bounce {N_RAYS} rays ms at block {blk}", f"{t_k * 1e3:.3f}")


# ---------------------------------------------------------------------------
# Phases: end to end through the user entry points
# ---------------------------------------------------------------------------

def check_png(path, min_std=2.0):
    from gltf_renderer.utils.png import load_png

    img = load_png(path)
    check(img.shape[:2] == (H, W), f"{path}: shape {img.shape}")
    std = float(img.std())
    colors = len(np.unique(img.reshape(-1, img.shape[-1]), axis=0))
    print(f"{path}: {img.shape} mean {img.mean():.2f} std {std:.2f} "
          f"colors {colors}", flush=True)
    check(std > min_std and colors > 64, f"{path}: image is flat")


def phase_pt(ctx):
    import jax.numpy as jnp

    import bench
    from gltf_renderer.app import cli
    from gltf_renderer.render import pathtracer as pt

    out = os.path.join(OUT_DIR, "pt_helmet_1080p.png")
    t0 = time.perf_counter()
    rc = cli.main(["--gltf", ctx.helmet_glb(), "--environment-map", ctx.sky_hdr(),
                   "--width", str(W), "--height", str(H), "--spp", "4",
                   "--max-bounces", "2", "--min-bounces", "2", "--output", out])
    check(rc == 0, f"cli.main returned {rc}")
    report("cli path trace 1080p 4 spp wall s (compile included)",
           f"{time.perf_counter() - t0:.1f}")
    check_png(out)

    ptscene, meta, settings, params, c2w, _ = ctx.helmet()
    _, stats = pt.trace_chunked(ptscene, meta, settings, params, c2w, (W, H),
                                jnp.uint32(7), with_stats=True, spp=4)
    nan_pixels = float(stats[1])
    report("nan_pixels (1080p, 4 spp)", nan_pixels)
    check(nan_pixels == 0.0, "NaN/Inf radiance in the 1080p frame")
    probe = bench.render_fidelity_probe(ptscene, meta, settings, params, c2w)
    score = bench.fidelity_ssim(probe)
    report("fidelity probe SSIM vs CPU golden", score)
    check(score is not None and score >= 0.995, f"fidelity SSIM {score} < 0.995")


def phase_courtyard(ctx):
    import jax.numpy as jnp

    from gltf_renderer.camera import look_at
    from gltf_renderer.render import settings as S
    from gltf_renderer.render.renderer import Renderer
    from gltf_renderer.scene.procedural import write_courtyard_glb
    from gltf_renderer.utils.png import save_png

    path = write_courtyard_glb(os.path.join(ctx.tmp, "courtyard.glb"))
    r = Renderer(S.RenderSettings(width=W, height=H, pt=S.PathTracerSettings(
        max_bounces=2, min_bounces=2, alpha_shadows=True)))
    r.load_scene(path)
    r.load_environment(sky_equirect())
    r.camera.aspect_ratio = W / H
    r.camera.world_to_view = look_at([-9.0, 0.0, 1.7], [1.0, 0.0, 1.6])
    t0 = time.perf_counter()
    img = r.draw_frame(seed=1)
    report("courtyard 1080p frame wall s (setup + compile included)",
           f"{time.perf_counter() - t0:.1f}")
    check(r._meta.has_masked, "courtyard must carry alpha-masked geometry")
    accum = np.asarray(r._accum)
    check(np.isfinite(accum).all(), "courtyard frame has NaN/Inf pixels")
    t0 = time.perf_counter()
    r.draw_frame(seed=2)
    report("courtyard 1080p frame wall s (warm)", f"{time.perf_counter() - t0:.3f}")
    report("courtyard triangles", r.stats["triangles"])
    out = os.path.join(OUT_DIR, "pt_courtyard_1080p.png")
    save_png(out, img)
    check_png(out)


def phase_raster(ctx):
    from gltf_renderer.app import cli

    out = os.path.join(OUT_DIR, "raster_helmet_1080p.png")
    t0 = time.perf_counter()
    rc = cli.main(["--gltf", ctx.helmet_glb(), "--environment-map", ctx.sky_hdr(),
                   "--backend", "rasterizer", "--width", str(W), "--height", str(H),
                   "--output", out])
    check(rc == 0, f"cli.main --backend rasterizer returned {rc}")
    report("cli raster 1080p wall s (compile included)",
           f"{time.perf_counter() - t0:.1f}")
    check_png(out)


def phase_anim(ctx):
    import jax.numpy as jnp

    from gltf_renderer.camera import look_at
    from gltf_renderer.ops import bvh as bvh_ops
    from gltf_renderer.ops import triton_trace
    from gltf_renderer.render import pathtracer as pt
    from gltf_renderer.render import settings as S
    from gltf_renderer.render.renderer import Renderer
    from gltf_renderer.scene.procedural import write_skinned_gltf

    w, h = 960, 540
    path = write_skinned_gltf(os.path.join(ctx.tmp, "skinned.gltf"), strips=4)
    r = Renderer(S.RenderSettings(width=w, height=h, pt=S.PathTracerSettings(
        max_bounces=2, min_bounces=2)))
    r.load_scene(path)
    r.load_environment(sky_equirect())
    r.select_animation(0)
    r.player.playing = False
    r.camera.aspect_ratio = w / h
    r.camera.world_to_view = look_at([3.5, -4.0, 1.5], [0.9, 0.0, 1.0])
    frames = []
    for t in (0.0, 1.0):
        r.player.time = t
        frames.append(r.draw_frame(seed=3).astype(np.float32))
        check(np.isfinite(np.asarray(r._accum)).all(), f"NaN at animation time {t}")
    diff = float(np.abs(frames[1] - frames[0]).mean())
    report("animated frames mean |t=1 - t=0| (u8)", f"{diff:.3f}")
    check(diff > 0.05, "the skinned pose did not change the image")
    # Parity on the refitted, repacked tables of the second pose.
    packed = r._ptscene.packed
    px_t, py_t, _ = pt._tile_order(w, h)
    o, d_raw = pt.generate_camera_rays(
        jnp.asarray(px_t), jnp.asarray(py_t), (w, h),
        jnp.asarray(r.camera.clip_to_world()), jnp.zeros((px_t.size, 2), jnp.float32))
    ln = jnp.sqrt(jnp.sum(d_raw ** 2, -1))
    d = d_raw / ln[:, None]
    zero = jnp.zeros_like(ln)
    ref = bvh_ops.intersect_closest_p(packed, o, d, zero, ln)
    rep = triton_trace.compare_hits(ref, *triton_trace.traverse(packed, o, d, zero, ln))
    print(f"parity skinned (after refit): {rep}", flush=True)
    check(rep["hits"] > 100 and triton_trace.hits_agree(rep),
          f"kernel/XLA parity after refit: {rep}")


def phase_timings(ctx):
    import jax.numpy as jnp

    from gltf_renderer.render import pathtracer as pt

    ptscene, meta, settings, params, c2w, _ = ctx.helmet()
    steps, spp = 3, 4
    metas = {route: meta._replace(traversal=route) for route in ("kernel", "xla")}

    def step(route, seed):
        return pt.trace_chunked(ptscene, metas[route], settings, params, c2w, (W, H),
                                jnp.uint32(seed), with_stats=True, spp=spp)

    for route in metas:  # compile both programs before timing either
        t0 = time.perf_counter()
        block(step(route, 0))
        report(f"bench step compile+first run s ({route})",
               f"{time.perf_counter() - t0:.1f}")
    runs = {route: [] for route in metas}
    for route in ("kernel", "xla", "xla", "kernel"):
        t0 = time.perf_counter()
        outs = block([step(route, i + 1) for i in range(steps)])
        dt = time.perf_counter() - t0
        # Reduced on the host, after the window: nothing compiles inside it.
        total = sum(float(np.asarray(stats)[0]) for _, stats in outs)
        runs[route].append(total / dt / 1e6)
    for route, vals in runs.items():
        report(f"bench helmet 1080p Mrays/s ({route} route, {steps} steps x {spp} spp)",
               " / ".join(f"{v:.3f}" for v in vals))


# ---------------------------------------------------------------------------
# Four cards: the sharded paths against the single-card render
# ---------------------------------------------------------------------------

def compare_images(label, got, want):
    """Sharded vs single-card radiance -> True when they agree. The renders
    trace the same rays with the same RNG keys, but they are separate
    programs, so a few lanes may round differently and take another path.
    The rule: no NaN, at most 0.1% of pixels off by more than 1e-3 (max over
    channels), mean absolute difference below 1e-3. A wrong tile offset or
    seed schedule moves most pixels."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        print(f"{label}: shape {got.shape} vs {want.shape}", flush=True)
        return False
    err = np.abs(got - want).max(-1)
    frac = float((err > 1e-3).mean())
    mean = float(np.abs(got - want).mean())
    finite = bool(np.isfinite(got).all())
    report(f"{label}: pixels off > 1e-3, mean |diff|, max |diff|",
           f"{frac:.6f}, {mean:.3e}, {float(err.max()):.3e}")
    return finite and frac <= 1e-3 and mean < 1e-3


def phase_sharded(ctx):
    import jax
    import jax.numpy as jnp

    from gltf_renderer.parallel import distributed, sharding
    from gltf_renderer.render import pathtracer as pt
    from gltf_renderer.render import rasterizer
    from gltf_renderer.render import settings as S

    devices = jax.devices()
    check(len(devices) >= 4, f"need 4 cards, JAX sees {len(devices)}")
    ptscene, meta, settings, params, c2w, _ = ctx.helmet()
    seed = 5
    single = jax.jit(lambda sc, s: pt.trace(sc, meta, settings, params, c2w, (W, H), s))
    ref1 = np.asarray(single(ptscene, jnp.uint32(seed)))
    agree = {}  # every comparison runs, then the phase fails on any

    for n_sample, n_tile in ((1, 4), (2, 2)):
        mesh = sharding.make_mesh(n_sample=n_sample, n_tile=n_tile)
        scene_g = distributed.replicate(ptscene, mesh)
        leaves = [x for x in jax.tree.leaves(scene_g) if isinstance(x, jax.Array)]
        check(all(set(x.devices()) == set(mesh.devices.flat) for x in leaves),
              "a scene array is not replicated over every card of the mesh")
        fn = jax.jit(lambda sc, s, mesh=mesh: sharding.render_sharded(
            sc, meta, settings, params, c2w, (W, H), s, mesh))
        t0 = time.perf_counter()
        got = np.asarray(fn(scene_g, jnp.uint32(seed)))
        report(f"render_sharded {n_sample}x{n_tile} first call s",
               f"{time.perf_counter() - t0:.1f}")
        if n_sample == 1:
            want = ref1
        else:
            s2 = (seed + 0x9E3779B9) & 0xFFFFFFFF
            want = 0.5 * (ref1 + np.asarray(single(ptscene, jnp.uint32(s2))))
        label = f"render_sharded {n_sample}x{n_tile} vs one card"
        agree[label] = compare_images(label, got, want)

    rs = S.RenderSettings(backend="rasterizer", width=W, height=H)
    cam_pos = jnp.asarray([1.1, -1.1, 0.6], jnp.float32)
    mesh = sharding.make_mesh(n_sample=1, n_tile=4)
    scene_g = distributed.replicate(ptscene, mesh)
    want = np.asarray(jax.jit(lambda sc: rasterizer.render(
        sc, meta, rs, params, c2w, cam_pos, (W, H), 0))(ptscene))
    got = np.asarray(jax.jit(lambda sc: sharding.render_raster_sharded(
        sc, meta, rs, params, c2w, cam_pos, (W, H), 0, mesh))(scene_g))
    label = "render_raster_sharded 1x4 vs one card"
    agree[label] = compare_images(label, got, want)
    check(all(agree.values()),
          f"differs from one card: {[k for k, ok in agree.items() if not ok]}")


PHASES = {
    "kernel": phase_kernel,
    "pt": phase_pt,
    "courtyard": phase_courtyard,
    "raster": phase_raster,
    "anim": phase_anim,
    "timings": phase_timings,
}


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths over four cards")
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of: " + ",".join(PHASES))
    args = ap.parse_args(argv)

    try:
        import jax

        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import bench  # noqa: F401
        from gltf_renderer.utils.cache import enable_compilation_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the renderer ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              "this check runs only on the card", file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    CARD = card_info()
    print(f"card: {CARD}", flush=True)
    print(f"jax {jax.__version__}; devices: {[d.device_kind for d in devices]}",
          flush=True)
    enable_compilation_cache()
    os.makedirs(OUT_DIR, exist_ok=True)

    from gltf_renderer.ops import bvh as bvh_ops

    if args.cards == 4:
        selected = {"sharded": phase_sharded}
    elif args.phases == "all":
        selected = dict(PHASES)
    else:
        selected = {p: PHASES[p] for p in args.phases.split(",")}
    ctx = Ctx()
    failed = []
    t_all = time.perf_counter()
    check_native = bvh_ops._load_native() is not None
    print(f"native BVH builder in use: {check_native}", flush=True)
    if not check_native:
        failed.append("native-builder")
    for name, fn in selected.items():
        t0 = time.perf_counter()
        print(f"[phase {name}] start", flush=True)
        try:
            fn(ctx)
            print(f"[phase {name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"[phase {name}] FAILED after {time.perf_counter() - t0:.1f}s",
                  flush=True)
            failed.append(name)
    RESULTS["card"] = CARD
    RESULTS["failed"] = failed
    RESULTS["seconds"] = time.perf_counter() - t_all
    with open(os.path.join(OUT_DIR, f"results_cards{args.cards}.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", flush=True)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
