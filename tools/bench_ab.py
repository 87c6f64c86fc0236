#!/usr/bin/env python
"""Same-window A/B of one GLTF_* build knob on the GPU: both configs
live in ONE process (one process per card) and their steps INTERLEAVE, so
clock and power-limit drift hits both sides equally.

    python tools/bench_ab.py GLTF_QUADF32=1 [--reps 6]

Env: BENCH_SCENE / BENCH_WIDTH / BENCH_HEIGHT / BENCH_SPP as for bench.py.
Side A = the current environment (bench defaults), side B = A plus the
given knob. Prints one JSON line with per-step times and medians for both
sides; the verdict is median_b/median_a (steps are blocked, so each entry
is one full frame-step of the same seed on both sides).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ".")


def main():
    knob = None
    reps = 6
    args = sys.argv[1:]
    i = 0
    while i < len(args):
        if args[i] == "--reps":
            reps = int(args[i + 1])
            i += 2
        elif "=" in args[i]:
            knob = args[i]
            i += 1
        else:
            raise SystemExit(f"unknown arg {args[i]} (want KNOB=VAL / --reps N)")
    if knob is None:
        raise SystemExit("usage: bench_ab.py GLTF_<KNOB>=<VAL> [--reps N]")
    key, val = knob.split("=", 1)

    import jax
    import jax.numpy as jnp

    import bench
    from gltf_renderer.render import pathtracer as pt

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_ab.py measures on the GPU only")
    print(f"[ab] card: {bench.card_info()}", file=sys.stderr, flush=True)
    w = int(os.environ.get("BENCH_WIDTH", 1920))
    h = int(os.environ.get("BENCH_HEIGHT", 1080))
    spp = int(os.environ.get("BENCH_SPP", 4))

    saved = os.environ.get(key)
    scene_a, meta_a, settings, params, c2w, _ = bench.build_bench_scene(w, h)
    os.environ[key] = val
    try:
        scene_b, meta_b, settings_b, params_b, _c2w_b, _ = \
            bench.build_bench_scene(w, h)
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved

    def step(sc, meta, prm, seed):
        return pt.trace_chunked(sc, meta, settings, prm, c2w, (w, h),
                                jnp.uint32(seed), with_stats=True, spp=spp)

    t0 = time.time()
    out_a = step(scene_a, meta_a, params, 0)
    jax.block_until_ready(out_a)
    out_b = step(scene_b, meta_b, params_b, 0)
    jax.block_until_ready(out_b)
    print(f"[ab] both sides warm in {time.time() - t0:.1f}s", file=sys.stderr,
          flush=True)
    rays = float(out_a[1][0])

    ta, tb = [], []
    mean_a = mean_b = 0.0
    for r in range(reps):
        t1 = time.time()
        ia, _ = step(scene_a, meta_a, params, r + 1)
        jax.block_until_ready(ia)
        ta.append(round(time.time() - t1, 3))
        mean_a += float(jnp.mean(ia))
        t1 = time.time()
        ib, _ = step(scene_b, meta_b, params_b, r + 1)
        jax.block_until_ready(ib)
        tb.append(round(time.time() - t1, 3))
        mean_b += float(jnp.mean(ib))
        print(f"[ab] rep {r}: a={ta[-1]:.3f}s b={tb[-1]:.3f}s", file=sys.stderr,
              flush=True)

    med_a = sorted(ta)[len(ta) // 2]
    med_b = sorted(tb)[len(tb) // 2]
    print(json.dumps({
        "knob": knob,
        "card": bench.card_info(),
        "scene": os.environ.get("BENCH_SCENE", "helmet"),
        "spp": spp, "reps": reps, "rays_per_step": rays,
        "step_s_a": ta, "step_s_b": tb,
        "median_a_s": med_a, "median_b_s": med_b,
        "mrays_a": round(rays / med_a / 1e6, 3),
        "mrays_b": round(rays / med_b / 1e6, 3),
        "b_over_a": round(med_a / med_b, 4),
        "mean_radiance_a": mean_a / reps, "mean_radiance_b": mean_b / reps,
    }))


if __name__ == "__main__":
    main()
