"""Regenerate the committed BASELINE-config goldens (tests/goldens/*.png).

Run on the CPU backend (tests compare on CPU):

    python tools/make_goldens.py [config ...]

Only rerun this when an image CHANGE is intentional; the SSIM gate in
tests/test_ssim_baseline.py exists to catch unintentional ones.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from gltf_renderer.utils.png import save_png  # noqa: E402
from tests.golden_configs import CONFIGS, GOLDEN_DIR  # noqa: E402


def make_bench_fidelity():
    """CPU golden for bench.py's cross-backend SSIM probe (float npy).

    The golden is the FULL-PRECISION reference: perf table knobs (quad
    atlas is bit-exact but forced off anyway; bf16 attr rows are real
    quantization) are disabled for the golden render so the bench probe
    under perf defaults measures total image degradation."""
    import numpy as np

    import bench as bench_mod

    saved = {k: os.environ.get(k) for k in
             ("GLTF_QUAD", "GLTF_BF16ROWS", "GLTF_QUADF32")}
    os.environ["GLTF_QUAD"] = "0"
    os.environ["GLTF_BF16ROWS"] = "0"
    os.environ["GLTF_QUADF32"] = "1"  # f32 cube quads: the golden stays
    # full-precision so the bench probe measures the f16 table quantization
    try:
        w, h = bench_mod.FIDELITY_RES
        scene, meta, settings, params, c2w, _ = bench_mod.build_bench_scene(w, h)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    probe = bench_mod.render_fidelity_probe(scene, meta, settings, params, c2w)
    np.save(bench_mod.FIDELITY_GOLDEN, probe.astype(np.float16))
    return probe.shape, bench_mod.FIDELITY_GOLDEN


def make_debug_channels():
    """Per-debug-channel golden lock (28 raw float images, float16 npz)."""
    import numpy as np

    from tests.golden_configs import render_debug_channels

    with tempfile.TemporaryDirectory() as tmp:
        stack = render_debug_channels(tmp)
    out = os.path.join(GOLDEN_DIR, "debug_channels.npz")
    np.savez_compressed(out, channels=stack.astype(np.float16))
    return stack.shape, out


def main(argv):
    names = argv or (list(CONFIGS) + ["bench_fidelity", "debug_channels"])
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in names:
        t0 = time.time()
        if name == "bench_fidelity":
            shape, out = make_bench_fidelity()
            print(f"{name}: {shape} -> {out} ({time.time() - t0:.1f}s)")
            continue
        if name == "debug_channels":
            shape, out = make_debug_channels()
            print(f"{name}: {shape} -> {out} ({time.time() - t0:.1f}s)")
            continue
        with tempfile.TemporaryDirectory() as tmp:
            img = CONFIGS[name](tmp)
        out = os.path.join(GOLDEN_DIR, f"{name}.png")
        save_png(out, img)
        print(f"{name}: {img.shape} -> {out} ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main(sys.argv[1:])
