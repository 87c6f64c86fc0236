"""Per-debug-channel golden locks.

All 28 PT debug channels (PathTracer.lib.hlsl:806-990) rendered on the
materials zoo and compared against committed float16 goldens — a BSDF or
attribute-fetch regression pins to the EXACT channel (e.g. a broken tangent
frame trips DEBUG_SHADING_TANGENT, not a fuzzy beauty-image SSIM). This is
the cheapest per-component reference-parity evidence available without a
DX12 machine (docs/PARITY.md §12).

Regenerate (only when an image change is intentional):
    python tools/make_goldens.py debug_channels
"""

import os

import numpy as np
import pytest

from gltf_renderer.render import settings as S
from tests.golden_configs import GOLDEN_DIR, render_debug_channels

_CHANNEL_NAMES = [
    name for name, _ in sorted(
        ((n, v) for n, v in vars(S).items() if n.startswith("DEBUG_")),
        key=lambda kv: kv[1],
    )
]
assert len(_CHANNEL_NAMES) == 28 and _CHANNEL_NAMES[0] == "DEBUG_NONE"


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dbg"))
    return render_debug_channels(tmp)


@pytest.fixture(scope="module")
def golden():
    path = os.path.join(GOLDEN_DIR, "debug_channels.npz")
    return np.load(path)["channels"].astype(np.float32)


@pytest.mark.parametrize("dbg", range(28), ids=_CHANNEL_NAMES)
def test_debug_channel_matches_golden(rendered, golden, dbg):
    got = rendered[dbg]
    want = golden[dbg]
    assert got.shape == want.shape
    assert np.isfinite(got).all(), _CHANNEL_NAMES[dbg]
    # float16 storage quantization + CPU-backend numeric drift allowance;
    # any real channel regression (wrong attribute, broken frame, swapped
    # channel) moves values at the 1e-1 scale across many pixels.
    scale = np.maximum(np.abs(want), 1.0)
    err = np.abs(got - want) / scale
    assert np.percentile(err, 99.5) < 5e-3, (
        f"{_CHANNEL_NAMES[dbg]}: p99.5 rel err {np.percentile(err, 99.5):.2e}"
    )
    assert err.mean() < 1e-3, (
        f"{_CHANNEL_NAMES[dbg]}: mean rel err {err.mean():.2e}"
    )
