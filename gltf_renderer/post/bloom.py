"""Dual-filter bloom (Bjørge, "Bandwidth-Efficient Rendering").

Port of Bloom.cpp:57-164 + BloomDownsample/Upsample.cs.hlsl: half-res 5-tap
downsample chain, 9-tap tent upsample chain that OVERWRITES intermediate mips
(upsample input_scale=1 / output_scale=0, Bloom.cpp:137-141), final composite
image += strength * tent(mip0). No threshold — physically-ish energy bloom.

At the exact 2x mip ratios every tap lands on integer or quarter-pixel
offsets, so both filters compile to SHIFTED-SLICE arithmetic or small
convolutions on edge-padded crops instead of per-pixel gathers. Odd mip
edges use edge-clamp padding (equivalent to
the sampler's clamp addressing; the bottom/right odd row of an odd-sized mip
is dropped, a sub-texel deviation from non-integer-ratio bilinear scaling).

LAYOUT note: the whole chain runs PLANAR (3, H, W), so W is the minor,
contiguous dimension of every intermediate (chosen before the GPU port,
where channel-last padded badly; not yet measured on the H100). All
shifted-slice helpers therefore
operate on the LAST TWO axes of (..., H, W) arrays; `bloom` transposes once
at entry and once at exit.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp


def _bilinear(img, u, v):
    """Bilinear sample of (H, W, 3) at uv in [0,1], clamp addressing.

    Gather-based general-ratio path (kept for callers resampling at
    arbitrary ratios, e.g. the Jimenez 13-tap at odd sizes and tests)."""
    h, w = img.shape[0], img.shape[1]
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]

    def fetch(xi, yi):
        return img[jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def _uv_grid(h, w):
    v = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    u = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    uu, vv = jnp.meshgrid(u, v, indexing="xy")
    return uu, vv


def _box2(img):
    """Mean of each 2x2 block == bilinear center tap at the 2x ratio.

    Operates on the last two axes of (..., H, W)."""
    return 0.25 * (
        img[..., 0::2, 0::2] + img[..., 1::2, 0::2]
        + img[..., 0::2, 1::2] + img[..., 1::2, 1::2]
    )


def _pad1(img):
    """Edge-clamp pad the last two axes by 1 (shared by every shifted tap —
    ONE copy)."""
    pad_width = ((0, 0),) * (img.ndim - 2) + ((1, 1), (1, 1))
    return jnp.pad(img, pad_width, mode="edge")


def _shifted(pad, h, w, dy, dx):
    """(dy, dx)-shifted h x w view (last two axes) of a _pad1-padded array."""
    return pad[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


@functools.lru_cache(maxsize=1)
def _down_conv_kernel():
    """The 5-tap-of-2x2-boxes downsample as ONE 4x4 stride-2 conv kernel
    (taps land on the integer grid at the exact 2x ratio): center 2x2 box
    (weight 4/8 * 1/4) + four diagonal 2x2 boxes (1/8 * 1/4 each)."""
    k = np.full((4, 4), 1.0 / 32.0, np.float32)
    k[1:3, 1:3] = 5.0 / 32.0
    return k


def _conv2(img, kernel, stride, lhs_dilation=(1, 1), padding=((0, 0), (0, 0))):
    """Depthwise 2D conv on (..., H, W): leading axes fold into conv BATCH
    (identical kernel per channel), so XLA sees a plain NCHW C=1 conv."""
    import jax.lax as lax

    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    w = jnp.asarray(kernel)[None, None]
    # Full f32: the bloom pyramid matches the CPU reference to f32
    # rounding (TF32 would add ~1e-3 relative error per level).
    out = lax.conv_general_dilated(
        x, w, stride, padding, lhs_dilation=lhs_dilation,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(lead + out.shape[-2:])


def _downsample_p(img, out_h, out_w):
    """Planar 2x fast path of `downsample` on (..., H, W).

    ONE stride-2 conv on the edge-padded crop instead of the shifted-slice
    formulation (pads + stride-2 slices): the conv is one op."""
    crop = img[..., : 2 * out_h, : 2 * out_w]
    return _conv2(_pad1(crop), _down_conv_kernel(), (2, 2))


def downsample(img, out_h, out_w):
    """BloomDownsample.cs.hlsl: 4*center + 4 diagonal taps at ±0.5 texel.

    img is channel-last (H, W, C); the 2x fast path runs planar internally.
    """
    h, w = img.shape[0], img.shape[1]
    if h >= 2 * out_h and w >= 2 * out_w:
        # 2x fast path: center tap = 2x2 box; the ±0.5-out-texel diagonal
        # taps are the same box on ±1-input-pixel shifted (clamped) crops.
        return jnp.moveaxis(_downsample_p(jnp.moveaxis(img, -1, 0), out_h, out_w), 0, -1)
    uu, vv = _uv_grid(out_h, out_w)
    du, dv = 0.5 / out_w, 0.5 / out_h
    r = 4.0 * _bilinear(img, uu, vv)
    r = r + _bilinear(img, uu + du, vv + dv)
    r = r + _bilinear(img, uu - du, vv - dv)
    r = r + _bilinear(img, uu - du, vv + dv)
    r = r + _bilinear(img, uu + du, vv - dv)
    return r / 8.0


@functools.lru_cache(maxsize=1)
def _tent_phase_weights():
    """3x3 input-neighborhood weights for each of the 4 output phases of the
    9-tap tent at the exact 2x ratio (all taps land on ±0.25/±0.75-pixel
    offsets -> fixed bilinear weight distributions)."""
    taps = [((1, 0), 2.0), ((-1, 0), 2.0), ((0, 1), 2.0), ((0, -1), 2.0),
            ((1, 1), 1.0), ((-1, 1), 1.0), ((1, -1), 1.0), ((-1, -1), 1.0)]
    weights = {}
    for pi in (0, 1):
        for pj in (0, 1):
            wgt = np.zeros((3, 3))
            fy0 = (pi - 0.5) * 0.5
            fx0 = (pj - 0.5) * 0.5
            for (tx_, ty_), tw in taps:
                fx = fx0 + 0.5 * tx_
                fy = fy0 + 0.5 * ty_
                x0 = int(np.floor(fx))
                y0 = int(np.floor(fy))
                ax = fx - x0
                ay = fy - y0
                for dy, wy in ((y0, 1 - ay), (y0 + 1, ay)):
                    for dx, wx in ((x0, 1 - ax), (x0 + 1, ax)):
                        if wx * wy:
                            wgt[dy + 1, dx + 1] += tw * wx * wy
            weights[(pi, pj)] = wgt / 12.0
    return weights


@functools.lru_cache(maxsize=1)
def _up_conv_kernel():
    """The 9-tap tent upsample (4 phase stencils, _tent_phase_weights) as ONE
    6x6 lhs-dilated (2x) conv kernel over the edge-padded input: kernel index
    2*(d+1) + 1 - phase holds phase stencil entry d in each axis (dilated
    input sample i+d sits at 2(i+d+1); output row 2i+phase reads it there)."""
    weights = _tent_phase_weights()
    k = np.zeros((6, 6), np.float32)
    for (pi, pj), wgt in weights.items():
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k[2 * (dy + 1) + 1 - pi, 2 * (dx + 1) + 1 - pj] = wgt[
                    dy + 1, dx + 1
                ]
    return k


def _upsample_tent_p(img, out_h, out_w):
    """Planar 2x fast path of `upsample_tent` on (..., H, W): one 6x6
    lhs-dilated conv on the edge-padded input (exactly the 4 phase stencils
    of _tent_phase_weights; see _up_conv_kernel)."""
    h, w = img.shape[-2], img.shape[-1]
    out = _conv2(
        _pad1(img), _up_conv_kernel(), (1, 1),
        lhs_dilation=(2, 2), padding=((1, 1), (1, 1)),
    )
    if out_h > 2 * h or out_w > 2 * w:  # odd target: replicate edge row/col
        pad_width = ((0, 0),) * (out.ndim - 2) + (
            (0, out_h - 2 * h), (0, out_w - 2 * w))
        out = jnp.pad(out, pad_width, mode="edge")
    return out[..., :out_h, :out_w]


def upsample_tent(img, out_h, out_w):
    """BloomUpsample.cs.hlsl 9-tap tent (without composite scaling).

    img is channel-last (H, W, C); the 2x fast path runs planar internally.
    """
    h, w = img.shape[0], img.shape[1]
    if out_h in (2 * h, 2 * h + 1) and out_w in (2 * w, 2 * w + 1):
        return jnp.moveaxis(
            _upsample_tent_p(jnp.moveaxis(img, -1, 0), out_h, out_w), 0, -1
        )
    uu, vv = _uv_grid(out_h, out_w)
    du, dv = 1.0 / out_w, 1.0 / out_h
    r = 2.0 * (
        _bilinear(img, uu + du, vv)
        + _bilinear(img, uu - du, vv)
        + _bilinear(img, uu, vv + dv)
        + _bilinear(img, uu, vv - dv)
    )
    r = r + _bilinear(img, uu + du, vv + dv)
    r = r + _bilinear(img, uu - du, vv + dv)
    r = r + _bilinear(img, uu + du, vv - dv)
    r = r + _bilinear(img, uu - du, vv - dv)
    return r / 12.0


def bloom(img, iterations: int = 4, strength: float = 0.01, max_iterations: int = 6):
    """Bloom::Execute port. img (H, W, 3) HDR; returns img + strength*blur.

    The whole mip chain runs planar (3, H, W) — ONE transpose in, one out
    (see module LAYOUT note)."""
    iterations = min(iterations, max_iterations)
    h, w = img.shape[0], img.shape[1]
    sizes = []
    ch, cw = h, w
    for _ in range(iterations):
        ch, cw = max(ch // 2, 1), max(cw // 2, 1)
        sizes.append((ch, cw))
    if not sizes:
        return img
    cur = jnp.moveaxis(img, -1, 0)
    for (mh, mw) in sizes:
        if cur.shape[-2] >= 2 * mh and cur.shape[-1] >= 2 * mw:
            cur = _downsample_p(cur, mh, mw)
        else:  # tiny frames (tests): general-ratio gather path, channel-last
            cur = jnp.moveaxis(
                downsample(jnp.moveaxis(cur, 0, -1), mh, mw), -1, 0)
    # Upsample chain overwrites intermediate mips (Bloom.cpp:131-147).
    for i in range(iterations - 2, -1, -1):
        mh, mw = sizes[i]
        cur = _upsample_tent_p(cur, mh, mw)
    blur = jnp.moveaxis(_upsample_tent_p(cur, h, w), 0, -1)
    return img + strength * blur
