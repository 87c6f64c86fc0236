"""Minimal PNG codec on numpy + zlib (no imaging library needed).

Encodes 8-bit gray, gray+alpha, RGB and RGBA images (filter 0, one IDAT).
Decodes every non-interlaced PNG of the specification: color types 0, 2, 3
(palette, with tRNS transparency), 4 and 6; bit depths 1-16 (16-bit samples
keep their high byte); all five scanline filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> color type (8-bit)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 image, C in 1-4 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png needs 1-4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> (h, stride) uint8."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane
            pad = -(-stride // bpp) * bpp
            lanes = np.zeros(pad, np.int32)
            lanes[:stride] = line
            cur = (np.cumsum(lanes.reshape(-1, bpp), 0) % 256).reshape(-1)[:stride]
        elif ftype == 2:  # Up
            cur = (line + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                sl = slice(x, min(x + bpp, stride))
                up = prev[sl]
                left = cur[x - bpp:x - bpp + (sl.stop - x)] if x >= bpp else 0 * up
                if ftype == 3:
                    pred = (left + up) // 2
                else:
                    ul = prev[x - bpp:x - bpp + (sl.stop - x)] if x >= bpp else 0 * up
                    p = left + up - ul
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, ul))
                cur[sl] = (line[sl] + pred) % 256
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C = 1 (gray), 2 (gray+alpha),
    3 (RGB) or 4 (RGBA; palette images with transparency)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, trns = 8, [], None, None
    ihdr = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG has no IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG (color type {ctype}, depth {depth})")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[: h * (stride + 1)], h, stride, max(bits // 8, 1))
    if depth == 16:
        img = rows.reshape(h, w, ch, 2)[..., 0]
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:  # 1/2/4-bit gray or palette indices
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        img = vals.reshape(h, -1)[:, :w, None].astype(np.uint8)
        if ctype == 0:
            img = (img.astype(np.int32) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    return np.ascontiguousarray(img)


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
