"""Texture atlas packing (host side, numpy).

The reference binds each texture as a bindless SRV (Gltf.cpp:1048-1078).
Here all textures live in ONE u8 RGBA atlas; each texture id maps to a rect.
Wrap modes are applied per-texture at sample time (exact: 4 wrapped texel
gathers — no gutters needed), so rects can be packed tightly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class AtlasBuilder:
    """Simple shelf packer over a power-of-two-wide atlas."""

    def __init__(self, width: int = 4096):
        self.width = width
        self.shelf_y = 0
        self.shelf_height = 0
        self.cursor_x = 0
        self.rects: List[Tuple[int, int, int, int]] = []
        self.images: List[np.ndarray] = []

    def add(self, image: np.ndarray) -> int:
        """image: (H, W, 4) uint8. Returns texture index."""
        h, w = image.shape[:2]
        if w > self.width:
            # Downscale very wide textures to fit (rare; keeps atlas bounded).
            step = -(-w // self.width)
            image = image[::step, ::step]
            h, w = image.shape[:2]
        if self.cursor_x + w > self.width:
            self.shelf_y += self.shelf_height
            self.shelf_height = 0
            self.cursor_x = 0
        x, y = self.cursor_x, self.shelf_y
        self.cursor_x += w
        self.shelf_height = max(self.shelf_height, h)
        self.rects.append((x, y, w, h))
        self.images.append(image)
        return len(self.rects) - 1

    def build(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (atlas (AH, AW, 4) u8, rects (T, 4) i32 [x, y, w, h])."""
        height = max(self.shelf_y + self.shelf_height, 1)
        # Round the height up to a multiple of 8 rows.
        height = -(-height // 8) * 8
        atlas = np.zeros((height, self.width, 4), np.uint8)
        for (x, y, w, h), img in zip(self.rects, self.images):
            atlas[y : y + h, x : x + w] = img
        rects = np.asarray(self.rects, np.int32).reshape(-1, 4) if self.rects else np.zeros((0, 4), np.int32)
        return atlas, rects


def decode_image_bytes(data: bytes) -> np.ndarray:
    """PNG/JPEG bytes -> (H, W, 4) uint8.

    PNG goes through the numpy+zlib codec (utils/png.py). JPEG needs the
    optional Pillow package."""
    from gltf_renderer.utils.png import decode_png

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data)
        c = img.shape[-1]
        if c == 1:
            img = np.repeat(img, 3, -1)
        elif c == 2:
            img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        return np.ascontiguousarray(img)
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            "this texture is not a PNG; decoding it (JPEG) needs the optional "
            "Pillow package (pip install pillow)") from e
    import io

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGBA")
    return np.asarray(img, np.uint8)
