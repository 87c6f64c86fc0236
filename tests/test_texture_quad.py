"""Quad-packed atlas path (build_atlas_quad + sample_slots_fused) must be
bit-identical to the 4-corner fused gather path for repeat and clamp wraps,
including uv outside [0, 1] (KHR_texture_transform can push uv anywhere)."""

import numpy as np
import jax.numpy as jnp

from gltf_renderer.ops.material import sample_slots_fused
from gltf_renderer.ops.texture import build_atlas_quad, decode_atlas_linear
from gltf_renderer.scene import types as T


def _table(wrap_s, wrap_t, nearest=0):
    rng = np.random.RandomState(7)
    ah, aw = 24, 32
    atlas = rng.randint(0, 255, (ah, aw, 4)).astype(np.uint8)
    # Two texture rects, one sRGB one linear.
    x = np.asarray([0, 12], np.int32)
    y = np.asarray([0, 8], np.int32)
    w = np.asarray([12, 7], np.int32)
    h = np.asarray([8, 5], np.int32)
    tex = T.TextureTable(
        atlas=atlas, x=x, y=y, width=w, height=h,
        wrap_s=np.asarray([wrap_s, wrap_t], np.int32),
        wrap_t=np.asarray([wrap_t, wrap_s], np.int32),
        nearest=np.asarray([nearest, 0], np.int32),
        srgb=np.asarray([1, 0], np.int32),
    )
    rows = np.stack(
        [x, y, w, h, np.asarray(tex.wrap_s), np.asarray(tex.wrap_t),
         np.asarray(tex.nearest), np.asarray(tex.srgb), np.zeros(2)], 1
    ).astype(np.float32)
    return tex._replace(rows=rows)


def _mat_row(n, tex_ids):
    """Minimal compact material rows: a single slot whose 7 addressing cols
    + 9 joined metadata cols follow MATERIAL_ROW_FACTORS."""
    from gltf_renderer.ops.material import MATERIAL_ROW_FACTORS
    from gltf_renderer.scene.types import MATERIAL_ROW_FACTORS as _  # noqa: F401

    return MATERIAL_ROW_FACTORS


def test_quad_atlas_matches_four_corner():
    from gltf_renderer.scene.types import WRAP_CLAMP, WRAP_REPEAT

    for wrap_s, wrap_t in [(WRAP_REPEAT, WRAP_REPEAT), (WRAP_CLAMP, WRAP_REPEAT),
                           (WRAP_CLAMP, WRAP_CLAMP)]:
        for nearest in (0, 1):
            tex = decode_atlas_linear(_table(wrap_s, wrap_t, nearest))
            texq = build_atlas_quad(tex)
            assert texq.atlas_quad is not None

            # Build a 1-material compact row with two used slots pointing at
            # the two textures (metadata joined like compact_material_rows).
            from gltf_renderer.ops import material as M

            k = 2
            row = np.zeros((1, M.MATERIAL_ROW_FACTORS + M.COMPACT_SLOT_STRIDE * k),
                           np.float32)
            for j, tid in enumerate((0, 1)):
                b = M.MATERIAL_ROW_FACTORS + M.COMPACT_SLOT_STRIDE * j
                row[0, b] = np.asarray(tid, np.float32).view(np.float32)
                row[0, b : b + 1].view(np.int32)[0] = tid      # tex id (bits)
                row[0, b + 1 : b + 2].view(np.int32)[0] = 0    # uv set 0
                row[0, b + 2] = 0.0                            # rotation
                row[0, b + 3 : b + 5] = [0.0, 0.0]             # offset
                row[0, b + 5 : b + 7] = [1.0, 1.0]             # scale
                row[0, b + M.MATERIAL_SLOT_STRIDE : b + M.MATERIAL_SLOT_STRIDE + 9] = (
                    np.asarray(tex.rows)[tid]
                )
            rng = np.random.RandomState(3)
            n = 512
            # uv spanning well outside [0,1] to hit seams/clamp regions, plus
            # exact-edge values.
            uv0 = rng.uniform(-1.6, 2.6, (n, 2)).astype(np.float32)
            uv0[:8] = [[0, 0], [1, 1], [0.999, 0.001], [-1e-3, 1e-3],
                       [0.5, 1.0], [1.0, 0.5], [2.0, -1.0], [-0.5, -0.5]]
            rows_j = jnp.asarray(np.repeat(row, n, 0))
            uv0_j = jnp.asarray(uv0)
            uv1_j = jnp.zeros_like(uv0_j)

            used = (0, 1)
            out4 = sample_slots_fused(
                rows_j, tex._replace(rows=jnp.asarray(tex.rows)), [0, 1],
                uv0_j, uv1_j, used_slots=used, compact=True,
            )
            outq = sample_slots_fused(
                rows_j, texq._replace(rows=jnp.asarray(texq.rows)), [0, 1],
                uv0_j, uv1_j, used_slots=used, compact=True,
            )
            for s in (0, 1):
                a4, p4 = out4[s]
                aq, pq = outq[s]
                np.testing.assert_array_equal(np.asarray(p4), np.asarray(pq))
                np.testing.assert_allclose(
                    np.asarray(a4), np.asarray(aq), rtol=0, atol=0,
                    err_msg=f"wrap=({wrap_s},{wrap_t}) nearest={nearest} slot={s}",
                )


def test_quad_atlas_skips_mirror():
    from gltf_renderer.scene.types import WRAP_MIRROR, WRAP_REPEAT

    tex = decode_atlas_linear(_table(WRAP_MIRROR, WRAP_REPEAT))
    assert build_atlas_quad(tex).atlas_quad is None
