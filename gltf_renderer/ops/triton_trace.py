"""Per-ray BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

The GPU counterpart of DXR TraceRay (Pathtracer.cpp:344-353). One program
traverses one block of BLOCK rays. Every lane keeps its own state in
registers (node, best t, best id word, u, v) and walks the binary threaded
BVH of `ops/bvh.PackedBVH` without a stack: an internal node whose box is
hit descends to node + 1; a missed box or a finished leaf follows the skip
pointer (nodes column 7; column 6 is the leaf's first slot, -1 for an
internal node). These are the tables the XLA reference
(`bvh.intersect_closest_p` / `intersect_any_p`) walks, so kernel and
reference share one layout. Node rows, leaf records and id words are
gathered per lane with masked loads: a lane that is not at a leaf loads no
triangle data.

The loop is "while-while": an inner loop advances every live lane until it
is parked at a leaf whose box it hits (or is done); one pass then tests the
parked lanes' leaves together. A block ends when its own slowest ray ends,
not the slowest ray of the whole dispatch.

Semantics are those of the XLA reference: the same slab and Möller–Trumbore
tests in the same order, so results differ only by FMA contraction.
  - closest hit, with the static blend_mode / cull_sign filters of
    `bvh._apply_filters`;
  - any hit (ACCEPT_FIRST_HIT, PathTracer.lib.hlsl:1053-1079): a lane
    retires on its first accepted triangle;
  - per-lane `mode` (the merged bounce + shadow dispatch): lanes with
    mode > 0 are any-hit lanes and are never culled; mode == 0 lanes are
    closest-hit lanes.
A hit lane reports its id word (>= 0); a miss reports -1 and t = t_max.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gltf_renderer.ops.bvh import (
    BLEND_EXCLUDE,
    BLEND_ONLY,
    FLAG_BLEND,
    FLAG_DOUBLE_SIDED,
    ID_MASK,
    LEAF_SIZE,
    PackedBVH,
)

BLOCK = 128  # rays per program (one lane per thread at 4 warps)


def _any(mask):
    # Triton lowers max reductions, not boolean ones.
    return jnp.max(mask.astype(jnp.int32)) > 0


def _kernel(nodes_ref, rec_ref, words_ref, ox_ref, oy_ref, oz_ref, dx_ref,
            dy_ref, dz_ref, tmin_ref, tmax_ref, *rest, n_nodes: int, any_hit,
            cull_sign: int, blend_mode: int):
    if any_hit == "lane":
        mode_ref, t_ref, u_ref, v_ref, w_ref = rest
        lane_any = mode_ref[...] > 0
    else:
        t_ref, u_ref, v_ref, w_ref = rest
        lane_any = None

    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]

    def inv(d):
        return jnp.where(jnp.abs(d) > 1e-20, 1.0 / d, jnp.sign(d) * 1e20 + 1e20)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    zero_i = jnp.zeros(t_min.shape, jnp.int32)
    done = n_nodes

    def node_col(idx, c, live):
        return plt.load(nodes_ref.at[idx, c], mask=live, other=0.0)

    def descend(state):
        node, park, skip, best_t, best_w, best_u, best_v = state
        live = (node < done) & (park == 0)
        idx = jnp.where(live, node, 0)
        lox, loy, loz = (node_col(idx, c, live) for c in (0, 1, 2))
        hix, hiy, hiz = (node_col(idx, c, live) for c in (3, 4, 5))
        first = node_col(idx, 6, live)
        nskip = node_col(idx, 7, live).astype(jnp.int32)
        tx0, tx1 = (lox - ox) * ix, (hix - ox) * ix
        ty0, ty1 = (loy - oy) * iy, (hiy - oy) * iy
        tz0, tz1 = (loz - oz) * iz, (hiz - oz) * iz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                         jnp.minimum(tz0, tz1))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                         jnp.maximum(tz0, tz1))
        box = live & (tf >= jnp.maximum(tn, t_min)) & (tn <= best_t)
        leaf = first >= 0.0
        new_park = box & leaf
        nxt = jnp.where(box & ~leaf, node + 1, nskip)
        node = jnp.where(live & ~new_park, nxt, node)
        park = jnp.where(new_park, 1, park)
        skip = jnp.where(new_park, nskip, skip)
        return node, park, skip, best_t, best_w, best_u, best_v

    def descending(state):
        node, park = state[0], state[1]
        return _any((node < done) & (park == 0))

    def leaf_pass(state):
        node, park, skip, best_t, best_w, best_u, best_v = state
        parked = park > 0
        idx = jnp.where(parked, node, 0)
        retire = jnp.zeros(parked.shape, jnp.bool_)
        for k in range(LEAF_SIZE):
            word = plt.load(words_ref.at[idx, k], mask=parked, other=-1)
            m = parked & (word >= 0)
            if blend_mode == BLEND_EXCLUDE:
                m = m & ((word & FLAG_BLEND) == 0)
            elif blend_mode == BLEND_ONLY:
                m = m & ((word & FLAG_BLEND) != 0)
            p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                plt.load(rec_ref.at[idx, 9 * k + c], mask=m, other=0.0)
                for c in range(9)
            )
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            h = (m & (jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t > t_min) & (t < best_t))
            if cull_sign:
                culled = (det * cull_sign < 0.0) & ((word & FLAG_DOUBLE_SIDED) == 0)
                if lane_any is not None:
                    culled = culled & ~lane_any
                h = h & ~culled
            best_t = jnp.where(h, t, best_t)
            best_u = jnp.where(h, u, best_u)
            best_v = jnp.where(h, v, best_v)
            best_w = jnp.where(h, word, best_w)
            if any_hit is True:
                retire = retire | h
            elif lane_any is not None:
                retire = retire | (h & lane_any)
        node = jnp.where(parked, jnp.where(retire, done, skip), node)
        return node, zero_i, skip, best_t, best_w, best_u, best_v

    def outer(state):
        state = jax.lax.while_loop(descending, descend, state)
        return leaf_pass(state)

    # Empty intervals (t_min > t_max) are dead from the start.
    node0 = jnp.where(t_min > t_max, done, zero_i)
    state = (node0, zero_i, zero_i, t_max, zero_i - 1,
             jnp.zeros_like(t_max), jnp.zeros_like(t_max))
    state = jax.lax.while_loop(lambda s: _any(s[0] < done), outer, state)
    _, _, _, best_t, best_w, best_u, best_v = state
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    w_ref[...] = best_w


@functools.partial(
    jax.jit,
    static_argnames=("any_hit", "cull_sign", "blend_mode", "interpret", "block"),
)
def _traverse(nodes, records, words, origin, direction, t_min, t_max, mode, *,
              any_hit, cull_sign, blend_mode, interpret, block):
    r = origin.shape[0]
    n_blocks = max(-(-r // block), 1)
    pad = n_blocks * block - r

    def prep(x, fill):
        return jnp.concatenate([x, jnp.full(pad, fill, x.dtype)]) if pad else x

    t_max = jnp.broadcast_to(t_max, t_min.shape)
    cols = [prep(origin[:, 0], 0.0), prep(origin[:, 1], 0.0),
            prep(origin[:, 2], 0.0), prep(direction[:, 0], 1.0),
            prep(direction[:, 1], 0.0), prep(direction[:, 2], 0.0),
            prep(t_min, 1.0), prep(t_max, 0.0)]  # padding lanes: t_max < t_min
    if any_hit == "lane":
        cols.append(prep(mode.astype(jnp.int32), 0))
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    out_f = jax.ShapeDtypeStruct((n_blocks * block,), jnp.float32)
    out_i = jax.ShapeDtypeStruct((n_blocks * block,), jnp.int32)
    kernel = functools.partial(_kernel, n_nodes=nodes.shape[0], any_hit=any_hit,
                               cull_sign=cull_sign, blend_mode=blend_mode)
    t, u, v, w = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[table_spec] * 3 + [ray_spec] * len(cols),
        out_specs=[ray_spec] * 4,
        out_shape=[out_f, out_f, out_f, out_i],
        compiler_params=plt.CompilerParams(num_warps=max(block // 32, 1),
                                           num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(nodes, records, words, *cols)
    return t[:r], w[:r], u[:r], v[:r]


def traverse(packed: PackedBVH, origin, direction, t_min, t_max, *,
             any_hit=False, mode=None, cull_sign: int = 0, blend_mode: int = 0,
             interpret: bool = False, block: int = BLOCK):
    """Traverse rays through `packed` -> (t, word, u, v), each (R,).

    any_hit: False (closest), True (every lane any-hit), or "lane" (per-lane
    `mode` (R,) i32: > 0 any-hit). For any-hit lanes only `word >= 0`
    (occluded) is meaningful. `interpret=True` runs the Pallas interpreter
    (CPU tests); the GPU always runs the compiled kernel.
    """
    if (any_hit == "lane") != (mode is not None):
        raise ValueError("any_hit='lane' and mode go together")
    return _traverse(
        packed.nodes, packed.records, packed.words, origin, direction, t_min,
        t_max, mode, any_hit=any_hit,
        cull_sign=cull_sign, blend_mode=blend_mode, interpret=interpret,
        block=block,
    )


def compare_hits(ref, t, word, u, v, sel=None) -> dict:
    """Closest-hit parity of kernel output (t, word, u, v) against a
    reference `bvh.Hit`, counted per rule over the lanes in `sel` (all by
    default). The rule: identical hit/miss; t within rtol 1e-4 / atol 1e-5
    where the reference hit; a different triangle only on a t-tie; u and v
    within rtol 1e-3 / atol 1e-4 where the same triangle won. Every count
    is 0 when the outputs agree."""
    import numpy as np

    word = np.asarray(word)
    tri = np.where(word >= 0, word & ID_MASK, -1)
    ref_tri = np.asarray(ref.tri)
    ref_t = np.asarray(ref.t)
    t = np.asarray(t)
    sel = np.ones(tri.shape, bool) if sel is None else np.asarray(sel)
    hit_ref = ref_tri >= 0
    h = hit_ref & sel
    tie = np.abs(t - ref_t) <= 1e-4 * np.maximum(np.abs(ref_t), 1.0)
    same = (tri == ref_tri) & h

    def off(a, b, rtol, atol):
        return np.abs(a - b) > atol + rtol * np.abs(b)

    return {
        "lanes": int(sel.sum()),
        "hits": int(h.sum()),
        "hit_miss_differs": int(((tri >= 0) != hit_ref)[sel].sum()),
        "t_differs": int((off(t, ref_t, 1e-4, 1e-5) & h).sum()),
        "other_tri_not_tie": int((sel & (tri != ref_tri) & ~(hit_ref & tie)).sum()),
        "uv_differs": int((same & (off(np.asarray(u), np.asarray(ref.u), 1e-3, 1e-4)
                                   | off(np.asarray(v), np.asarray(ref.v), 1e-3, 1e-4))).sum()),
    }


def hits_agree(report: dict) -> bool:
    return all(v == 0 for k, v in report.items() if k not in ("lanes", "hits"))
