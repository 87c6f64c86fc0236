"""BVH build + stackless traversal.

Replacement for DXR BLAS/TLAS (RayTracingAccelerationStructure.cpp): the
scene is flattened to ONE world-space triangle soup (scene/flatten.py), and
a single BVH is built over it — no two-level hierarchy, no per-ray instance
transforms.

Layout: *threaded* BVH (skip links, DFS order). Traversal keeps one node
pointer per ray and no stack — the XLA reference below is a lockstep
while-loop over all rays; the GPU kernel (ops/triton_trace.py) walks the same
tables per lane:
  - AABB hit on internal node  -> next = i + 1 (DFS child follows parent)
  - AABB miss, or leaf handled -> next = skip[i]
Leaves hold up to LEAF_SIZE triangles, contiguous after reordering.

Build: host-side binned SAH (numpy). Refit for skinned/morphed scenes: the
topology is static; per-frame leaf/internal AABBs are recomputed bottom-up by
depth levels (jit-able, vectorized per level) — the analogue of the reference's
BLAS refit (RayTracingAccelerationStructure.cpp:110-158).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

LEAF_SIZE = 16
SAH_BINS = 16

# Packed record row layout: LEAF_SIZE x [v0.xyz e1.xyz e2.xyz] + LEAF_SIZE words.
REC_GEO = 9 * LEAF_SIZE
REC_WIDTH = REC_GEO + LEAF_SIZE


class FlatBVH(NamedTuple):
    aabb_min: Any    # (N, 3) f32
    aabb_max: Any    # (N, 3) f32
    first: Any       # (N,) i32 — leaf: first slot in tri_order; internal: i+1
    count: Any       # (N,) i32 — leaf triangle count; 0 for internal nodes
    skip: Any        # (N,) i32 — node to visit on miss / after leaf (== N done)
    right: Any       # (N,) i32 — internal: right-child index (refit); leaf: -1
    tri_order: Any   # (T,) i32 — BVH slot -> original triangle id
    levels: Any      # (N,) i32 — node depth (for vectorized refit)


def _build_recursive(lo, hi, centroid, order, leaf_size=LEAF_SIZE):
    """Recursive DFS build returning arrays (replaces the iterative draft)."""
    t = len(order)
    n_min, n_max, n_first, n_count, n_right, n_skip, n_level = [], [], [], [], [], [], []

    import sys

    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def area(lo_a, hi_a):
        d = np.maximum(hi_a - lo_a, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    def build(begin, end, level):
        node = len(n_min)
        idx = order[begin:end]
        n_min.append(lo[idx].min(0))
        n_max.append(hi[idx].max(0))
        n_first.append(begin)
        n_count.append(0)
        n_right.append(-1)
        n_skip.append(-1)
        n_level.append(level)
        count = end - begin
        if count <= leaf_size:
            n_count[node] = count
            return node

        c = centroid[idx]
        c_lo, c_hi = c.min(0), c.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))  # median-split fallback axis
        # Binned SAH over ALL 3 axes (matches the native builder; fewer
        # node visits than largest-extent-only in tools/bvh_union_sim.py).
        mid = -1
        best_cost = np.inf
        best_sel = None
        for ax in range(3):
            if extent[ax] <= 1e-12:
                continue
            scale = SAH_BINS * (1.0 - 1e-6) / extent[ax]
            bins = np.minimum(((c[:, ax] - c_lo[ax]) * scale).astype(np.int32), SAH_BINS - 1)
            bin_count = np.bincount(bins, minlength=SAH_BINS)
            bin_lo = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_hi = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in np.nonzero(bin_count)[0]:
                mask = bins == b
                bin_lo[b] = lo[idx[mask]].min(0)
                bin_hi[b] = hi[idx[mask]].max(0)
            lc = np.cumsum(bin_count)[:-1]
            rc = count - lc
            l_lo = np.minimum.accumulate(bin_lo, 0)[:-1]
            l_hi = np.maximum.accumulate(bin_hi, 0)[:-1]
            r_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1][1:]
            r_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1][1:]
            cost = area(l_lo, l_hi) * lc + area(r_lo, r_hi) * rc
            cost = np.where((lc == 0) | (rc == 0), np.inf, cost)
            b_ax = int(np.argmin(cost))
            if np.isfinite(cost[b_ax]) and cost[b_ax] < best_cost:
                best_cost = float(cost[b_ax])
                best_sel = bins <= b_ax
        if best_sel is not None:
            left_idx = idx[best_sel]
            right_idx = idx[~best_sel]
            order[begin : begin + len(left_idx)] = left_idx
            order[begin + len(left_idx) : end] = right_idx
            mid = begin + len(left_idx)
        if mid <= begin or mid >= end:
            # Median split fallback.
            mid = begin + count // 2
            sel = np.argsort(c[:, axis], kind="stable")
            order[begin:end] = idx[sel]

        build(begin, mid, level + 1)
        right = build(mid, end, level + 1)
        n_first[node] = node + 1
        n_right[node] = right
        return node

    build(0, t, 0)
    n = len(n_min)

    # Skip links: DFS property — skip(root)=N; skip(left)=right sibling;
    # skip(right)=skip(parent); leaf skip likewise.
    skip = np.full(n, n, np.int32)

    def assign_skip(node, skip_val):
        stack = [(node, skip_val)]
        while stack:
            nd, sv = stack.pop()
            skip[nd] = sv
            if n_count[nd] == 0:
                left = nd + 1
                right = n_right[nd]
                stack.append((left, right))
                stack.append((right, sv))

    assign_skip(0, n)
    return (
        np.asarray(n_min, np.float32).reshape(n, 3),
        np.asarray(n_max, np.float32).reshape(n, 3),
        np.asarray(n_first, np.int32),
        np.asarray(n_count, np.int32),
        skip,
        np.asarray(n_right, np.int32),
        np.asarray(n_level, np.int32),
    )


_NATIVE = None
_NATIVE_TRIED = False
_NATIVE_SOURCES = ("bvh_builder.cpp", "exr_piz.cpp")


def _native_dir() -> str:
    import os

    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def _compile_native(native_dir: str, lib_path: str) -> None:
    """Compile native/*.cpp into lib_path. The library is written to a
    per-process temporary name and renamed into place, so processes that
    build at the same time never load a half-written file."""
    import os
    import subprocess

    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-shared",
           "-o", tmp] + [os.path.join(native_dir, f) for f in _NATIVE_SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native():
    """Load the C++ SAH builder and EXR decoder (native/*.cpp), building
    native/libgltf_native.so at first use and again whenever a source is
    newer than the library. Returns None, with a warning, when it cannot be
    built or loaded; callers then fall back to the numpy builder."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import logging
    import os
    import subprocess

    native_dir = _native_dir()
    lib_path = os.path.join(native_dir, "libgltf_native.so")
    sources = [os.path.join(native_dir, f) for f in _NATIVE_SOURCES]
    try:
        stale = not os.path.exists(lib_path) or os.path.getmtime(lib_path) < max(
            os.path.getmtime(f) for f in sources)
        if stale:
            _compile_native(native_dir, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.bvh_build.restype = ctypes.c_int
        _NATIVE = lib
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or e
        logging.getLogger(__name__).warning(
            "native BVH builder unavailable (%s); falling back to the numpy "
            "builder, which is ~100x slower on large scenes", detail)
        _NATIVE = None
    return _NATIVE


def _build_native(lib, v0, v1, v2, leaf_size=LEAF_SIZE) -> FlatBVH:
    import ctypes

    t = len(v0)
    cap = 2 * t
    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    levels = np.empty(cap, np.int32)
    tri_order = np.empty(t, np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    f = ctypes.c_float
    i = ctypes.c_int32
    n = lib.bvh_build(
        ptr(np.ascontiguousarray(v0, np.float32), f),
        ptr(np.ascontiguousarray(v1, np.float32), f),
        ptr(np.ascontiguousarray(v2, np.float32), f),
        ctypes.c_int(t),
        ctypes.c_int(leaf_size),
        ptr(aabb_min, f),
        ptr(aabb_max, f),
        ptr(first, i),
        ptr(count, i),
        ptr(skip, i),
        ptr(right, i),
        ptr(levels, i),
        ptr(tri_order, i),
    )
    return FlatBVH(
        aabb_min[:n].copy(),
        aabb_max[:n].copy(),
        first[:n].copy(),
        count[:n].copy(),
        skip[:n].copy(),
        right[:n].copy(),
        tri_order,
        levels[:n].copy(),
    )


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, use_native: bool = True,
          leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build a threaded BVH (host). v0/v1/v2: (T, 3) triangle vertices.

    Uses the native C++ binned-SAH builder when available (the framework's
    host-side 'acceleration structure build', ~100x the Python fallback);
    falls back to the pure-numpy builder otherwise.
    """
    t = len(v0)
    if use_native and t > 0:
        lib = _load_native()
        if lib is not None:
            return _build_native(lib, v0, v1, v2, leaf_size)
    if t == 0:
        return FlatBVH(
            np.zeros((1, 3), np.float32),
            np.zeros((1, 3), np.float32),
            np.ones(1, np.int32),
            np.zeros(1, np.int32),
            np.ones(1, np.int32),
            np.full(1, -1, np.int32),
            np.zeros(0, np.int32),
            np.zeros(1, np.int32),
        )
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((lo + hi) * 0.5).astype(np.float32)
    order = np.arange(t, dtype=np.int32)
    n_min, n_max, first, count, skip, right, level = _build_recursive(lo, hi, centroid, order, leaf_size)
    return FlatBVH(n_min, n_max, first, count, skip, right, order, level)


def refit(bvh: FlatBVH, v0, v1, v2) -> FlatBVH:
    """Jit-able AABB refit with static topology (bottom-up by depth level).

    v0/v1/v2: (T, 3) current world triangle vertices (original triangle order).
    """
    tri = bvh.tri_order
    t_lo = jnp.minimum(jnp.minimum(v0[tri], v1[tri]), v2[tri])
    t_hi = jnp.maximum(jnp.maximum(v0[tri], v1[tri]), v2[tri])

    n = bvh.count.shape[0]
    is_leaf = bvh.count > 0
    # Leaf AABBs: min/max over up to LEAF_SIZE slots.
    slot = bvh.first[:, None] + jnp.arange(LEAF_SIZE)[None, :]
    valid = jnp.arange(LEAF_SIZE)[None, :] < bvh.count[:, None]
    slot = jnp.clip(slot, 0, max(t_lo.shape[0] - 1, 0))
    leaf_lo = jnp.where(valid[..., None], t_lo[slot], jnp.inf).min(1)
    leaf_hi = jnp.where(valid[..., None], t_hi[slot], -jnp.inf).max(1)

    lo_arr = jnp.where(is_leaf[:, None], leaf_lo, jnp.inf)
    hi_arr = jnp.where(is_leaf[:, None], leaf_hi, -jnp.inf)

    # Topology metadata must be host numpy (it drives loop structure) — this
    # function is called with a host-side FlatBVH, under jit or eagerly.
    levels = np.asarray(bvh.levels)
    counts = np.asarray(bvh.count)
    rights = np.asarray(bvh.right)
    max_level = int(levels.max()) if n else 0
    for lev in range(max_level - 1, -1, -1):
        sel = np.nonzero((levels == lev) & (counts == 0))[0].astype(np.int32)
        if len(sel) == 0:
            continue
        left = sel + 1
        right = rights[sel]
        child_lo = jnp.minimum(lo_arr[left], lo_arr[right])
        child_hi = jnp.maximum(hi_arr[left], hi_arr[right])
        lo_arr = lo_arr.at[sel].set(child_lo)
        hi_arr = hi_arr.at[sel].set(child_hi)
    return bvh._replace(aabb_min=lo_arr, aabb_max=hi_arr)


# ---------------------------------------------------------------------------
# Traversal (jnp wavefront; every ray advances one BVH node per step)
# ---------------------------------------------------------------------------

def _as_device(bvh: FlatBVH) -> FlatBVH:
    """Move compute-path fields to jnp (identity when already traced/device).

    `levels` stays host-side: it drives the Python-level refit loop structure.
    """
    return bvh._replace(
        aabb_min=jnp.asarray(bvh.aabb_min),
        aabb_max=jnp.asarray(bvh.aabb_max),
        first=jnp.asarray(bvh.first),
        count=jnp.asarray(bvh.count),
        skip=jnp.asarray(bvh.skip),
        right=jnp.asarray(bvh.right),
        tri_order=jnp.asarray(bvh.tri_order),
    )


class Hit(NamedTuple):
    t: Any        # (R,) f32 — hit distance (t_max if miss)
    tri: Any      # (R,) i32 — triangle id (-1 = miss)
    u: Any        # (R,) f32 barycentric
    v: Any        # (R,) f32


def _ray_tri(origin, direction, p0, e1, e2, t_min, t_max):
    """Möller–Trumbore. origin/direction (R,3); p0/e1/e2 (R,K,3).

    Returns (hit mask, t, u, v, det) each (R, K). det > 0 <=> front face
    (CCW winding seen against the ray, DXR default — PathTracer.lib.hlsl:842).
    """
    o = origin[:, None, :]
    d = direction[:, None, :]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, -1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, -1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, -1) * inv_det
    t = jnp.sum(e2 * qvec, -1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return hit, t, u, v, det


def _aabb_hit(origin, inv_dir, lo, hi, t_min, t_max):
    """Slab test. origin/inv_dir (R,3); lo/hi (R,3)."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    tn = jnp.minimum(t0, t1).max(-1)
    tf = jnp.maximum(t0, t1).min(-1)
    return (tf >= jnp.maximum(tn, t_min)) & (tn <= t_max)


def intersect_closest(
    bvh: FlatBVH,
    v0,
    e1,
    e2,
    origin,
    direction,
    t_min,
    t_max,
    tri_mask=None,
    cull_sign: int = 0,
    cull_disable=None,
) -> Hit:
    """Closest-hit traversal for a batch of rays.

    v0/e1/e2: (T, 3) triangle data in *BVH slot order* (pre-gathered via
    bvh.tri_order). tri_mask: optional (T,) bool in slot order — triangles with
    False are skipped. cull_sign: 0 none, +1 cull back faces (det<0), -1 cull
    front faces — per-triangle override via cull_disable (T,) bool in slot
    order (double-sided materials, D3D12_RAYTRACING_INSTANCE_FLAG_TRIANGLE_
    CULL_DISABLE in Pathtracer.cpp:221-223).
    Returns Hit with `tri` as ORIGINAL triangle ids.
    """
    bvh = _as_device(bvh)
    n_nodes = bvh.count.shape[0]
    n_rays = origin.shape[0]
    inv_dir = jnp.where(
        jnp.abs(direction) > 1e-20, 1.0 / direction, jnp.sign(direction) * 1e20 + 1e20
    )

    def cond(state):
        node = state[0]
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_tri, best_u, best_v = state
        node_c = jnp.clip(node, 0, n_nodes - 1)
        alive = node < n_nodes
        lo = bvh.aabb_min[node_c]
        hi = bvh.aabb_max[node_c]
        count = bvh.count[node_c]
        first = bvh.first[node_c]
        skip = bvh.skip[node_c]

        box_hit = _aabb_hit(origin, inv_dir, lo, hi, t_min, best_t) & alive
        is_leaf = count > 0

        # Leaf: test up to LEAF_SIZE triangles.
        do_tris = box_hit & is_leaf
        slot = first[:, None] + jnp.arange(LEAF_SIZE)[None, :]
        valid = (jnp.arange(LEAF_SIZE)[None, :] < count[:, None]) & do_tris[:, None]
        slot_c = jnp.clip(slot, 0, max(v0.shape[0] - 1, 0))
        h, t, u, v, det = _ray_tri(
            origin, direction, v0[slot_c], e1[slot_c], e2[slot_c], t_min, best_t
        )
        h = h & valid
        if tri_mask is not None:
            h = h & tri_mask[slot_c]
        if cull_sign:
            culled = det * cull_sign < 0.0
            if cull_disable is not None:
                culled = culled & (~cull_disable[slot_c])
            h = h & (~culled)
        # Pick the best triangle in this leaf.
        t_masked = jnp.where(h, t, jnp.inf)
        k = jnp.argmin(t_masked, -1)
        rows = jnp.arange(n_rays)
        leaf_t = t_masked[rows, k]
        leaf_hit = leaf_t < best_t
        best_tri = jnp.where(leaf_hit, slot_c[rows, k], best_tri)
        best_u = jnp.where(leaf_hit, u[rows, k], best_u)
        best_v = jnp.where(leaf_hit, v[rows, k], best_v)
        best_t = jnp.where(leaf_hit, leaf_t, best_t)

        descend = box_hit & (~is_leaf)
        next_node = jnp.where(descend, node_c + 1, skip)
        next_node = jnp.where(alive, next_node, node)
        return next_node, best_t, best_tri, best_u, best_v

    # Derive carries from ray inputs so they inherit shard_map varying axes.
    fzero = origin[:, 0] * 0.0
    node0 = fzero.astype(jnp.int32)
    state = (
        node0,
        jnp.broadcast_to(t_max, (n_rays,)) + fzero,
        node0 - 1,
        fzero,
        fzero,
    )
    node, t, tri_slot, u, v = jax.lax.while_loop(cond, body, state)
    tri_id = jnp.where(tri_slot >= 0, bvh.tri_order[jnp.clip(tri_slot, 0, None)], -1)
    return Hit(t=t, tri=tri_id, u=u, v=v)


def intersect_any(
    bvh: FlatBVH,
    v0,
    e1,
    e2,
    origin,
    direction,
    t_min,
    t_max,
    tri_mask=None,
    cull_sign: int = 0,
    cull_disable=None,
) -> Any:
    """Binary occlusion query: True where ANY (unmasked) triangle is hit.

    Early-out per ray: a ray that finds a hit jumps to the DONE node.
    """
    bvh = _as_device(bvh)
    n_nodes = bvh.count.shape[0]
    n_rays = origin.shape[0]
    inv_dir = jnp.where(
        jnp.abs(direction) > 1e-20, 1.0 / direction, jnp.sign(direction) * 1e20 + 1e20
    )

    def cond(state):
        node, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, occluded = state
        node_c = jnp.clip(node, 0, n_nodes - 1)
        alive = node < n_nodes
        lo = bvh.aabb_min[node_c]
        hi = bvh.aabb_max[node_c]
        count = bvh.count[node_c]
        first = bvh.first[node_c]
        skip = bvh.skip[node_c]

        box_hit = _aabb_hit(origin, inv_dir, lo, hi, t_min, t_max) & alive
        is_leaf = count > 0
        do_tris = box_hit & is_leaf
        slot = first[:, None] + jnp.arange(LEAF_SIZE)[None, :]
        valid = (jnp.arange(LEAF_SIZE)[None, :] < count[:, None]) & do_tris[:, None]
        slot_c = jnp.clip(slot, 0, max(v0.shape[0] - 1, 0))
        h, t, u, v, det = _ray_tri(
            origin, direction, v0[slot_c], e1[slot_c], e2[slot_c], t_min,
            jnp.broadcast_to(t_max, t_min.shape) if jnp.ndim(t_max) == 0 else t_max,
        )
        h = h & valid
        if tri_mask is not None:
            h = h & tri_mask[slot_c]
        if cull_sign:
            culled = det * cull_sign < 0.0
            if cull_disable is not None:
                culled = culled & (~cull_disable[slot_c])
            h = h & (~culled)
        occluded = occluded | jnp.any(h, -1)

        descend = box_hit & (~is_leaf)
        next_node = jnp.where(descend, node_c + 1, skip)
        next_node = jnp.where(occluded, n_nodes, next_node)  # early out
        next_node = jnp.where(alive, next_node, node)
        return next_node, occluded

    fzero = origin[:, 0] * 0.0
    state = (fzero.astype(jnp.int32), fzero.astype(bool))
    _, occluded = jax.lax.while_loop(cond, body, state)
    return occluded


# ---------------------------------------------------------------------------
# Packed layout: one row-gather per traversal step
# ---------------------------------------------------------------------------
#
# Everything a traversal step needs is packed into single rows, shared by
# the XLA reference and the GPU kernel:
#   nodes   (N, 8)  f32: [lo.xyz, hi.xyz, leaf_first (plain float, -1 for
#                          internal), skip (plain float)]
#   records (N, REC_GEO) f32: per-node leaf geometry, LEAF_SIZE x [v0, e1, e2]
#   words   (N, LEAF_SIZE) i32: id/flag words (own array — see PackedBVH).
# Id/flag word: tri_id | MASKED<<28 | BLEND<<29 | DOUBLE_SIDED<<30.

FLAG_MASKED = 1 << 28
FLAG_BLEND = 1 << 29
FLAG_DOUBLE_SIDED = 1 << 30
ID_MASK = (1 << 28) - 1

BLEND_ANY = 0       # no blend filtering
BLEND_EXCLUDE = 1   # opaque pass: skip BLEND-flagged triangles
BLEND_ONLY = 2      # blend pass: only BLEND-flagged triangles


class PackedBVH(NamedTuple):
    """Flush-safe packed traversal tables.

    Never store bitcast int words inside f32 arrays that device-side ops
    (concatenate, column slices) touch: a backend that flushes denormals to
    zero in such copies silently corrupts any int pattern < 2^23. Topology
    columns are therefore stored as PLAIN FLOAT VALUES and flag words live
    in a separate int32 array.
    """

    nodes: Any     # (N, 8) f32: [lo.xyz, hi.xyz, leaf_first (or -1), skip] as plain floats
    records: Any   # (N, REC_GEO) f32: LEAF_SIZE x [v0.xyz e1.xyz e2.xyz]
    words: Any     # (N, LEAF_SIZE) i32: id/flag words, -1 = empty slot
    n_nodes: int


def pack(bvh: FlatBVH, slot_v0, slot_e1, slot_e2, slot_flags) -> PackedBVH:
    """Build the packed tables (host, numpy). slot_* are in BVH slot order;
    slot_flags (T,) int32 carries FLAG_* bits ORed with the original tri id."""
    n = int(np.asarray(bvh.count).shape[0])
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    skip = np.asarray(bvh.skip)

    nodes = np.zeros((n, 8), np.float32)
    nodes[:, 0:3] = np.asarray(bvh.aabb_min)
    nodes[:, 3:6] = np.asarray(bvh.aabb_max)
    nodes[:, 6] = np.where(count > 0, first, -1).astype(np.float32)
    nodes[:, 7] = skip.astype(np.float32)

    t = len(slot_v0)
    records = np.zeros((n, REC_GEO), np.float32)
    words = np.full((n, LEAF_SIZE), -1, np.int32)
    if t:
        sv0 = np.asarray(slot_v0, np.float32)
        se1 = np.asarray(slot_e1, np.float32)
        se2 = np.asarray(slot_e2, np.float32)
        sfl = np.asarray(slot_flags, np.int32)
        ks = np.arange(LEAF_SIZE)
        slot = np.clip(first[:, None] + ks[None, :], 0, t - 1)  # (N, LEAF_SIZE)
        for k in range(LEAF_SIZE):
            records[:, 9 * k : 9 * k + 3] = sv0[slot[:, k]]
            records[:, 9 * k + 3 : 9 * k + 6] = se1[slot[:, k]]
            records[:, 9 * k + 6 : 9 * k + 9] = se2[slot[:, k]]
        valid = (ks[None, :] < count[:, None]) & (count[:, None] > 0)
        words = np.where(valid, sfl[slot], np.int32(-1)).astype(np.int32)
    return PackedBVH(
        nodes=jnp.asarray(nodes), records=jnp.asarray(records),
        words=jnp.asarray(words), n_nodes=n,
    )


def pack_update(packed: PackedBVH, bvh_host: FlatBVH, slot_v0, slot_e1, slot_e2,
                refitted: FlatBVH = None) -> PackedBVH:
    """Jit-able packed-table refresh for deformed geometry (skinned frames).

    Topology (first/count/skip, id words) is static; only the 36 geometry
    floats per record and the node AABBs change.
    """
    first = np.asarray(bvh_host.first)
    count = np.asarray(bvh_host.count)
    t = slot_v0.shape[0]
    slot = np.clip(first[:, None] + np.arange(LEAF_SIZE)[None, :], 0, max(t - 1, 0))
    cols = []
    for k in range(LEAF_SIZE):
        cols.extend([slot_v0[slot[:, k]], slot_e1[slot[:, k]], slot_e2[slot[:, k]]])
    records = jnp.concatenate(cols, axis=1)  # (N, REC_GEO)
    nodes = packed.nodes
    if refitted is not None:
        # Safe: columns 6-7 hold plain float values, not bitcast ints
        # (see PackedBVH docstring).
        nodes = jnp.concatenate(
            [refitted.aabb_min, refitted.aabb_max, packed.nodes[:, 6:8]], axis=1
        )
    return PackedBVH(nodes=nodes, records=records, words=packed.words,
                     n_nodes=packed.n_nodes)


def _mt_packed(origin, direction, rec, t_min, t_max):
    """Möller–Trumbore on LEAF_SIZE packed triangles. rec (R, REC_GEO).
    Returns (hit, t, u, v, det) each (R, LEAF_SIZE)."""
    hs, ts, us, vs, dets = [], [], [], [], []
    for k in range(LEAF_SIZE):
        p0 = rec[:, 9 * k : 9 * k + 3]
        e1 = rec[:, 9 * k + 3 : 9 * k + 6]
        e2 = rec[:, 9 * k + 6 : 9 * k + 9]
        pvec = jnp.cross(direction, e2)
        det = jnp.sum(e1 * pvec, -1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = origin - p0
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(direction * qvec, -1) * inv_det
        t = jnp.sum(e2 * qvec, -1) * inv_det
        h = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min)
            & (t < t_max)
        )
        hs.append(h)
        ts.append(t)
        us.append(u)
        vs.append(v)
        dets.append(det)
    return (
        jnp.stack(hs, -1),
        jnp.stack(ts, -1),
        jnp.stack(us, -1),
        jnp.stack(vs, -1),
        jnp.stack(dets, -1),
    )


def _apply_filters(h, det, words, blend_mode: int, cull_sign: int):
    valid = words >= 0
    h = h & valid
    if blend_mode == BLEND_EXCLUDE:
        h = h & ((words & FLAG_BLEND) == 0)
    elif blend_mode == BLEND_ONLY:
        h = h & ((words & FLAG_BLEND) != 0)
    if cull_sign:
        culled = (det * cull_sign < 0.0) & ((words & FLAG_DOUBLE_SIDED) == 0)
        h = h & (~culled)
    return h


def intersect_closest_p(
    packed: PackedBVH,
    origin,
    direction,
    t_min,
    t_max,
    blend_mode: int = BLEND_ANY,
    cull_sign: int = 0,
) -> Hit:
    """Closest hit with the packed one-gather-per-step layout.

    Returns Hit with ORIGINAL triangle ids (decoded from id words) and a
    `flags` word accessible via (tri >> 28) — callers use ID_MASK.
    """
    n_nodes = packed.n_nodes
    n_rays = origin.shape[0]
    inv_dir = jnp.where(
        jnp.abs(direction) > 1e-20, 1.0 / direction, jnp.sign(direction) * 1e20 + 1e20
    )

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        node, best_t, best_word, best_u, best_v = state
        node_c = jnp.clip(node, 0, n_nodes - 1)
        alive = node < n_nodes
        nrec = packed.nodes[node_c]
        lo = nrec[:, 0:3]
        hi = nrec[:, 3:6]
        skip = nrec[:, 7].astype(jnp.int32)
        is_leaf = nrec[:, 6] >= 0.0

        box_hit = _aabb_hit(origin, inv_dir, lo, hi, t_min, best_t) & alive

        do_tris = box_hit & is_leaf
        sel = jnp.where(do_tris, node_c, 0)
        rec = packed.records[sel]
        h, t, u, v, det = _mt_packed(origin, direction, rec, t_min, best_t)
        words = packed.words[sel]
        h = _apply_filters(h, det, words, blend_mode, cull_sign) & do_tris[:, None]

        t_masked = jnp.where(h, t, jnp.inf)
        k = jnp.argmin(t_masked, -1)
        rows = jnp.arange(n_rays)
        leaf_t = t_masked[rows, k]
        leaf_hit = leaf_t < best_t
        best_word = jnp.where(leaf_hit, words[rows, k], best_word)
        best_u = jnp.where(leaf_hit, u[rows, k], best_u)
        best_v = jnp.where(leaf_hit, v[rows, k], best_v)
        best_t = jnp.where(leaf_hit, leaf_t, best_t)

        descend = box_hit & (~is_leaf)
        next_node = jnp.where(descend, node_c + 1, skip)
        next_node = jnp.where(alive, next_node, node)
        return next_node, best_t, best_word, best_u, best_v

    fzero = origin[:, 0] * 0.0
    state = (
        fzero.astype(jnp.int32),
        jnp.broadcast_to(t_max, (n_rays,)) + fzero,
        fzero.astype(jnp.int32) - 1,
        fzero,
        fzero,
    )
    node, t, word, u, v = jax.lax.while_loop(cond, body, state)
    tri = jnp.where(word >= 0, word & ID_MASK, -1)
    return Hit(t=t, tri=tri, u=u, v=v)


def intersect_any_p(
    packed: PackedBVH,
    origin,
    direction,
    t_min,
    t_max,
    blend_mode: int = BLEND_ANY,
    cull_sign: int = 0,
):
    """Binary occlusion with the packed layout (early-out per ray)."""
    n_nodes = packed.n_nodes
    inv_dir = jnp.where(
        jnp.abs(direction) > 1e-20, 1.0 / direction, jnp.sign(direction) * 1e20 + 1e20
    )
    t_max_b = jnp.broadcast_to(t_max, t_min.shape)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        node, occluded = state
        node_c = jnp.clip(node, 0, n_nodes - 1)
        alive = node < n_nodes
        nrec = packed.nodes[node_c]
        lo = nrec[:, 0:3]
        hi = nrec[:, 3:6]
        skip = nrec[:, 7].astype(jnp.int32)
        is_leaf = nrec[:, 6] >= 0.0

        box_hit = _aabb_hit(origin, inv_dir, lo, hi, t_min, t_max_b) & alive
        do_tris = box_hit & is_leaf
        sel = jnp.where(do_tris, node_c, 0)
        rec = packed.records[sel]
        h, t, u, v, det = _mt_packed(origin, direction, rec, t_min, t_max_b)
        words = packed.words[sel]
        h = _apply_filters(h, det, words, blend_mode, cull_sign) & do_tris[:, None]
        occluded = occluded | jnp.any(h, -1)

        descend = box_hit & (~is_leaf)
        next_node = jnp.where(descend, node_c + 1, skip)
        next_node = jnp.where(occluded, n_nodes, next_node)
        next_node = jnp.where(alive, next_node, node)
        return next_node, occluded

    fzero = origin[:, 0] * 0.0
    state = (fzero.astype(jnp.int32), fzero.astype(bool))
    _, occluded = jax.lax.while_loop(cond, body, state)
    return occluded
