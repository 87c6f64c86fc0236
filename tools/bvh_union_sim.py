"""Offline BVH-quality metric: union node visits of a ray group.

A node counts as visited when ANY live ray of the group hits its box, over
the tree collapsed to `width`-wide nodes (two binary levels per wide level
at width 4). That count is computable exactly in numpy, so a change to BVH
construction can be judged without a device; tests/test_bvh.py pins it to a
band on a fixed scene.
"""

import numpy as np


def wide_children(tree, width=4):
    """FlatBVH -> wide arrays: boxes (W, width, 6) (NaN for an empty child),
    kids (W, width) wide ids (-1: not an internal child), leaf (W, width)
    binary leaf id (-1: not a leaf child), root wide id (0)."""
    levels = {4: 2, 8: 3, 16: 4}[width]
    count = np.asarray(tree.count)
    right = np.asarray(tree.right)
    lo = np.asarray(tree.aabb_min)
    hi = np.asarray(tree.aabb_max)

    def expand(b, depth):
        """Descend `depth` binary levels from node b, stopping at leaves."""
        if count[b] > 0 or depth == 0:
            return [b]
        return expand(b + 1, depth - 1) + expand(right[b], depth - 1)

    wide_id, children, work = {0: 0}, {0: [0]}, []
    if count[0] == 0:  # else a single-leaf tree: one wide node, the leaf
        work.append(0)
    while work:
        b = work.pop()
        children[b] = expand(b + 1, levels - 1) + expand(right[b], levels - 1)
        for e in children[b]:
            if count[e] == 0 and e not in wide_id:
                wide_id[e] = len(wide_id)
                work.append(e)
    order = sorted(wide_id, key=wide_id.get)
    boxes = np.full((len(order), width, 6), np.nan, np.float32)
    kids = np.full((len(order), width), -1, np.int64)
    leaf = np.full((len(order), width), -1, np.int64)
    for w, b in enumerate(order):
        for c, e in enumerate(children[b]):
            boxes[w, c, 0:3] = lo[e]
            boxes[w, c, 3:6] = hi[e]
            if count[e] > 0:
                leaf[w, c] = e
            else:
                kids[w, c] = wide_id[e]
    return boxes, kids, leaf, 0


def union_visits(boxes, kids, leaf, root, o, d, t_min, t_cap):
    """Count wide-node visits for ONE ray group (union semantics, pruning
    bound = per-lane t_cap). Returns (node_visits, leaf_visits,
    per_ray_visits_mean)."""
    inv = np.where(np.abs(d) > 1e-20, 1.0 / d, np.sign(d) * 1e30 + 1e30)
    stack = [root]
    node_visits = 0
    leaf_visits = 0
    per_ray = np.zeros(o.shape[0], np.int64)
    while stack:
        w = stack.pop()
        node_visits += 1
        b = boxes[w]                                   # (width, 6)
        # (width, R) slab tests
        t0 = (b[:, None, 0:3] - o[None]) * inv[None]
        t1 = (b[:, None, 3:6] - o[None]) * inv[None]
        tn = np.minimum(t0, t1).max(-1)
        tf = np.maximum(t0, t1).min(-1)
        hit = (tf >= np.maximum(tn, t_min[None])) & (tn <= t_cap[None])
        hit &= ~np.isnan(b[:, 0])[:, None]
        any_hit = hit.any(1)
        per_ray += hit.sum(0)
        for c in range(b.shape[0]):
            if not any_hit[c]:
                continue
            if kids[w, c] >= 0:
                stack.append(kids[w, c])
            elif leaf[w, c] >= 0:
                leaf_visits += 1
    return node_visits, leaf_visits, per_ray.mean()
