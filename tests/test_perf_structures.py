"""Tests for the gather-count optimization structures (round 2 perf work).

Covers the octant-ordered dispatch key, the sorted-dispatch scatter/gather
roundtrip in _kernel_closest, and the Walker alias table that replaces the hierarchical
importance-map descent (same texel distribution + pdf, one gather).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.ops import bvh as bvh_ops
from gltf_renderer.ops import sampling
from gltf_renderer.render import pathtracer as pt


def _keys(direction, t_min, t_max):
    return (
        (direction[:, 0] > 0).astype(np.int32) * 4
        + (direction[:, 1] > 0).astype(np.int32) * 2
        + (direction[:, 2] > 0).astype(np.int32)
        + np.where(t_min > t_max, 8, 0)
    )


def test_octant_positions_groups_by_key():
    rs = np.random.RandomState(7)
    n = 4096
    d = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = np.where(rs.rand(n) < 0.2, -1.0, 10.0).astype(np.float32)  # dead rays
    slot = rs.randint(0, 500, n).astype(np.int32)
    pos = np.asarray(pt._octant_positions(jnp.asarray(d), jnp.asarray(t_min),
                                          jnp.asarray(t_max), jnp.asarray(slot)))
    # pos is a permutation.
    assert sorted(pos.tolist()) == list(range(n))
    # Rays arrive grouped by (locality slot, octant), dead rays last: the key
    # read off in sorted order must be non-decreasing.
    dead = t_min > t_max
    key = np.where(dead, np.int64(2**40), slot.astype(np.int64) * 16 + _keys(d, t_min, np.full(n, 10.0)))
    order = np.empty(n, np.int64)
    order[pos] = np.arange(n)          # sorted index -> ray
    assert (np.diff(key[order]) >= 0).all()
    # All dead rays are at the end.
    n_dead = int(dead.sum())
    assert dead[order][n - n_dead:].all()


def test_packet_closest_sorted_roundtrip(monkeypatch):
    """sort_rays=True must return identical hits to sort_rays=False.

    The kernel is stubbed with the XLA ground truth so this isolates the
    scatter/gather reorder logic."""
    rs = np.random.RandomState(3)
    n_tris = 64
    c = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    p0 = c + rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    p1 = c + rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    p2 = c + rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    tree = bvh_ops.build(p0, p1, p2)
    order = np.asarray(tree.tri_order)
    packed = bvh_ops.pack(
        tree, p0[order], (p1 - p0)[order], (p2 - p0)[order],
        order.astype(np.int32),
    )
    scene = pt.PTScene(
        world=None, bvh=tree, packed=packed, materials=None, textures=None,
        lights=None, env=None, sheen_table=None,
    )
    meta = pt.PTMeta(num_lights=0, has_masked=False, has_env=False,
                     traversal="kernel")

    from gltf_renderer.ops import triton_trace

    def fake_traverse(packed_, origin, direction, t_min, t_max, **kw):
        hit = bvh_ops.intersect_closest_p(packed_, origin, direction, t_min, t_max)
        word = jnp.where(hit.tri >= 0, hit.tri, -1)
        return hit.t, word, hit.u, hit.v

    monkeypatch.setattr(triton_trace, "traverse", fake_traverse)
    monkeypatch.setattr(pt, "_no_sort", lambda: False)

    n = 512
    o = jnp.asarray(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    t_min = jnp.zeros(n)
    t_max = jnp.full(n, 20.0)
    plain = pt._kernel_closest(scene, meta, o, d, t_min, t_max, sort_rays=False)
    srt = pt._kernel_closest(scene, meta, o, d, t_min, t_max, sort_rays=True)
    np.testing.assert_array_equal(np.asarray(srt.tri), np.asarray(plain.tri))
    np.testing.assert_allclose(np.asarray(srt.t), np.asarray(plain.t))
    np.testing.assert_allclose(np.asarray(srt.u), np.asarray(plain.u))
    np.testing.assert_allclose(np.asarray(srt.v), np.asarray(plain.v))


def _sum_mips(m):
    mips = [jnp.asarray(m)]
    cur = np.asarray(m)
    while cur.shape[0] > 1:
        cur = cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        mips.append(jnp.asarray(cur))
    return mips


def test_alias_rows_distribution_and_pdf():
    rs = np.random.RandomState(11)
    size = 16
    m = (rs.rand(size, size) ** 3).astype(np.float32) + 1e-4
    m[3, 5] = 25.0  # hotspot
    mips = _sum_mips(m)
    total = float(np.asarray(mips[-1])[0, 0])
    rows = sampling.build_alias_rows(m)

    # Alias invariant: expected mass per texel reproduces p exactly.
    n = size * size
    thresh = rows[:, 0].astype(np.float64)
    alias = rows[:, 1].view(np.float32).view(np.int32)
    mass = thresh.copy()
    np.add.at(mass, alias, 1.0 - thresh)
    p = (m.reshape(-1).astype(np.float64)) / m.sum()
    np.testing.assert_allclose(mass / n, p, rtol=1e-5, atol=1e-9)

    # Sampled pdf is the exact texel's value * size^2 / total — identical to
    # what the hierarchical descent returns for the same texel. (NOTE the
    # reference's ImportanceMapPdf *query* reads the (x-1, y-1) neighbor via
    # the UVToPixel truncation quirk, Common.hlsli:12-15 — both paths keep
    # that quirk for MIS queries; the sampler itself is exact.)
    k = 20000
    u4 = jnp.asarray(rs.rand(k, 4).astype(np.float32))
    uv, pdf, _rgb = sampling.sample_importance_alias(
        jnp.asarray(rows), size, jnp.float32(total), u4
    )
    px = np.minimum((np.asarray(uv[:, 0]) * size).astype(int), size - 1)
    py = np.minimum((np.asarray(uv[:, 1]) * size).astype(int), size - 1)
    expect = size * size * m[py, px] / total
    np.testing.assert_allclose(np.asarray(pdf), expect, rtol=1e-4)

    # Histogram over texels matches p (loose MC bound).
    px = np.minimum((np.asarray(uv[:, 0]) * size).astype(int), size - 1)
    py = np.minimum((np.asarray(uv[:, 1]) * size).astype(int), size - 1)
    counts = np.zeros(n)
    np.add.at(counts, py * size + px, 1.0)
    freq = counts / k
    err = np.abs(freq - p)
    bound = 4.0 * np.sqrt(np.maximum(p, 1e-6) / k) + 2e-3
    assert (err < bound).mean() > 0.99, f"too many off-distribution texels"


def test_alias_matches_descent_distribution():
    """Alias sampling and hierarchical descent draw from the same texel pmf."""
    rs = np.random.RandomState(5)
    size = 8
    m = (rs.rand(size, size) + 0.05).astype(np.float32)
    mips = _sum_mips(m)
    total = float(np.asarray(mips[-1])[0, 0])
    rows = jnp.asarray(sampling.build_alias_rows(m))
    k = 40000
    u = jnp.asarray(rs.rand(k, 4).astype(np.float32))
    uv_a, _, _ = sampling.sample_importance_alias(rows, size, jnp.float32(total), u)
    uv_d, _ = sampling.sample_importance_map(mips, u[:, :2])

    def hist(uv):
        px = np.minimum((np.asarray(uv[:, 0]) * size).astype(int), size - 1)
        py = np.minimum((np.asarray(uv[:, 1]) * size).astype(int), size - 1)
        c = np.zeros(size * size)
        np.add.at(c, py * size + px, 1.0)
        return c / k

    ha, hd = hist(uv_a), hist(uv_d)
    assert np.abs(ha - hd).max() < 0.02


def test_bf16_attr_rows_match_f32(monkeypatch):
    """GLTF_BF16ROWS=1 probe: the bf16 hit-attribute table returns the
    same materials/flags exactly and attributes to bf16 precision."""
    from gltf_renderer.scene.procedural import write_materials_gltf
    from gltf_renderer.scene.gltf import load_gltf
    from gltf_renderer.scene import flatten as F

    path = write_materials_gltf("/tmp/bf16_zoo.gltf")
    scene = load_gltf(path)
    plan = F.build_instance_plan(scene)
    tf = jnp.asarray(np.tile(np.eye(4, dtype=np.float32),
                             (len(scene.nodes), 1, 1)))
    flags = F.plan_tri_flags(plan, scene.primitives)

    world32 = F.build_world_geometry(scene.pools, plan, tf, tf, flags)
    monkeypatch.setenv("GLTF_BF16ROWS", "1")
    world16 = F.build_world_geometry(scene.pools, plan, tf, tf, flags)
    assert world16.tri_attr_rows.dtype == jnp.bfloat16

    n = min(512, world32.tri_vertex.shape[0])
    tri = jnp.arange(n, dtype=jnp.int32)
    u = jnp.full(n, 0.25)
    v = jnp.full(n, 0.5)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    a32 = pt.fetch_hit_attributes(world32, tri, u, v, d)
    a16 = pt.fetch_hit_attributes(world16, tri, u, v, d)
    np.testing.assert_array_equal(np.asarray(a32.material), np.asarray(a16.material))
    np.testing.assert_array_equal(np.asarray(a32.back_face), np.asarray(a16.back_face))
    # bf16 has 8 mantissa bits -> ~0.4% relative error on interpolants.
    np.testing.assert_allclose(
        np.asarray(a32.position), np.asarray(a16.position), atol=2e-2, rtol=1e-2)
    dots = np.sum(np.asarray(a32.normal) * np.asarray(a16.normal), -1)
    assert (dots > 0.999).all()

    # With the ray parameterization supplied, bf16 positions are rebuilt as
    # origin + t*dir — EXACT f32, no bf16 error at all (next-bounce origins).
    o = jnp.tile(jnp.asarray([[0.5, -0.25, -3.0]]), (n, 1))
    t = jnp.linspace(1.0, 4.0, n)
    a16p = pt.fetch_hit_attributes(world16, tri, u, v, d, ray_origin=o, ray_t=t)
    np.testing.assert_array_equal(
        np.asarray(a16p.position), np.asarray(o + t[:, None] * d))
    # The f32 path ignores the ray params (interpolation stays golden-exact).
    a32p = pt.fetch_hit_attributes(world32, tri, u, v, d, ray_origin=o, ray_t=t)
    np.testing.assert_array_equal(
        np.asarray(a32p.position), np.asarray(a32.position))


def test_bf16_attr_rows_auto_gate_and_wide_ids(monkeypatch):
    """GLTF_BF16ROWS=auto (default): f32 rows below _BF16ROWS_MIN_TRIS,
    bf16 above. Material ids beyond 255 survive
    the hi/lo byte split exactly (a plain bf16 int is only exact to 256)."""
    from gltf_renderer.scene.procedural import write_materials_gltf
    from gltf_renderer.scene.gltf import load_gltf
    from gltf_renderer.scene import flatten as F

    path = write_materials_gltf("/tmp/bf16_zoo2.gltf")
    scene = load_gltf(path)
    plan = F.build_instance_plan(scene)
    tf = jnp.asarray(np.tile(np.eye(4, dtype=np.float32),
                             (len(scene.nodes), 1, 1)))
    flags = F.plan_tri_flags(plan, scene.primitives)

    monkeypatch.delenv("GLTF_BF16ROWS", raising=False)
    w_small = F.build_world_geometry(scene.pools, plan, tf, tf, flags)
    assert w_small.tri_attr_rows.dtype == jnp.float32  # under the threshold

    monkeypatch.setattr(F, "_BF16ROWS_MIN_TRIS", 1)
    w_big = F.build_world_geometry(scene.pools, plan, tf, tf, flags)
    assert w_big.tri_attr_rows.dtype == jnp.bfloat16  # over the threshold

    # Wide material ids: re-plan with ids pushed past 255 and check the
    # gather reconstructs them exactly through the byte split.
    plan_wide = plan._replace(
        tri_material=plan.tri_material.astype(jnp.int32) + 300
    )
    w_wide = F.build_world_geometry(scene.pools, plan_wide, tf, tf, flags)
    n = min(64, w_wide.tri_vertex.shape[0])
    tri = jnp.arange(n, dtype=jnp.int32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    a = pt.fetch_hit_attributes(w_wide, tri, jnp.full(n, 0.3), jnp.full(n, 0.3), d)
    np.testing.assert_array_equal(
        np.asarray(a.material),
        np.asarray(plan_wide.tri_material[:n], np.int32))
