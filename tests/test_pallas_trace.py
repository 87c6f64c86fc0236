"""Per-ray traversal kernel vs the XLA packed traversal (ground truth).

The kernel (ops/triton_trace.traverse) is the GPU path for every ray the
path tracer dispatches; these tests run it in interpret mode on the CPU
against ops/bvh.intersect_closest_p / intersect_any_p across the filter
combinations (cull_sign, blend_mode, any-hit, per-lane mode) and degenerate
rays — the DXR TraceRay flag semantics (Pathtracer.cpp:344-353). The same
comparison at full size runs compiled on the card in chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gltf_renderer.ops import bvh as bvh_ops
from gltf_renderer.ops import triton_trace
from gltf_renderer.render import pathtracer as pt


def traverse(packed, o, d, t_min, t_max, **kw):
    return triton_trace.traverse(packed, o, d, t_min, t_max, interpret=True, **kw)


def _random_scene(n_tris, seed, all_flags=True):
    """Random triangle soup in [-1, 1]^3 with randomized flag words."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    p0 = c + rs.uniform(-0.25, 0.25, (n_tris, 3)).astype(np.float32)
    p1 = c + rs.uniform(-0.25, 0.25, (n_tris, 3)).astype(np.float32)
    p2 = c + rs.uniform(-0.25, 0.25, (n_tris, 3)).astype(np.float32)
    tree = bvh_ops.build(p0, p1, p2)
    order = np.asarray(tree.tri_order)
    words = order.astype(np.int64).copy()
    if all_flags:
        words |= np.where(rs.rand(n_tris) < 0.3, bvh_ops.FLAG_MASKED, 0)
        words |= np.where(rs.rand(n_tris) < 0.3, bvh_ops.FLAG_BLEND, 0)
        words |= np.where(rs.rand(n_tris) < 0.3, bvh_ops.FLAG_DOUBLE_SIDED, 0)
    packed = bvh_ops.pack(
        tree, p0[order], (p1 - p0)[order], (p2 - p0)[order], words.astype(np.int32)
    )
    return packed


def _random_rays(n_rays, seed, coherent=False):
    rs = np.random.RandomState(seed)
    if coherent:
        o = np.tile(np.asarray([[0.0, -3.0, 0.0]], np.float32), (n_rays, 1))
        target = rs.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
        d = target - o
    else:
        o = rs.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
        d = rs.uniform(-1, 1, (n_rays, 3)).astype(np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    t_min = np.zeros(n_rays, np.float32)
    t_max = np.full(n_rays, 20.0, np.float32)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min), jnp.asarray(t_max)


def assert_closest_parity(ref, t, word, u, v, sel=None):
    """The parity rule of triton_trace.compare_hits: identical hit/miss; t
    within rtol 1e-4 / atol 1e-5; a different triangle only on a t-tie; u, v
    within rtol 1e-3 where the same triangle won. `sel` restricts the
    comparison to some lanes."""
    report = triton_trace.compare_hits(ref, t, word, u, v, sel)
    assert triton_trace.hits_agree(report), report
    assert report["lanes"] > 0


def _compare_closest(packed, o, d, t_min, t_max, cull_sign, blend_mode):
    ref = bvh_ops.intersect_closest_p(
        packed, o, d, t_min, t_max, blend_mode=blend_mode, cull_sign=cull_sign
    )
    t, word, u, v = traverse(packed, o, d, t_min, t_max,
                             cull_sign=cull_sign, blend_mode=blend_mode)
    assert_closest_parity(ref, t, word, u, v)


@pytest.mark.parametrize("cull_sign", [-1, 0, 1])
def test_closest_matches_xla_cull(cull_sign):
    packed = _random_scene(200, seed=7)
    o, d, t_min, t_max = _random_rays(256, seed=11)
    _compare_closest(packed, o, d, t_min, t_max, cull_sign, bvh_ops.BLEND_ANY)


@pytest.mark.parametrize(
    "blend_mode", [bvh_ops.BLEND_ANY, bvh_ops.BLEND_EXCLUDE, bvh_ops.BLEND_ONLY]
)
def test_closest_matches_xla_blend(blend_mode):
    packed = _random_scene(200, seed=13)
    o, d, t_min, t_max = _random_rays(256, seed=17)
    _compare_closest(packed, o, d, t_min, t_max, 0, blend_mode)


def test_closest_coherent_packet():
    packed = _random_scene(300, seed=23)
    o, d, t_min, t_max = _random_rays(512, seed=29, coherent=True)
    _compare_closest(packed, o, d, t_min, t_max, 0, bvh_ops.BLEND_ANY)


def test_any_hit_matches_xla():
    packed = _random_scene(200, seed=31)
    o, d, t_min, t_max = _random_rays(256, seed=37)
    ref = bvh_ops.intersect_any_p(packed, o, d, t_min, t_max)
    t, word, u, v = traverse(packed, o, d, t_min, t_max, any_hit=True)
    np.testing.assert_array_equal(np.asarray(word) >= 0, np.asarray(ref))


def test_degenerate_rays():
    """Axis-aligned and zero-component directions must not produce NaN hits."""
    packed = _random_scene(100, seed=41)
    o = jnp.asarray(
        [[0.0, -3.0, 0.0], [0.0, -3.0, 0.0], [-3.0, 0.0, 0.0], [0.0, 0.0, 3.0]],
        jnp.float32,
    )
    d = jnp.asarray(
        [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
        jnp.float32,
    )
    t_min = jnp.zeros(4, jnp.float32)
    t_max = jnp.full(4, 20.0, jnp.float32)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max)
    t, word, u, v = traverse(packed, o, d, t_min, t_max)
    np.testing.assert_array_equal(np.asarray(word) >= 0, np.asarray(ref.tri) >= 0)
    assert np.isfinite(np.asarray(t)).all()


def test_tmin_offset_respected():
    """Rays restarted past a hit (alpha retraversal pattern) skip that hit."""
    packed = _random_scene(200, seed=43)
    o, d, t_min, t_max = _random_rays(256, seed=47, coherent=True)
    t0, w0, _, _ = traverse(packed, o, d, t_min, t_max)
    has = np.asarray(w0) >= 0
    t_min2 = jnp.where(jnp.asarray(has), t0 * 1.0001 + 1e-5, t_max + 1.0)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min2, t_max)
    t1, w1, _, _ = traverse(packed, o, d, t_min2, t_max)
    np.testing.assert_array_equal(np.asarray(w1) >= 0, np.asarray(ref.tri) >= 0)
    both = (np.asarray(w1) >= 0) & has
    assert np.all(np.asarray(t1)[both] > np.asarray(t0)[both])


def test_lane_mode_mixed_dispatch():
    """any_hit="lane": closest and any-hit rays mixed per lane in ONE
    dispatch (the merged bounce+shadow path) must match the pure dispatches
    — closest lanes vs intersect_closest_p, any-hit lanes vs
    intersect_any_p. Culling applies only to the closest lanes."""
    packed = _random_scene(96, seed=5)
    o, d, t_min, t_max = _random_rays(160, seed=6)
    rs = np.random.RandomState(7)
    mode = jnp.asarray((rs.rand(160) < 0.5).astype(np.int32))
    m_any = np.asarray(mode) > 0
    ref_any = np.asarray(bvh_ops.intersect_any_p(packed, o, d, t_min, t_max))
    for cull in (0, 1):
        t, word, u, v = traverse(packed, o, d, t_min, t_max, any_hit="lane",
                                 mode=mode, cull_sign=cull)
        np.testing.assert_array_equal((np.asarray(word) >= 0)[m_any], ref_any[m_any])
        ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max, cull_sign=cull)
        assert_closest_parity(ref, t, word, u, v, sel=~m_any)


@pytest.mark.parametrize("n_rays", [1, 255, 257])
def test_padding_ray_counts(n_rays):
    """Ray counts that are not a multiple of the block pad with dead lanes
    and crop back: shapes and results match the reference."""
    packed = _random_scene(120, seed=51)
    o, d, t_min, t_max = _random_rays(n_rays, seed=52)
    t, word, u, v = traverse(packed, o, d, t_min, t_max)
    assert t.shape == word.shape == u.shape == v.shape == (n_rays,)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max)
    assert_closest_parity(ref, t, word, u, v)


@pytest.mark.parametrize("block", [32, 64, 256])
def test_block_sizes_agree(block):
    """Every block size of the sweep returns the reference's hits."""
    packed = _random_scene(150, seed=61)
    o, d, t_min, t_max = _random_rays(300, seed=62)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max)
    assert_closest_parity(ref, *traverse(packed, o, d, t_min, t_max, block=block))


def test_dead_and_scalar_tmax_lanes():
    """Empty intervals (t_min > t_max) miss and report t_max; a scalar t_max
    broadcasts like the reference's."""
    packed = _random_scene(80, seed=71)
    o, d, t_min, _ = _random_rays(64, seed=72)
    t_min = t_min.at[::2].set(30.0)
    t, word, _, _ = traverse(packed, o, d, t_min, jnp.float32(20.0))
    assert (np.asarray(word)[::2] == -1).all()
    np.testing.assert_array_equal(np.asarray(t)[::2], 20.0)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, jnp.float32(20.0))
    np.testing.assert_array_equal(np.asarray(word) >= 0, np.asarray(ref.tri) >= 0)


def test_mode_requires_lane_dispatch():
    packed = _random_scene(10, seed=1)
    o, d, t_min, t_max = _random_rays(8, seed=2)
    with pytest.raises(ValueError):
        traverse(packed, o, d, t_min, t_max, mode=jnp.zeros(8, jnp.int32))
    with pytest.raises(ValueError):
        traverse(packed, o, d, t_min, t_max, any_hit="lane")


def test_kernel_matches_xla_after_refit():
    """Deformed geometry: refit + pack_update tables (the animated-frame
    path) give the kernel the same hits as the reference."""
    rs = np.random.RandomState(81)
    n = 150
    c = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    p = [c + rs.uniform(-0.25, 0.25, (n, 3)).astype(np.float32) for _ in range(3)]
    tree = bvh_ops.build(*p)
    order = np.asarray(tree.tri_order)
    packed = bvh_ops.pack(tree, p[0][order], (p[1] - p[0])[order],
                          (p[2] - p[0])[order], order.astype(np.int32))
    # Deform: a twist around z plus a stretch.
    q = []
    for v in p:
        ang = 0.6 * v[:, 2:3]
        x = v[:, 0:1] * np.cos(ang) - v[:, 1:2] * np.sin(ang)
        y = v[:, 0:1] * np.sin(ang) + v[:, 1:2] * np.cos(ang)
        q.append(np.concatenate([1.3 * x, y, v[:, 2:3]], 1).astype(np.float32))
    q0, q1, q2 = (jnp.asarray(v) for v in q)
    refitted = bvh_ops.refit(tree, q0, q1, q2)
    packed2 = bvh_ops.pack_update(packed, tree, q0[order], (q1 - q0)[order],
                                  (q2 - q0)[order], refitted=refitted)
    o, d, t_min, t_max = _random_rays(256, seed=82, coherent=True)
    ref = bvh_ops.intersect_closest_p(packed2, o, d, t_min, t_max)
    assert (np.asarray(ref.tri) >= 0).sum() > 20
    assert_closest_parity(ref, *traverse(packed2, o, d, t_min, t_max))


def test_kernel_inside_shard_map():
    """The sharded renders call the kernel inside shard_map (with
    check_vma off, as parallel/sharding does): each device traverses its
    slice of the rays, with the same hits."""
    from jax.sharding import Mesh, PartitionSpec as P

    packed = _random_scene(120, seed=61)
    o, d, t_min, t_max = _random_rays(512, seed=62)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("rays",))
    fn = jax.shard_map(lambda pk, *r: traverse(pk, *r), mesh=mesh,
                       in_specs=(P(),) + (P("rays"),) * 4, out_specs=P("rays"),
                       check_vma=False)
    got = jax.jit(fn)(packed, o, d, t_min, t_max)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max)
    assert_closest_parity(ref, *got)


@pytest.mark.parametrize("platform,route", [("cpu", "xla"), ("gpu", "kernel"),
                                            ("rocm", "xla")])
def test_route_by_platform(platform, route):
    assert pt.traversal_route(platform) == route


def test_gpu_route_runs_kernel_compiled(monkeypatch):
    """On the GPU the kernel route calls the kernel with interpret=False —
    never the interpreter and never the XLA reference."""
    calls = []

    def fake_traverse(packed, origin, direction, t_min, t_max, **kw):
        calls.append(kw)
        r = origin.shape[0]
        return (jnp.broadcast_to(t_max, (r,)), jnp.full(r, -1, jnp.int32),
                jnp.zeros(r), jnp.zeros(r))

    def no_xla(*a, **kw):
        raise AssertionError("kernel route must not call the XLA reference")

    class FakeDevice:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    monkeypatch.setattr(triton_trace, "traverse", fake_traverse)
    monkeypatch.setattr(bvh_ops, "intersect_closest_p", no_xla)
    meta = pt.PTMeta(num_lights=0, has_masked=False, has_env=False,
                     traversal=pt.traversal_route())
    assert meta.traversal == "kernel"
    packed = _random_scene(10, seed=3)
    scene = pt.PTScene(world=None, bvh=None, packed=packed, materials=None,
                       textures=None, lights=None, env=None, sheen_table=None)
    o, d, t_min, t_max = _random_rays(8, seed=4)
    pt.closest_hit(scene, meta, o, d, t_min, t_max)
    assert calls and calls[0]["interpret"] is False


def test_cpu_route_is_xla_reference(monkeypatch):
    """make_pt_scene on the CPU selects the XLA route, and closest_hit then
    never touches the kernel."""
    from tests.scenes import write_box_gltf
    from gltf_renderer.scene import flatten
    from gltf_renderer.scene.gltf import load_gltf
    import tempfile
    import os

    path = os.path.join(tempfile.mkdtemp(), "box.gltf")
    write_box_gltf(path)
    scene = load_gltf(path)
    tf = flatten.compute_global_transforms(scene)
    plan = flatten.build_instance_plan(scene)
    world = flatten.build_world_geometry(
        jax.tree.map(jnp.asarray, scene.pools), plan, jnp.asarray(tf),
        jnp.asarray(flatten.normal_transforms(tf)),
        flatten.plan_tri_flags(plan, scene.primitives))
    ptscene, meta = pt.make_pt_scene(
        world, scene.materials, scene.textures, flatten.gather_lights(scene, tf))
    assert meta.traversal == "xla"

    def no_kernel(*a, **kw):
        raise AssertionError("the XLA route must not call the kernel")

    monkeypatch.setattr(triton_trace, "traverse", no_kernel)
    o, d, t_min, t_max = _random_rays(16, seed=9)
    hit = pt.closest_hit(ptscene, meta, o, d, t_min, t_max)
    assert hit.tri.shape == (16,)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_xla(gpu):
    """The compiled kernel (no interpreter) against the reference, on the
    card. chip_smoke.py runs the full-size version of this comparison."""
    packed = _random_scene(2000, seed=91)
    o, d, t_min, t_max = _random_rays(4096, seed=92)
    ref = bvh_ops.intersect_closest_p(packed, o, d, t_min, t_max)
    assert_closest_parity(ref, *triton_trace.traverse(packed, o, d, t_min, t_max))
