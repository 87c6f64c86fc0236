"""Scene flattening: node transforms + instance plan + world-space geometry.

Replacement for the reference's per-frame TLAS instance gathering
(Pathtracer.cpp:185-257) and recursive CPU transform propagation
(Gltf.cpp:1015-1041): the traversal is unrolled ONCE at load into static gather
maps (InstancePlan); each frame is then pure vectorized gathers + one batched
4x4 transform — jit-friendly, no recursion, no host loop.
"""

from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.scene import types as T

# glTF Y-up -> renderer Z-up basis change (Gltf.cpp:1017-1022, row-major here):
# (x, y, z)_gltf -> (x, -z, y)_world.
Y_UP_TO_Z_UP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)


def trs_to_matrix_np(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(…,3),(…,4 xyzw),(…,3) -> (…,4,4) row-major (M @ column-vector)."""
    x, y, z, w = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    rot = np.empty(r.shape[:-1] + (3, 3), np.float32)
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - z * w)
    rot[..., 0, 2] = 2 * (x * z + y * w)
    rot[..., 1, 0] = 2 * (x * y + z * w)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - x * w)
    rot[..., 2, 0] = 2 * (x * z - y * w)
    rot[..., 2, 1] = 2 * (y * z + x * w)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    m = np.zeros(r.shape[:-1] + (4, 4), np.float32)
    m[..., :3, :3] = rot * s[..., None, :]
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def trs_to_matrix(t, r, s):
    """jnp version of trs_to_matrix_np (vectorized)."""
    x, y, z, w = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    one = jnp.ones_like(x)
    rot = jnp.stack(
        [
            jnp.stack([one - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            jnp.stack([2 * (x * y + z * w), one - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), one - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
    rs = rot * s[..., None, :]
    top = jnp.concatenate([rs, t[..., :, None]], -1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], rs.dtype), t.shape[:-1] + (1, 4)
    )
    return jnp.concatenate([top, bottom], -2)


def compute_global_transforms(
    scene: T.Scene,
    scene_id: Optional[int] = None,
    local_t: Optional[np.ndarray] = None,
    local_r: Optional[np.ndarray] = None,
    local_s: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host-side global transforms (N, 4, 4), parents-first propagation.

    Matches Gltf::CalculateGlobalTransforms (Gltf.cpp:1015-1041): root nodes
    are premultiplied by the Y-up->Z-up basis change; global = parent * T*R*S.
    """
    n = scene.num_nodes()
    if local_t is None:
        local_t = np.stack([nd.translation for nd in scene.nodes]) if n else np.zeros((0, 3))
        local_r = np.stack([nd.rotation for nd in scene.nodes]) if n else np.zeros((0, 4))
        local_s = np.stack([nd.scale for nd in scene.nodes]) if n else np.zeros((0, 3))
    local = trs_to_matrix_np(
        np.asarray(local_t, np.float32),
        np.asarray(local_r, np.float32),
        np.asarray(local_s, np.float32),
    )
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in scene.topo_order:
        p = scene.nodes[i].parent
        parent_m = out[p] if p >= 0 else Y_UP_TO_Z_UP
        out[i] = parent_m @ local[i]
    return out


def normal_transforms(global_tf: np.ndarray) -> np.ndarray:
    """inverse-transpose (Pathtracer.cpp:205, Renderer.cpp:483)."""
    return np.transpose(np.linalg.inv(global_tf), (0, 2, 1)).astype(np.float32)


# tri_rows flag bits (packed per-triangle word, see build_world_geometry).
TRI_HAS_TS = 1
TRI_HAS_UV0 = 2
TRI_HAS_UV1 = 4
TRI_HAS_COLOR = 8
TRI_DOUBLE_SIDED = 16
TRI_ALPHA_SHIFT = 5  # alpha_mode in bits 5-6

# GLTF_BF16ROWS=auto threshold: bf16 attribute rows halve the table
# (12.5 MB -> 6.2 MB on the helmet), which won before the GPU port; on the
# H100 (50 MB L2) it is not yet measured. The threshold keeps tiny
# test/golden scenes (<32k tris) on exact f32 attribute interpolation.
_BF16ROWS_MIN_TRIS = 32768


class WorldGeometry(NamedTuple):
    """Per-frame world-space flattened geometry (the PT/raster input)."""

    position: Any   # (VW, 3) f32
    normal: Any     # (VW, 3) f32 (normalized)
    tangent: Any    # (VW, 4) f32 (xyz normalized, w winding)
    uv0: Any        # (VW, 2)
    uv1: Any        # (VW, 2)
    color: Any      # (VW, 4)
    tri_vertex: Any  # (TW, 3) i32
    tri_material: Any  # (TW,) i32
    tri_double_sided: Any  # (TW,) i32
    tri_alpha_mode: Any    # (TW,) i32
    tri_has_ts: Any        # (TW,) i32 — tangent-space present flag
    tri_has_uv0: Any       # (TW,) i32
    tri_has_uv1: Any       # (TW,) i32
    tri_has_color: Any     # (TW,) i32
    # Packed hot-path rows: ONE row gather fetches a vertex / a triangle.
    vertex_rows: Any = None  # (VW, 20) f32: pos3 nrm3 tan4 uv0_2 uv1_2 col4 pad2
    tri_rows: Any = None     # (TW, 8) i32: v0 v1 v2 material flagbits 0 0 0
    # Tri-major hit-attribute rows: ONE (R, 64) gather per hit fetch instead
    # of 1 tri-row + 3 vertex-row gathers (chosen before the GPU port; not
    # yet measured on the H100).
    tri_attr_rows: Any = None  # (TW, 64) f32: v0row v1row v2row | material fbits (bitcast) pad2


def build_instance_plan(scene: T.Scene, scene_id: Optional[int] = None) -> T.InstancePlan:
    """Unroll the scene traversal into static gather maps (host, load time)."""
    if scene_id is None:
        scene_id = scene.default_scene
    prim = scene.primitives
    mat = scene.materials

    v_maps, v_nodes, v_skinned = [], [], []
    tri_v, tri_m, tri_p, tri_ds, tri_am = [], [], [], [], []
    inst_node, inst_prim = [], []
    vw_off = 0

    order: List[int] = []
    stack = list(reversed(scene.scenes[scene_id])) if scene.scenes else []
    while stack:
        i = stack.pop()
        order.append(i)
        stack.extend(reversed(scene.nodes[i].children))

    for node_id in order:
        node = scene.nodes[node_id]
        if node.mesh < 0:
            continue
        mesh = scene.meshes[node.mesh]
        dynamic = node.skin >= 0 or _node_has_morph(scene, node_id)
        for p in mesh.primitives:
            vo = int(prim.vertex_offset[p])
            vc = int(prim.vertex_count[p])
            to = int(prim.tri_offset[p])
            tc = int(prim.tri_count[p])
            m = int(prim.material[p])
            v_maps.append(np.arange(vo, vo + vc, dtype=np.int32))
            v_nodes.append(np.full(vc, node_id, np.int32))
            v_skinned.append(np.full(vc, 1 if dynamic else 0, np.int32))
            # Triangles: source pool ids -> world pool ids.
            src_tris = scene.pools.tri_vertex[to : to + tc]
            tri_v.append(src_tris - vo + vw_off)
            tri_m.append(np.full(tc, m, np.int32))
            tri_p.append(np.full(tc, p, np.int32))
            ds = 1 if (int(mat.flags[m]) & T.MATERIAL_FLAG_DOUBLE_SIDED) else 0
            tri_ds.append(np.full(tc, ds, np.int32))
            tri_am.append(np.full(tc, int(mat.alpha_mode[m]), np.int32))
            inst_node.append(node_id)
            inst_prim.append(p)
            vw_off += vc

    cat = lambda lst, shape, dt=np.int32: (
        np.concatenate(lst, 0) if lst else np.zeros(shape, dt)
    )
    return T.InstancePlan(
        vertex_map=cat(v_maps, (0,)),
        vertex_node=cat(v_nodes, (0,)),
        vertex_skinned=cat(v_skinned, (0,)),
        tri_vertex=cat(tri_v, (0, 3)),
        tri_material=cat(tri_m, (0,)),
        tri_prim=cat(tri_p, (0,)),
        tri_double_sided=cat(tri_ds, (0,)),
        tri_alpha_mode=cat(tri_am, (0,)),
        instance_node=np.asarray(inst_node, np.int32),
        instance_prim=np.asarray(inst_prim, np.int32),
    )


def _node_has_morph(scene: T.Scene, node_id: int) -> bool:
    node = scene.nodes[node_id]
    if node.weights is not None and len(node.weights) > 0:
        return True
    if node.mesh >= 0:
        mw = scene.meshes[node.mesh].weights
        if mw is not None and len(mw) > 0:
            return True
        return any(int(scene.primitives.morph_count[p]) > 0 for p in scene.meshes[node.mesh].primitives)
    return False


def plan_tri_flags(plan: T.InstancePlan, primitives: T.PrimitiveTable):
    """Static per-world-triangle attribute flags (host)."""
    p = np.asarray(plan.tri_prim)
    return dict(
        tri_has_ts=np.asarray(primitives.has_tangent_space)[p].astype(np.int32),
        tri_has_uv0=np.asarray(primitives.has_uv0)[p].astype(np.int32),
        tri_has_uv1=np.asarray(primitives.has_uv1)[p].astype(np.int32),
        tri_has_color=np.asarray(primitives.has_color)[p].astype(np.int32),
    )


def build_world_geometry(
    pools: T.GeometryPools,
    plan: T.InstancePlan,
    node_tf,                 # (N, 4, 4)
    node_normal_tf,          # (N, 4, 4)
    tri_flags,               # dict from plan_tri_flags (static arrays)
    dynamic_positions=None,  # (V, 3) skinned/morphed object-space positions
    dynamic_normals=None,    # (V, 3)
    dynamic_tangents=None,   # (V, 4)
) -> WorldGeometry:
    """Jit-able: gather + transform object pools into world-space pools.

    Equivalent to what GetVertexAttributes does per-ray on GPU
    (PathTracer.lib.hlsl:280-302) — but hoisted out of the ray loop: transforms
    are applied once per vertex per frame, not once per hit. Skinned vertices
    source from the dynamic pools (still node-local space — bones are
    premultiplied by inverse(node.global), Renderer.cpp:414).
    """
    plan = jax.tree.map(jnp.asarray, plan)
    tri_flags = {k: jnp.asarray(v) for k, v in tri_flags.items()}
    vm = plan.vertex_map
    vn = plan.vertex_node

    pos = pools.positions[vm]
    nrm = pools.normals[vm]
    tan = pools.tangents[vm]
    if dynamic_positions is not None:
        sk = plan.vertex_skinned[:, None].astype(bool)
        pos = jnp.where(sk, dynamic_positions[vm], pos)
        nrm = jnp.where(sk, dynamic_normals[vm], nrm)
        tan = jnp.where(sk, dynamic_tangents[vm], tan)

    m = node_tf[vn]          # (VW, 4, 4)
    nm = node_normal_tf[vn]

    # Geometry products run at full f32 (a GPU may otherwise take TF32).
    hi = jax.lax.Precision.HIGHEST
    wpos = jnp.einsum("vij,vj->vi", m[:, :3, :3], pos, precision=hi) + m[:, :3, 3]
    wnrm = jnp.einsum("vij,vj->vi", nm[:, :3, :3], nrm, precision=hi)
    wnrm = wnrm / jnp.maximum(jnp.linalg.norm(wnrm, axis=-1, keepdims=True), 1e-20)
    wtan = jnp.einsum("vij,vj->vi", m[:, :3, :3], tan[:, :3], precision=hi)
    wtan = wtan / jnp.maximum(jnp.linalg.norm(wtan, axis=-1, keepdims=True), 1e-20)
    wtan = jnp.concatenate([wtan, tan[:, 3:4]], -1)

    uv0 = pools.uv0[vm]
    uv1 = pools.uv1[vm]
    color = pools.color[vm]
    vertex_rows = jnp.concatenate(
        [wpos, wnrm, wtan, uv0, uv1, color, jnp.zeros((wpos.shape[0], 2), wpos.dtype)],
        axis=1,
    )
    flagbits = (
        tri_flags["tri_has_ts"] * TRI_HAS_TS
        + tri_flags["tri_has_uv0"] * TRI_HAS_UV0
        + tri_flags["tri_has_uv1"] * TRI_HAS_UV1
        + tri_flags["tri_has_color"] * TRI_HAS_COLOR
        + plan.tri_double_sided * TRI_DOUBLE_SIDED
        + (plan.tri_alpha_mode << TRI_ALPHA_SHIFT)
    ).astype(jnp.int32)
    zeros_t = jnp.zeros((plan.tri_vertex.shape[0], 3), jnp.int32)
    tri_rows = jnp.concatenate(
        [
            plan.tri_vertex.astype(jnp.int32),
            plan.tri_material[:, None].astype(jnp.int32),
            flagbits[:, None],
            zeros_t,
        ],
        axis=1,
    )
    tv = plan.tri_vertex.astype(jnp.int32)
    tri_attr_rows = jnp.concatenate(
        [
            vertex_rows[tv[:, 0]],
            vertex_rows[tv[:, 1]],
            vertex_rows[tv[:, 2]],
            jax.lax.bitcast_convert_type(
                plan.tri_material.astype(jnp.int32), jnp.float32
            )[:, None],
            jax.lax.bitcast_convert_type(flagbits, jnp.float32)[:, None],
            jnp.zeros((tv.shape[0], 2), jnp.float32),
        ],
        axis=1,
    )
    # bf16 hit-attribute table: half the HBM bytes/cache footprint. The
    # per-fetch bf16->f32 convert only pays for itself when the table is big
    # enough to be bandwidth/cache-bound, so AUTO (default) enables it above
    # _BF16ROWS_MIN_TRIS (a threshold chosen before the GPU port, not yet
    # measured on the H100). Hit POSITIONS are
    # protected: fetch_hit_attributes rebuilds them as origin + t*dir (exact
    # f32 from the leaf records' f32 triangle test) when rows are bf16.
    # material/fbits ride as hi/lo byte pairs (each 0..255, bf16-exact).
    bf16_env = os.environ.get("GLTF_BF16ROWS", "auto")
    use_bf16 = bf16_env == "1" or (
        bf16_env not in ("0", "1") and tv.shape[0] > _BF16ROWS_MIN_TRIS
    )
    if use_bf16:
        mat_i = plan.tri_material.astype(jnp.int32)
        tri_attr_rows = jnp.concatenate(
            [
                tri_attr_rows[:, 0:60].astype(jnp.bfloat16),
                (mat_i & 255).astype(jnp.bfloat16)[:, None],
                (flagbits & 255).astype(jnp.bfloat16)[:, None],
                (mat_i >> 8).astype(jnp.bfloat16)[:, None],
                (flagbits >> 8).astype(jnp.bfloat16)[:, None],
            ],
            axis=1,
        )
    return WorldGeometry(
        position=wpos,
        normal=wnrm,
        tangent=wtan,
        uv0=uv0,
        uv1=uv1,
        color=color,
        tri_vertex=plan.tri_vertex,
        tri_material=plan.tri_material,
        tri_double_sided=plan.tri_double_sided,
        tri_alpha_mode=plan.tri_alpha_mode,
        tri_has_ts=tri_flags["tri_has_ts"],
        tri_has_uv0=tri_flags["tri_has_uv0"],
        tri_has_uv1=tri_flags["tri_has_uv1"],
        tri_has_color=tri_flags["tri_has_color"],
        vertex_rows=vertex_rows,
        tri_rows=tri_rows,
        tri_attr_rows=tri_attr_rows,
    )


def gather_lights(scene: T.Scene, node_tf: np.ndarray) -> T.GpuLights:
    """Per-frame light table (Renderer::GatherLights, Renderer.cpp:459-492)."""
    ln = scene.light_nodes
    lp = scene.light_params
    lid = np.asarray([scene.nodes[i].light for i in ln], np.int32)
    if len(ln) == 0:
        z3 = np.zeros((0, 3), np.float32)
        z = np.zeros(0, np.float32)
        return T.GpuLights(np.zeros(0, np.int32), z3, z3, z3, z, z, z, z)
    tf = node_tf[ln]
    pos = tf[:, :3, 3]
    ntf = np.transpose(np.linalg.inv(tf), (0, 2, 1))
    d = ntf[:, :3, :3] @ np.asarray([0.0, 0.0, -1.0], np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
    return T.GpuLights(
        type=lp.type[lid],
        position=pos.astype(np.float32),
        direction=d.astype(np.float32),
        color=lp.color[lid],
        intensity=lp.intensity[lid],
        cutoff=lp.cutoff[lid],
        inner_angle=lp.inner_angle[lid],
        outer_angle=lp.outer_angle[lid],
    )
