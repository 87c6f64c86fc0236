"""GPU skinning + morph targets as batched einsum ops (port of Skin.cs.hlsl).

The reference dispatches a 64-wide compute shader per dynamic primitive
(GpuSkin.cpp:57-118) with ≤4 morph targets (top-weight selection,
Renderer.cpp:423-444) and 4-bone matrix-palette skinning. Here the whole
dynamic vertex range is one batched einsum — no per-vertex loop. Skinned tangent space is re-quantized through the 10:10:10:2 codec to
match the reference's EncodeTangentSpace output (Skin.cs.hlsl:136).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.scene import types as T
from gltf_renderer.scene.flatten import trs_to_matrix_np
from gltf_renderer.utils.math import (
    decode_tangent_space,
    encode_tangent_space,
    normalize,
    unpack_r10g10b10a2,
)

MAX_SIMULTANEOUS_MORPH_TARGETS = 4  # Config.h:23


def select_top_morph_targets(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Top-K positive weights (Renderer.cpp:423-444). Returns (indices, weights)
    padded to MAX_SIMULTANEOUS_MORPH_TARGETS with weight 0."""
    idx = [i for i, w in enumerate(weights) if w > 0.0]
    idx.sort(key=lambda i: -weights[i])
    idx = idx[:MAX_SIMULTANEOUS_MORPH_TARGETS]
    out_i = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.int32)
    out_w = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.float32)
    for k, i in enumerate(idx):
        out_i[k] = i
        out_w[k] = float(weights[i])
    return out_i, out_w


def compute_bones(
    node_global: np.ndarray, skin: T.Skin, mesh_node_global: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Bone palettes (Renderer.cpp:412-417):
    bone = inverse(mesh_node.global) @ joint.global @ inverse_bind;
    inverse_transpose of the 3x3 for normals."""
    inv_node = np.linalg.inv(mesh_node_global)
    bones = inv_node[None] @ node_global[skin.joints] @ skin.inverse_bind
    it = bones.copy()
    it[:, :3, :3] = np.transpose(np.linalg.inv(bones[:, :3, :3]), (0, 2, 1))
    it[:, :3, 3] = 0.0
    return bones.astype(np.float32), it.astype(np.float32)


@jax.jit
def skin_primitive(
    positions,       # (V, 3) rest positions
    normals,         # (V, 3) rest (dequantized)
    tangents,        # (V, 4)
    joints,          # (V, 4) i32 (palette-local ids)
    weights,         # (V, 4) f32
    bones,           # (B, 4, 4)
    bones_it,        # (B, 4, 4)
    morph_pos,       # (K, V, 3) selected target position deltas
    morph_nrm,       # (K, V, 3)
    morph_tan,       # (K, V, 3)
    morph_weights,   # (K,)
    has_skin,        # () bool
    has_ts,          # () bool
):
    """Skin.cs.hlsl main:53-136 as one vectorized op."""
    mw = morph_weights[:, None, None]
    position = positions + jnp.sum(mw * morph_pos, 0)
    normal = normals + jnp.sum(mw * morph_nrm, 0)
    tangent_xyz = tangents[:, :3] + jnp.sum(mw * morph_tan, 0)

    # 4-bone matrix palette.
    b = bones[joints]          # (V, 4, 4, 4)
    bit = bones_it[joints]
    w = weights[..., None, None]
    blend = jnp.sum(w * b, 1)      # (V, 4, 4)
    blend_it = jnp.sum(w * bit, 1)
    # Geometry products run at full f32 (a GPU may otherwise take TF32).
    hi = jax.lax.Precision.HIGHEST
    skinned_pos = (jnp.einsum("vij,vj->vi", blend[:, :3, :3], position, precision=hi)
                   + blend[:, :3, 3])
    skinned_nrm = jnp.einsum("vij,vj->vi", blend_it[:, :3, :3], normal, precision=hi)
    skinned_tan = jnp.einsum("vij,vj->vi", blend[:, :3, :3], tangent_xyz, precision=hi)

    position = jnp.where(has_skin, skinned_pos, position)
    normal = jnp.where(has_skin, skinned_nrm, normal)
    tangent_xyz = jnp.where(has_skin, skinned_tan, tangent_xyz)

    # Re-quantize tangent space like EncodeTangentSpace (Skin.cs.hlsl:136).
    n_unit = normalize(normal)
    t_unit = normalize(tangent_xyz)
    packed = encode_tangent_space(
        n_unit, jnp.concatenate([t_unit, tangents[:, 3:4]], -1)
    )
    n_q, t_q = decode_tangent_space(unpack_r10g10b10a2(packed))
    normal = jnp.where(has_ts, n_q, n_unit)
    tangent = jnp.where(
        has_ts, t_q, jnp.concatenate([t_unit, tangents[:, 3:4]], -1)
    )
    return position, normal, tangent


class DynamicMeshState:
    """Per-scene dynamic (skinned/morphed) vertex pools.

    Replaces DynamicMesh double-buffering (Mesh.cpp:221-279): holds current
    object-space positions for dynamic primitives, scattered into full-pool
    shaped arrays consumed by flatten.build_world_geometry.
    """

    def __init__(self, scene: T.Scene):
        self.scene = scene
        v = scene.pools.positions.shape[0]
        self.positions = jnp.asarray(scene.pools.positions)
        self.normals = jnp.asarray(scene.pools.normals)
        self.tangents = jnp.asarray(scene.pools.tangents)
        # (node, prim) pairs needing skinning/morphing, static per scene.
        self.dynamic_instances: List[Tuple[int, int]] = []
        for node_id, node in enumerate(scene.nodes):
            if node.mesh < 0:
                continue
            has_morph = False
            for p in scene.meshes[node.mesh].primitives:
                if int(scene.primitives.morph_count[p]) > 0:
                    has_morph = True
            if node.skin >= 0 or has_morph or (node.weights is not None):
                for p in scene.meshes[node.mesh].primitives:
                    self.dynamic_instances.append((node_id, p))

    def update(self, node_global: np.ndarray, pose_weights: Dict[int, np.ndarray]):
        """Run skinning for all dynamic primitives (PerformSkinning port)."""
        scene = self.scene
        pools = scene.pools
        prim = scene.primitives
        for node_id, p in self.dynamic_instances:
            node = scene.nodes[node_id]
            vo = int(prim.vertex_offset[p])
            vc = int(prim.vertex_count[p])
            n_targets = int(prim.morph_count[p])
            mo = int(prim.morph_offset[p])

            weights = pose_weights.get(node_id)
            if weights is None or len(weights) == 0 or n_targets == 0:
                sel_w = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.float32)
                sel_i = np.zeros(MAX_SIMULTANEOUS_MORPH_TARGETS, np.int32)
            else:
                sel_i, sel_w = select_top_morph_targets(weights[:n_targets])

            k = MAX_SIMULTANEOUS_MORPH_TARGETS
            if n_targets > 0:
                mp = np.stack(
                    [np.asarray(pools.morph_pos[mo + i * vc : mo + (i + 1) * vc]) for i in sel_i]
                )
                mn = np.stack(
                    [np.asarray(pools.morph_normal[mo + i * vc : mo + (i + 1) * vc]) for i in sel_i]
                )
                mt = np.stack(
                    [np.asarray(pools.morph_tangent[mo + i * vc : mo + (i + 1) * vc]) for i in sel_i]
                )
            else:
                mp = np.zeros((k, vc, 3), np.float32)
                mn = np.zeros((k, vc, 3), np.float32)
                mt = np.zeros((k, vc, 3), np.float32)

            if node.skin >= 0:
                bones, bones_it = compute_bones(
                    node_global, scene.skins[node.skin], node_global[node_id]
                )
                has_skin = True
            else:
                bones = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
                bones_it = bones
                has_skin = False

            pos, nrm, tan = skin_primitive(
                jnp.asarray(pools.positions[vo : vo + vc]),
                jnp.asarray(pools.normals[vo : vo + vc]),
                jnp.asarray(pools.tangents[vo : vo + vc]),
                jnp.asarray(np.clip(pools.joints[vo : vo + vc], 0, len(bones) - 1)),
                jnp.asarray(pools.weights[vo : vo + vc]),
                jnp.asarray(bones),
                jnp.asarray(bones_it),
                jnp.asarray(mp),
                jnp.asarray(mn),
                jnp.asarray(mt),
                jnp.asarray(sel_w),
                jnp.asarray(has_skin),
                jnp.asarray(bool(prim.has_tangent_space[p])),
            )
            self.positions = self.positions.at[vo : vo + vc].set(pos)
            self.normals = self.normals.at[vo : vo + vc].set(nrm)
            self.tangents = self.tangents.at[vo : vo + vc].set(tan)
