"""Scene data model: host-side (numpy) and device-side (jnp pytree) types.

Redesign of the reference's scene layer (Gltf.h:16-233, Mesh.h,
Renderer.h:53-171): instead of D3D12 placed buffers + bindless descriptors, the
scene is a struct-of-arrays pytree. "Descriptors" become integer indices into
concatenated pools; the 16-texture bindless material (Material.hlsli:23-66)
becomes a (M, N_TEX_SLOTS) index table into one texture atlas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np

# Texture slots — order mirrors Material.hlsli:35-65.
TEX_NORMAL = 0
TEX_ALBEDO = 1
TEX_METALLIC_ROUGHNESS = 2
TEX_OCCLUSION = 3
TEX_EMISSIVE = 4
TEX_SPECULAR = 5
TEX_SPECULAR_COLOR = 6
TEX_CLEARCOAT = 7
TEX_CLEARCOAT_ROUGHNESS = 8
TEX_CLEARCOAT_NORMAL = 9
TEX_ANISOTROPY = 10
TEX_SHEEN_COLOR = 11
TEX_SHEEN_ROUGHNESS = 12
TEX_TRANSMISSION = 13
TEX_THICKNESS = 14
N_TEX_SLOTS = 15

# Material flags (Material.hlsli:3-6 + Gltf.h:88-92).
MATERIAL_FLAG_DOUBLE_SIDED = 1 << 0
MATERIAL_FLAG_UNLIT = 1 << 1

# Alpha modes (Material.hlsli:8-12).
ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_MASK = 1
ALPHA_MODE_BLEND = 2

# Light types (Lights.hlsli:3-7).
LIGHT_TYPE_POINT = 0
LIGHT_TYPE_SPOT = 1
LIGHT_TYPE_DIRECTIONAL = 2

# Packed material row layout (see pack_material_rows).
MATERIAL_ROW_FACTORS = 34
MATERIAL_SLOT_STRIDE = 7
MATERIAL_ROW_WIDTH = MATERIAL_ROW_FACTORS + 15 * MATERIAL_SLOT_STRIDE  # 139 -> pad 144


def pack_material_rows(m) -> "Any":
    """Pack a MaterialTable into (M, 144) f32 rows (ints bitcast).

    Layout: [0:4] base_color, [4] metal, [5] rough, [6] occl, [7:10] emissive,
    [10] alpha_cutoff, [11] ior, [12] normal_scale, [13] specular_factor,
    [14:17] specular_color, [17] clearcoat, [18] cc_rough, [19] cc_nrm_scale,
    [20] aniso_strength, [21] aniso_rotation, [22:25] sheen_color,
    [25] sheen_rough, [26] transmission, [27] thickness, [28] atten_dist,
    [29:32] atten_color, [32] flags(i32), [33] alpha_mode(i32);
    per slot s: base 34+7s: [tex_index(i32), uvset(i32), rotation, off.xy,
    scale.xy].
    """
    import numpy as _np

    M = len(_np.asarray(m.flags))
    rows = _np.zeros((M, 144), _np.float32)
    rows[:, 0:4] = m.base_color_factor
    rows[:, 4] = m.metalness_factor
    rows[:, 5] = m.roughness_factor
    rows[:, 6] = m.occlusion_factor
    rows[:, 7:10] = m.emissive_factor
    rows[:, 10] = m.alpha_cutoff
    rows[:, 11] = m.ior
    rows[:, 12] = m.normal_scale
    rows[:, 13] = m.specular_factor
    rows[:, 14:17] = m.specular_color_factor
    rows[:, 17] = m.clearcoat_factor
    rows[:, 18] = m.clearcoat_roughness_factor
    rows[:, 19] = m.clearcoat_normal_scale
    rows[:, 20] = m.anisotropy_strength
    rows[:, 21] = m.anisotropy_rotation
    rows[:, 22:25] = m.sheen_color_factor
    rows[:, 25] = m.sheen_roughness_factor
    rows[:, 26] = m.transmission_factor
    rows[:, 27] = m.thickness_factor
    rows[:, 28] = m.attenuation_distance
    rows[:, 29:32] = m.attenuation_color
    rows[:, 32] = _np.asarray(m.flags, _np.int32).view(_np.float32)
    rows[:, 33] = _np.asarray(m.alpha_mode, _np.int32).view(_np.float32)
    for s in range(N_TEX_SLOTS):
        b = MATERIAL_ROW_FACTORS + MATERIAL_SLOT_STRIDE * s
        rows[:, b] = _np.asarray(m.tex_index[:, s], _np.int32).view(_np.float32)
        rows[:, b + 1] = _np.asarray(m.tex_uvset[:, s], _np.int32).view(_np.float32)
        rows[:, b + 2] = m.tex_rotation[:, s]
        rows[:, b + 3 : b + 5] = m.tex_offset[:, s]
        rows[:, b + 5 : b + 7] = m.tex_scale[:, s]
    return rows


def pack_texture_rows(t) -> "Any":
    import numpy as _np

    n = len(_np.asarray(t.x))
    rows = _np.zeros((n, 9), _np.float32)
    if n:
        rows[:, 0] = t.x
        rows[:, 1] = t.y
        rows[:, 2] = t.width
        rows[:, 3] = t.height
        rows[:, 4] = t.wrap_s
        rows[:, 5] = t.wrap_t
        rows[:, 6] = t.nearest
        rows[:, 7] = t.srgb
    return rows


# Wrap modes (glTF sampler -> resolved at load).
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

# Animation paths / interpolation.
PATH_TRANSLATION = 0
PATH_ROTATION = 1
PATH_SCALE = 2
PATH_WEIGHTS = 3
INTERP_STEP = 0
INTERP_LINEAR = 1
INTERP_CUBICSPLINE = 2


class MaterialTable(NamedTuple):
    """SoA mirror of GpuMaterial (Renderer.h:88-171). Index 0 = default material
    (Gltf.cpp:470-474): glTF material i lives at row i+1."""

    flags: Any                 # (M,) int32
    alpha_mode: Any            # (M,) int32
    base_color_factor: Any     # (M, 4) f32
    metalness_factor: Any      # (M,) f32
    roughness_factor: Any      # (M,) f32
    occlusion_factor: Any      # (M,) f32
    emissive_factor: Any       # (M, 3) f32 (pre-multiplied by emissive_strength)
    alpha_cutoff: Any          # (M,) f32 (0 unless MASK — Renderer.h:146)
    ior: Any                   # (M,) f32
    normal_scale: Any          # (M,) f32
    specular_factor: Any       # (M,) f32
    specular_color_factor: Any  # (M, 3) f32
    clearcoat_factor: Any      # (M,) f32
    clearcoat_roughness_factor: Any  # (M,) f32
    clearcoat_normal_scale: Any  # (M,) f32
    anisotropy_strength: Any   # (M,) f32
    anisotropy_rotation: Any   # (M,) f32
    sheen_color_factor: Any    # (M, 3) f32
    sheen_roughness_factor: Any  # (M,) f32
    transmission_factor: Any   # (M,) f32
    thickness_factor: Any      # (M,) f32
    attenuation_distance: Any  # (M,) f32
    attenuation_color: Any     # (M, 3) f32
    # Texture addresses (Material.hlsli TextureAddress:14-21), slot-indexed.
    dispersion: Any            # (M,) f32 — KHR_materials_dispersion value;
    # parsed + stored but not consumed by shading, matching the reference
    # (Gltf.cpp:543-547 stores it; no shader reads it)
    tex_index: Any             # (M, N_TEX_SLOTS) int32, -1 = absent
    tex_uvset: Any             # (M, N_TEX_SLOTS) int32
    tex_rotation: Any          # (M, N_TEX_SLOTS) f32
    tex_offset: Any            # (M, N_TEX_SLOTS, 2) f32
    tex_scale: Any             # (M, N_TEX_SLOTS, 2) f32
    rows: Any = None           # (M, MATERIAL_ROW_WIDTH) f32 — packed row per
    # material: ONE gather fetches everything a hit needs (see pack_material_rows)


class TextureTable(NamedTuple):
    """One shared u8 RGBA atlas + per-texture addressing metadata.

    The replacement for bindless SRVs (DescriptorAllocator.h): a texture id
    is a row here; sampling gathers 4 texels from `atlas` with per-texture wrap
    and optional sRGB decode (hardware sRGB formats in Gltf.cpp:1048-1078).
    """

    atlas: Any      # (AH, AW, 4) uint8
    x: Any          # (T,) int32 rect origin
    y: Any          # (T,) int32
    width: Any      # (T,) int32
    height: Any     # (T,) int32
    wrap_s: Any     # (T,) int32 (WRAP_*)
    wrap_t: Any     # (T,) int32
    nearest: Any    # (T,) int32 (1 = point filter)
    srgb: Any       # (T,) int32 (decode to linear after fetch, before filter)
    rows: Any = None  # (T, 9) f32 — packed per-texture metadata row
    # [x, y, w, h, wrap_s, wrap_t, nearest, srgb, pad] (ints stored as f32)
    atlas_linear: Any = None  # (AH*AW, 4) f16, PRE-DECODED to linear.
    # Decode-at-load analogue of the reference's hardware sRGB views
    # (Gltf.cpp:1048-1078): built once per scene (decode_atlas_linear), the
    # hot path gathers linear texels directly — no per-hit sRGB pow over
    # 4*k*R fetched texels.
    atlas_quad: Any = None  # (AH*AW, 16) f16 — each row holds the texel AND
    # its +x/+y/+xy neighbors under the OWNING TEXTURE's wrap mode (baked at
    # build, build_atlas_quad). Bilinear then needs ONE k*R-row gather
    # instead of a 4*k*R-row gather. None when the scene uses mirror wrap (backward
    # neighbors on flipped replicas aren't baked) or the atlas is huge.
    # --- Mip pyramid (raster backend; Forward.ps.hlsl samples with mips,
    # the PT keeps the reference's SampleLevel-0 quirk, Material.hlsli:95).
    mip_flat: Any = None  # (M, 4) f16 linear texels of EVERY texture's full
    # NPOT mip chain (level 0 included), each level stored row-major inside
    # its own slab (build_atlas_mips; filter = generate_mip_level trapezoid).
    mip_rows: Any = None  # (T * MAXL, 4) f32: [flat_base, level_w, level_h,
    # pad]; flat index = flat_base + y * level_w + x. Levels past a
    # texture's chain repeat its last (1x1) level, so sampling never needs
    # a per-texture level count. MAXL = mip_rows.shape[0] // T (static).
    mip_quad: Any = None  # (M, 16) f16 — mip_flat with each texel's 2x2
    # bilinear neighborhood baked per LEVEL rect (same scheme/caveats as
    # atlas_quad; GLTF_QUADMIPS=1). Trilinear then gathers 2 rows per
    # (slot, ray) instead of 8 — the raster draw_scene's dominant gather.


class GeometryPools(NamedTuple):
    """Concatenated per-vertex pools (mirrors the sub-allocated mesh buffer,
    Mesh.cpp:113-167) + triangle topology, in object space."""

    positions: Any      # (V, 3) f32
    normals: Any        # (V, 3) f32 — post 10:10:10:2 quantization (parity)
    tangents: Any       # (V, 4) f32 — decoded (includes reference half-turn quirk)
    uv0: Any            # (V, 2) f32
    uv1: Any            # (V, 2) f32
    color: Any          # (V, 4) f32 (u16-normalized at load, Mesh.h formats)
    joints: Any         # (V, 4) int32
    weights: Any        # (V, 4) f32 (u16-quantized to match Skin.cs unpack)
    # Triangles, pool-global vertex ids.
    tri_vertex: Any     # (T, 3) int32
    tri_prim: Any       # (T,) int32 — primitive id per triangle
    # Morph target deltas, concatenated (see Primitive.morph_offset).
    morph_pos: Any      # (VM, 3) f32
    morph_normal: Any   # (VM, 3) f32
    morph_tangent: Any  # (VM, 3) f32


class PrimitiveTable(NamedTuple):
    """Per-primitive metadata (Gltf.h Primitive + Mesh flags)."""

    vertex_offset: Any  # (P,) int32
    vertex_count: Any   # (P,) int32
    tri_offset: Any     # (P,) int32
    tri_count: Any      # (P,) int32
    material: Any       # (P,) int32
    has_tangent_space: Any  # (P,) int32
    has_uv0: Any        # (P,) int32
    has_uv1: Any        # (P,) int32
    has_color: Any      # (P,) int32
    has_joints: Any     # (P,) int32
    morph_offset: Any   # (P,) int32 — start into morph pools (per target block)
    morph_count: Any    # (P,) int32 — number of morph targets


class LightParams(NamedTuple):
    """Static punctual light params (Gltf.cpp:856-882); world position and
    direction are gathered per frame from node transforms (Renderer.cpp:459-492)."""

    type: Any        # (L,) int32
    color: Any       # (L, 3) f32
    intensity: Any   # (L,) f32
    cutoff: Any      # (L,) f32 (range; 0 = unbounded)
    inner_angle: Any  # (L,) f32
    outer_angle: Any  # (L,) f32


class GpuLights(NamedTuple):
    """Per-frame gathered light table (GpuLight, Renderer.h:53-68)."""

    type: Any        # (L,) int32
    position: Any    # (L, 3) f32
    direction: Any   # (L, 3) f32
    color: Any       # (L, 3) f32
    intensity: Any   # (L,) f32
    cutoff: Any      # (L,) f32
    inner_angle: Any  # (L,) f32
    outer_angle: Any  # (L,) f32


class InstancePlan(NamedTuple):
    """Static flattening plan: scene traversal unrolled to gather maps.

    Replaces the per-frame TLAS instance list (Pathtracer.cpp:185-257): world
    geometry = gather(object pools, vertex_map) transformed by
    node_transforms[vertex_node]. Built once per (scene, visibility) at load.
    """

    vertex_map: Any     # (VW,) int32 — object-pool vertex per world vertex
    vertex_node: Any    # (VW,) int32 — node id (for transform gather)
    vertex_skinned: Any  # (VW,) int32 — 1 if from a skinned/morphed (dynamic) mesh
    tri_vertex: Any     # (TW, 3) int32 — into world pools
    tri_material: Any   # (TW,) int32
    tri_prim: Any       # (TW,) int32 — source primitive id
    tri_double_sided: Any  # (TW,) int32
    tri_alpha_mode: Any    # (TW,) int32
    instance_node: Any  # (I,) int32
    instance_prim: Any  # (I,) int32


@dataclasses.dataclass
class Node:
    """Host scene-graph node (Gltf.h Node)."""

    name: str = ""
    parent: int = -1
    children: List[int] = dataclasses.field(default_factory=list)
    translation: np.ndarray = None  # (3,)
    rotation: np.ndarray = None     # (4,) xyzw
    scale: np.ndarray = None        # (3,)
    mesh: int = -1       # mesh id (group of primitives)
    skin: int = -1
    camera: int = -1
    light: int = -1
    weights: Optional[np.ndarray] = None  # morph weights override


@dataclasses.dataclass
class Skin:
    joints: np.ndarray            # (J,) node ids
    inverse_bind: np.ndarray      # (J, 4, 4)
    skeleton: int = -1


@dataclasses.dataclass
class AnimationChannel:
    node: int
    path: int            # PATH_*
    interpolation: int   # INTERP_*
    times: np.ndarray    # (K,)
    values: np.ndarray   # (K, D) or (3K, D) for cubic spline


@dataclasses.dataclass
class Animation:
    name: str
    channels: List[AnimationChannel]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)), default=0.0)


@dataclasses.dataclass
class IridescenceParams:
    """KHR_materials_iridescence — parsed like the reference (Gltf.cpp:571-584)
    but not consumed by either backend (Material.hlsli has no iridescence)."""

    factor: float = 0.0
    ior: float = 1.3
    thickness_minimum: float = 100.0
    thickness_maximum: float = 400.0


@dataclasses.dataclass
class CameraDef:
    type: str = "perspective"   # or "orthographic"
    yfov: float = 1.0
    aspect: float = 0.0         # 0 = use viewport
    znear: float = 0.1
    zfar: float = 0.0           # 0 = infinite (Camera.h:87-91 uses far=1e5)
    xmag: float = 1.0
    ymag: float = 1.0


@dataclasses.dataclass
class MeshDef:
    """glTF mesh = list of primitive ids + default morph weights."""

    primitives: List[int]
    weights: Optional[np.ndarray] = None


@dataclasses.dataclass
class Scene:
    """Host-side loaded scene. Arrays are numpy; `device_arrays()` returns the
    jit-visible pytree subset."""

    pools: GeometryPools
    primitives: PrimitiveTable
    materials: MaterialTable
    textures: TextureTable
    light_params: LightParams
    light_nodes: np.ndarray          # (L,) node id per light instance
    nodes: List[Node] = dataclasses.field(default_factory=list)
    scenes: List[List[int]] = dataclasses.field(default_factory=list)
    default_scene: int = 0
    meshes: List[MeshDef] = dataclasses.field(default_factory=list)
    skins: List[Skin] = dataclasses.field(default_factory=list)
    animations: List[Animation] = dataclasses.field(default_factory=list)
    cameras: List[CameraDef] = dataclasses.field(default_factory=list)
    iridescence: List[IridescenceParams] = dataclasses.field(default_factory=list)
    topo_order: np.ndarray = None    # (N,) node ids, parents before children
    name: str = ""

    def num_nodes(self) -> int:
        return len(self.nodes)
