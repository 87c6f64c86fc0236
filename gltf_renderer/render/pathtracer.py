"""Wavefront path tracer — JAX port of the DXR backend.

The reference's GPU recursion (PathTracer.lib.hlsl RayGeneration/ClosestHit,
recursion depth MAX_BOUNCES+2) is restructured as an ITERATIVE wavefront: all
pixel rays advance bounce-by-bounce in lockstep inside one jitted function —
the standard recursion->loop transform for SIMD machines. RNG streams match
the reference exactly: pcg4d(pixel, seed, counter) with the counter advanced
in the same order GenerateNextRandom is called (PathTracer.lib.hlsl:144-148);
since the flag set is static, the counter schedule is compile-time constant.

Layered-BSDF importance sampling is ported from PathTracer.lib.hlsl:388-667;
NEE+MIS for the environment (:928-942), uniform punctual-light NEE (:944-956),
Russian roulette (:712-722), luminance clamp / NaN scrub (:760-774), and
progressive accumulation (:776-786) all follow the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.ops import bvh as bvh_ops
from gltf_renderer.ops import rng
from gltf_renderer.ops import sampling
from gltf_renderer.ops.bsdf import (
    MINIMUM_ROUGHNESS,
    SurfaceProperties,
    fresnel_coat,
    gltf_bsdf,
    sheen_e_table,
)
from gltf_renderer.ops.lights import sample_point_light
from gltf_renderer.ops.material import get_base_color, get_alpha, get_surface_properties
from gltf_renderer.ops.texture import sample_texture
from gltf_renderer.render import settings as S
from gltf_renderer.scene import types as T
from gltf_renderer.scene.flatten import WorldGeometry
from gltf_renderer.utils.math import (
    PI,
    create_basis,
    cross,
    dot,
    luminance,
    max_value,
    normalize,
    reflect,
    saturate,
    to_local,
    to_world,
)

MAX_ALPHA_HOPS = 8  # any-hit re-traversal bound for alpha-masked geometry
MAX_SHADOW_HOPS = 16
NO_TCAP = 1e30  # _proxy_occlusion "no certain hit": large-finite so that
# min(t_max, tcap*(1+eps)) is a no-op without an isfinite pred


class PTScene(NamedTuple):
    """Device-resident inputs for one frame of path tracing."""

    world: WorldGeometry
    bvh: bvh_ops.FlatBVH          # topology (refit); aabbs unused at trace time
    packed: bvh_ops.PackedBVH     # the traversal tables (kernel and XLA route)
    materials: T.MaterialTable
    textures: T.TextureTable
    lights: T.GpuLights
    env: Any                 # EnvMaps or None
    sheen_table: Any         # (A, C) f32
    occluder_idx: Any = None  # (K,) largest-area opaque tri ids (-1 pad) for
    # the shadow/bounce proxy prepass (GLTF_SHADOWPRE)


class PTMeta(NamedTuple):
    """Static (hashable) scene facts jit specializes on."""

    num_lights: int
    has_masked: bool
    has_env: bool
    has_blend: bool = False  # any alpha-BLEND or transmissive material in use
    traversal: str = "xla"   # "kernel" (ops/triton_trace, GPU) or "xla"
    # (bvh.intersect_*_p, the plain reference) — see traversal_route
    used_slots: tuple = ()   # texture slots referenced by ANY material (static)
    has_sheen: bool = True   # static BSDF layer toggles — the analogue of
    has_clearcoat: bool = True   # shader permutations: layers no material in
    has_transmission: bool = True  # the scene uses compile to nothing
    has_alpha_layer: bool = True   # any MASK/BLEND material (alpha < 1 possible)
    shadow_prepass: bool = False  # proxy-occluder prepass (see
    # _proxy_occlusion; GLTF_SHADOWPRE=1 enables)
    identity_uv: bool = False  # every used slot's KHR_texture_transform is
    # identity -> skip the per-ray cos/sin uv transform
    wrap_modes: tuple = (0, 1, 2)  # wrap modes present among used textures
    # (repeat/clamp/mirror) — _wrap computes only these variants
    any_nearest: bool = True  # any used texture point-sampled — False skips
    # the per-ray nearest-filter corner fold in sample_slots_fused


def traversal_route(platform: Optional[str] = None) -> str:
    """The traversal route for a platform (default: the first device's).

    "gpu" takes the per-ray kernel (ops/triton_trace), compiled; every other
    platform takes the plain XLA reference (bvh.intersect_*_p)."""
    if platform is None:
        platform = jax.devices()[0].platform
    return "kernel" if platform == "gpu" else "xla"


def _kernel_interpret() -> bool:
    """The kernel runs compiled on the GPU and never falls back; elsewhere
    (CPU tests that select the kernel route) it runs in the interpreter."""
    return jax.devices()[0].platform != "gpu"


def _octant_positions(direction, t_min, t_max, spatial_slot=None, any_flag=None):
    """Coherence ordering for incoherent (bounce/shadow) rays on the kernel
    route: positions pos[r] = sorted index of ray r.

    Population-dependent keys:
      * closest (bounce) lanes: origin locality major (the full BVH slot
        index of the hit the ray starts from — slot order is spatially
        coherent by the SAH build), direction octant minor.
      * any-hit (shadow) lanes: direction octant only, after every closest
        lane (population bit), so blocks stay population-pure.
    Dead rays (t_min > t_max) sort last so their blocks end at once. One
    lax.sort_key_val on the composite integer key."""
    octant = (
        (direction[:, 0] > 0).astype(jnp.int32) * 4
        + (direction[:, 1] > 0).astype(jnp.int32) * 2
        + (direction[:, 2] > 0).astype(jnp.int32)
    )
    dead = t_min > t_max
    key = octant
    if spatial_slot is not None:
        key = key + 16 * jnp.clip(spatial_slot, 0, None)
    if any_flag is not None:
        # Shadow lanes: octant-major, AFTER all closest lanes.
        key = jnp.where(any_flag > 0, jnp.int32(1 << 29) + octant, key)
    key = jnp.where(dead, jnp.int32(2**31 - 1), key)
    r = key.shape[0]
    iota = jnp.arange(r, dtype=jnp.int32)
    _, idx = jax.lax.sort_key_val(key, iota)     # idx: sorted pos -> orig ray
    return jnp.zeros(r, jnp.int32).at[idx].set(iota)


def _no_sort():
    """Default ON: dispatch secondary rays in wavefront (tile) order.

    The choice predates the GPU port (the sort machinery cost more than it
    saved there); it is not yet measured on the H100.
    GLTF_SORT=1 re-enables the population-dependent sorted dispatch.
    """
    return os.environ.get("GLTF_SORT", "0") != "1"


def _kernel_closest(scene, meta, origin, direction, t_min, t_max, blend_mode=0,
                    cull_sign=0, any_hit=False, sort_rays=False, sort_spatial=None,
                    mode=None):
    """Traversal on the kernel route (ops/triton_trace) -> Hit.

    any_hit=True or a per-lane `mode` (> 0: any-hit lane) report occlusion
    as tri >= 0; t is meaningful for closest-hit lanes only."""
    from gltf_renderer.ops import triton_trace

    if sort_rays and _no_sort():
        sort_rays = False
    t_max = jnp.broadcast_to(t_max, t_min.shape)
    if sort_rays:
        # Group rays by (origin locality, population, direction octant) with
        # dead rays last. One scatter reorders all ray columns at once; one
        # gather restores the 4 hit columns.
        pos = _octant_positions(direction, t_min, t_max, sort_spatial,
                                any_flag=mode)
        cols = [origin, direction, t_min[:, None], t_max[:, None]]
        if mode is not None:
            cols.append(mode.astype(jnp.float32)[:, None])
        cols = jnp.concatenate(cols, axis=1)
        sorted_cols = jnp.zeros_like(cols).at[pos].set(cols)
        hit = _kernel_closest(
            scene, meta, sorted_cols[:, 0:3], sorted_cols[:, 3:6],
            sorted_cols[:, 6], sorted_cols[:, 7],
            blend_mode=blend_mode, cull_sign=cull_sign, any_hit=any_hit,
            mode=sorted_cols[:, 8].astype(jnp.int32) if mode is not None else None,
        )
        # tri rides the float gather as a value (exact for |tri| < 2^24).
        out = jnp.stack(
            [hit.t, hit.u, hit.v, hit.tri.astype(jnp.float32)], axis=1
        )[pos]
        return bvh_ops.Hit(
            t=out[:, 0], u=out[:, 1], v=out[:, 2],
            tri=out[:, 3].astype(jnp.int32),
        )

    t, word, u, v = triton_trace.traverse(
        scene.packed, origin, direction, t_min, t_max,
        any_hit="lane" if mode is not None else any_hit, mode=mode,
        cull_sign=cull_sign, blend_mode=blend_mode,
        interpret=_kernel_interpret(),
    )
    tri = jnp.where(word >= 0, word & bvh_ops.ID_MASK, -1)
    return bvh_ops.Hit(t=t, tri=tri, u=u, v=v)


def closest_hit(scene, meta, origin, direction, t_min, t_max, blend_mode=0, cull_sign=0,
                sort_rays=False, sort_spatial=None):
    """Dispatch by meta.traversal: the per-ray GPU kernel or the XLA
    reference."""
    if meta.traversal == "kernel":
        return _kernel_closest(
            scene, meta, origin, direction, t_min, t_max,
            blend_mode=blend_mode, cull_sign=cull_sign, sort_rays=sort_rays,
            sort_spatial=sort_spatial,
        )
    return bvh_ops.intersect_closest_p(
        scene.packed, origin, direction, t_min, t_max,
        blend_mode=blend_mode, cull_sign=cull_sign,
    )


def slot_flag_words(world: WorldGeometry, materials, order: np.ndarray) -> np.ndarray:
    """Packed id/flag words in BVH slot order (ops/bvh FLAG_* bits).

    BLEND groups alpha-BLEND or (non-MASK) transmissive materials — the
    rasterizer's binning checks alpha mode FIRST (Rasterizer.cpp:106-113:
    BLEND -> alpha bin, MASK -> alpha-test bin, THEN transmission>0 ->
    transparent bin), so a MASK material with transmission stays in the
    alpha-tested pass."""
    am = np.asarray(world.tri_alpha_mode)[order]
    ds = np.asarray(world.tri_double_sided)[order]
    tm = np.asarray(world.tri_material)[order]
    transmissive = np.asarray(materials.transmission_factor)[tm] > 0.0
    words = order.astype(np.int64).copy()
    words |= np.where(am == T.ALPHA_MODE_MASK, bvh_ops.FLAG_MASKED, 0)
    blend = (am == T.ALPHA_MODE_BLEND) | (
        transmissive & (am != T.ALPHA_MODE_MASK)
    )
    words |= np.where(blend, bvh_ops.FLAG_BLEND, 0)
    words |= np.where(ds != 0, bvh_ops.FLAG_DOUBLE_SIDED, 0)
    return words.astype(np.int32)


def make_pt_scene(world: WorldGeometry, materials, textures, lights, env=None,
                  on_cpu: bool = True) -> "tuple[PTScene, PTMeta]":
    """Build BVH + slot-ordered triangle data from world geometry (host).

    Table construction is a load-time precompute over host numpy. By default
    it runs on the CPU backend, the finished PTScene is disk-cached by
    content hash (utils/scene_cache) and device_put once (same pattern as
    build_environment). Whether building on the card is faster is not yet
    measured. meta.traversal is set for the current platform
    (traversal_route) after the build or cache load.
    """
    try:
        cpu = jax.devices("cpu")[0]
        run_cpu = on_cpu and cpu != jax.devices()[0]
    except RuntimeError:
        run_cpu = False
    if run_cpu:
        # Enqueue every device->CPU transfer first, then materialize.
        def to_cpu(x):
            if isinstance(x, jax.Array):
                return jax.device_put(x, cpu)
            return x

        # Stage timings to stderr, so a setup regression can be attributed.
        import sys as _sys
        import time as _time

        def _mark(label, t0):
            dt = _time.perf_counter() - t0
            if dt > 2.0:
                print(f"[make_pt_scene] {label}: {dt:.1f}s", file=_sys.stderr)
            return _time.perf_counter()

        t = _time.perf_counter()
        inputs = jax.tree.map(to_cpu, (world, materials, textures, lights))
        inputs = jax.tree.map(np.asarray, inputs)
        # Finished tables are disk-cached by content hash (+ GLTF_* knobs
        # + builder-source digest): they are a pure function of these inputs.
        from gltf_renderer.utils import scene_cache

        env_host = jax.tree.map(np.asarray, jax.tree.map(to_cpu, env))
        t = _mark("device->host pull", t)
        key = scene_cache.compute_key((inputs, env_host))
        t = _mark("cache key hash", t)
        cached = scene_cache.load(key)
        t = _mark("cache load", t)
        if cached is not None:
            host, built_env, meta = cached
        else:
            with jax.default_device(cpu):
                scene, meta = make_pt_scene(*inputs, env=env_host, on_cpu=False)
                # Re-attach the env FROM THE BUILT SCENE, not the caller's arg:
                # the recursive build augments it (quad-packed cube pyramids).
                built_env = jax.tree.map(np.asarray, scene.env)
                host = jax.tree.map(np.asarray, scene._replace(env=None))
            scene_cache.store(key, (host, built_env, meta))
            t = _mark("build+store (cache miss)", t)
        # numpy leaves -> device_put lands on the DEFAULT device; re-wrapping
        # the CPU-backend jax arrays directly would leave the env CPU-pinned.
        scene_dev = jax.device_put(host)._replace(env=jax.device_put(built_env))
        jax.block_until_ready(jax.tree.leaves(scene_dev))
        _mark("host->device put", t)
        return scene_dev, meta._replace(traversal=traversal_route())

    wpos = np.asarray(world.position)
    tv = np.asarray(world.tri_vertex)
    p0, p1, p2 = wpos[tv[:, 0]], wpos[tv[:, 1]], wpos[tv[:, 2]]
    tree = bvh_ops.build(p0, p1, p2)
    order = np.asarray(tree.tri_order)
    sv0 = p0[order]
    se1 = p1[order] - p0[order]
    se2 = p2[order] - p0[order]
    am = np.asarray(world.tri_alpha_mode)
    tm = np.asarray(world.tri_material)
    transmissive = np.asarray(materials.transmission_factor)[tm] > 0.0
    slot_flags = slot_flag_words(world, materials, order)
    used_slots = tuple(
        int(s)
        for s in range(T.N_TEX_SLOTS)
        if bool((np.asarray(materials.tex_index)[:, s] >= 0).any())
    )
    has_sheen = bool(
        (np.asarray(materials.sheen_color_factor) > 0).any()
        or (np.asarray(materials.tex_index)[:, T.TEX_SHEEN_COLOR] >= 0).any()
    )
    has_clearcoat = bool(
        (np.asarray(materials.clearcoat_factor) > 0).any()
        or (np.asarray(materials.tex_index)[:, T.TEX_CLEARCOAT] >= 0).any()
    )
    has_transmission = bool(
        (np.asarray(materials.transmission_factor) > 0).any()
        or (np.asarray(materials.tex_index)[:, T.TEX_TRANSMISSION] >= 0).any()
    )
    has_masked = bool((am == T.ALPHA_MODE_MASK).any())
    has_blend_mode = bool((am == T.ALPHA_MODE_BLEND).any())
    # Static texture-addressing facts (specialize away per-ray work that is
    # constant for the scene — see PTMeta.identity_uv / wrap_modes):
    mrows_np = np.asarray(materials.rows)
    identity_uv = True
    wrap_set = set()
    any_nearest = False
    tex_rows_probe = None if textures.rows is None else np.asarray(textures.rows)
    for s in used_slots:
        b = T.MATERIAL_ROW_FACTORS + T.MATERIAL_SLOT_STRIDE * s
        tid = mrows_np[:, b].view(np.int32)
        on = tid >= 0
        if not on.any():
            continue
        identity_uv = identity_uv and bool(
            (mrows_np[on, b + 2] == 0.0).all()
            and (mrows_np[on, b + 3:b + 5] == 0.0).all()
            and (mrows_np[on, b + 5:b + 7] == 1.0).all()
        )
        if tex_rows_probe is not None and tex_rows_probe.shape[0]:
            trs = tex_rows_probe[np.clip(tid[on], 0, tex_rows_probe.shape[0] - 1)]
            wrap_set.update(int(v) for v in np.unique(trs[:, 4]))
            wrap_set.update(int(v) for v in np.unique(trs[:, 5]))
            any_nearest = any_nearest or bool((trs[:, 6] == 1.0).any())
    wrap_modes = tuple(sorted(wrap_set)) if wrap_set else (0,)
    meta = PTMeta(
        num_lights=int(len(np.asarray(lights.type))),
        has_masked=has_masked,
        has_env=env is not None,
        has_blend=bool((
            (am == T.ALPHA_MODE_BLEND)
            | (transmissive & (am != T.ALPHA_MODE_MASK))
        ).any()),
        used_slots=used_slots,
        has_sheen=has_sheen,
        has_clearcoat=has_clearcoat,
        has_transmission=has_transmission,
        has_alpha_layer=has_masked or has_blend_mode,
        identity_uv=identity_uv,
        wrap_modes=wrap_modes,
        any_nearest=any_nearest,
    )
    # Pre-decode the atlas to linear f16 (decode-at-load, the reference's
    # hardware sRGB views — Gltf.cpp:1048-1078): the per-hit sRGB pow over
    # every fetched texel disappears from the shading path.
    if textures.atlas_linear is None and np.asarray(textures.atlas).size:
        from gltf_renderer.ops.texture import build_atlas_quad, decode_atlas_linear

        textures = decode_atlas_linear(jax.tree.map(np.asarray, textures))
        # Quad-packed bilinear neighborhoods (1 gather index per (slot, ray)
        # instead of 4 — build_atlas_quad; bit-exact, same texels re-packed).
        # Default ON, a choice that predates the GPU port and is not yet
        # measured on the H100; GLTF_QUAD=0 disables (4x atlas bytes).
        if os.environ.get("GLTF_QUAD", "1") == "1":
            textures = build_atlas_quad(textures)
        # NPOT mip pyramid for the raster backend's trilinear sampling
        # (Forward.ps.hlsl derivative mips; the PT ignores it — SampleLevel-0
        # parity). Costs ~1.33x the PACKED rects in f16 (level 0 included) +
        # a numpy filter pass at load; GLTF_NOMIPS=1 skips it for
        # memory-constrained PT-only runs (raster then samples level 0).
        if os.environ.get("GLTF_NOMIPS", "0") != "1":
            from gltf_renderer.ops.texture import build_atlas_mips

            # GLTF_QUADMIPS (default ON) additionally bakes the 2x2
            # neighborhoods per mip texel: raster trilinear drops 8 -> 2
            # gather indices per (slot, pixel) at 4x the pyramid bytes. The
            # default predates the GPU port and is not yet measured on the
            # H100. The PT ignores mips (SampleLevel-0 parity).
            textures = build_atlas_mips(
                textures, quad=os.environ.get("GLTF_QUADMIPS", "1") == "1"
            )
    textures = jax.tree.map(jnp.asarray, textures)
    # Compact material rows to the scene's used slots, with each slot's
    # texture metadata joined in: per-hit shading needs ONE material-row
    # gather + ONE atlas gather, no metadata gather.
    from gltf_renderer.ops.material import compact_material_rows

    tex_rows_np = None if textures.rows is None else np.asarray(textures.rows)
    materials = materials._replace(
        rows=jnp.asarray(compact_material_rows(
            np.asarray(materials.rows), used_slots, tex_rows_np
        ))
    )
    packed = bvh_ops.pack(tree, sv0, se1, se2, slot_flags)
    meta = meta._replace(traversal=traversal_route())
    # Proxy occluders for the shadow/bounce prepass (GLTF_SHADOWPRE=1,
    # optionally =K): the K largest-area STRICTLY OPAQUE triangles — valid
    # certain-occluders in every shadow mode (binary occludes on any
    # geometry; alpha shadows composite opaque hits to transmission 0) and
    # valid closest-hit caps (never alpha-rejected by the retry loop).
    # Indices are static per topology; vertices re-gather per frame, so
    # refits/skinning stay correct.
    occluder_idx = None
    pre_env = os.environ.get("GLTF_SHADOWPRE", "0")
    if pre_env != "0":
        k_occ = 64 if pre_env == "1" else int(pre_env)
        areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
        eligible = (am == T.ALPHA_MODE_OPAQUE) & ~transmissive
        scored = np.where(eligible, areas, -1.0)
        cand = np.argsort(-scored)[:k_occ]
        cand = np.where(scored[cand] > 0.0, cand, -1).astype(np.int32)
        if cand.shape[0] < k_occ:
            cand = np.concatenate(
                [cand, np.full(k_occ - cand.shape[0], -1, np.int32)]
            )
        occluder_idx = jnp.asarray(cand)
        meta = meta._replace(shadow_prepass=True)
    if (env is not None and getattr(env, "ggx", None)
            and getattr(env, "ggx_quad", None) is None
            and os.environ.get("GLTF_QUADCUBE", "1") != "0"):
        # Quad-pack the IBL cube pyramids for the raster backend: baked 2x2
        # neighborhoods drop the trilinear cube fetch from 8 gather rows per
        # pixel to 2, bit-exactly, for ~4x a few-MB pyramid (chosen before
        # the GPU port; not yet measured on the H100). Host numpy, once per scene
        # (the env disk cache stays quad-free so its version key is
        # untouched).
        from gltf_renderer.env.environment import build_cube_quads

        env = env._replace(
            ggx_quad=jnp.asarray(build_cube_quads(env.ggx)),
            diffuse_quad=jnp.asarray(build_cube_quads([env.diffuse])),
            cube0_quad=jnp.asarray(build_cube_quads([env.cube[0]])),
        )
    scene = PTScene(
        world=world,
        bvh=bvh_ops._as_device(tree),
        packed=packed,
        materials=materials,
        textures=textures,
        lights=lights,
        env=env,
        sheen_table=jnp.asarray(sheen_e_table()),
        occluder_idx=occluder_idx,
    )
    return scene, meta


# ---------------------------------------------------------------------------
# Camera rays (PathTracer.lib.hlsl:131-142)
# ---------------------------------------------------------------------------

def generate_camera_rays(px, py, resolution, clip_to_world, jitter):
    """px/py (R,) int; resolution (w, h); clip_to_world (4,4) row-major."""
    w, h = resolution
    cs_x = ((px.astype(jnp.float32) + 0.5 + jitter[..., 0]) / w) * 2.0 - 1.0
    cs_y = -(((py.astype(jnp.float32) + 0.5 + jitter[..., 1]) / h) * 2.0 - 1.0)
    ones = jnp.ones_like(cs_x)
    zeros = jnp.zeros_like(cs_x)
    clip_start = jnp.stack([cs_x, cs_y, ones, ones], -1)
    clip_end = jnp.stack([cs_x, cs_y, zeros, ones], -1)
    # Geometry products run at full f32 (a GPU may otherwise take TF32).
    hi = jax.lax.Precision.HIGHEST
    start = jnp.matmul(clip_start, clip_to_world.T, precision=hi)
    end = jnp.matmul(clip_end, clip_to_world.T, precision=hi)
    origin = start[..., :3] / start[..., 3:4]
    dest = end[..., :3] / end[..., 3:4]
    direction = dest - origin
    return origin, direction


def offset_ray(position, geometric_normal):
    """Ray Tracing Gems ch.6 origin offsetting (PathTracer.lib.hlsl:259-268)."""
    origin_thresh = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0
    of_i = (int_scale * geometric_normal).astype(jnp.int32)
    pos_i = jax.lax.bitcast_convert_type(position, jnp.int32)
    p_i = jax.lax.bitcast_convert_type(
        pos_i + jnp.where(position < 0.0, -of_i, of_i), jnp.float32
    )
    return jnp.where(
        jnp.abs(position) < origin_thresh, position + float_scale * geometric_normal, p_i
    )


# ---------------------------------------------------------------------------
# Hit attribute fetch (GetVertexAttributes, PathTracer.lib.hlsl:270-302)
# ---------------------------------------------------------------------------

class HitAttributes(NamedTuple):
    position: Any
    geometric_normal: Any   # normalized, NOT yet backface-flipped
    normal: Any
    tangent: Any            # (R, 4)
    bitangent: Any
    color: Any              # (R, 4)
    uv0: Any
    uv1: Any
    material: Any           # (R,) i32
    back_face: Any          # (R,) bool
    uv_area_ratio: Any = None  # (R,) sqrt(uv0 area / world area) — only when
    # fetch_hit_attributes(with_footprint=True) (raster mip selection)


def _generate_tangent(normal):
    """PathTracer.lib.hlsl:166-174."""
    use_y = jnp.abs(normal[..., 0:1]) > jnp.abs(normal[..., 1:2])
    helper = jnp.where(
        use_y,
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), normal.shape),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), normal.shape),
    )
    return normalize(cross(helper, normal))


def _gather_tri_vertices(world: WorldGeometry, tri):
    """ONE tri-major row gather fetches all 3 vertices + material + flags.

    One (R, 64) gather replaces 1 tri-row + 1 fused (3R, 20) vertex gather
    (chosen before the GPU port; not yet measured on the H100).
    Returns ((material, fbits), v0row, v1row, v2row)."""
    tri_c = jnp.clip(tri, 0, None)
    if os.environ.get("GLTF_TRIROWS", "1") == "0":
        # A/B fallback: 1 tri-row + 1 fused 3-vertex-row gather (round-2 path).
        trow = world.tri_rows[tri_c]                 # (R, 8) i32
        idx = jnp.concatenate([trow[:, 0], trow[:, 1], trow[:, 2]])
        rr = world.vertex_rows[idx]                  # (3R, 20) f32 — one gather
        r0, r1, r2 = jnp.split(rr, 3, axis=0)
        return (trow[:, 3], trow[:, 4]), r0, r1, r2
    row = world.tri_attr_rows[tri_c]                 # (R, 64) f32 — one gather
    if row.dtype == jnp.bfloat16:
        # bf16 table (GLTF_BF16ROWS): material/flag ids ride as hi/lo
        # BYTE pairs (each 0..255, bf16-exact — a plain bf16 int is only
        # exact to 256, which would corrupt ids on >256-material scenes).
        material = (row[:, 60].astype(jnp.int32)
                    + (row[:, 62].astype(jnp.int32) << 8))
        fbits = (row[:, 61].astype(jnp.int32)
                 + (row[:, 63].astype(jnp.int32) << 8))
        row = row.astype(jnp.float32)
        return (material, fbits), row[:, 0:20], row[:, 20:40], row[:, 40:60]
    r0 = row[:, 0:20]
    r1 = row[:, 20:40]
    r2 = row[:, 40:60]
    material = jax.lax.bitcast_convert_type(row[:, 60], jnp.int32)
    fbits = jax.lax.bitcast_convert_type(row[:, 61], jnp.int32)
    return (material, fbits), r0, r1, r2


def fetch_hit_attributes(world: WorldGeometry, tri, u, v, ray_dir,
                         with_footprint: bool = False,
                         raster_flip: bool = False,
                         ray_origin=None, ray_t=None) -> HitAttributes:
    """GetVertexAttributes port on packed rows: 1 tri-row + 1 fused vertex-row
    gather (PathTracer.lib.hlsl:280-302).

    with_footprint: also compute uv_area_ratio = sqrt(uv0 area / world area)
    per triangle (texels-per-meter factor for raster mip selection; the PT
    never asks — SampleLevel-0 parity).

    raster_flip: use Forward.ps.hlsl's backface convention instead of the
    PT's. The two shaders flip DIFFERENTLY: the PT negates normal, tangent
    and tangent.w and builds the bitangent afterwards
    (PathTracer.lib.hlsl:842-846), while Forward.ps computes the bitangent
    from the PRE-flip normal and then flips ONLY the normals
    (Forward.ps.hlsl:115-120) — on a backface the raster TBN is (t, b, -n)
    where the PT's is (-t, -b, -n) (round-4 parity review)."""
    from gltf_renderer.scene.flatten import (
        TRI_HAS_COLOR, TRI_HAS_TS, TRI_HAS_UV0, TRI_HAS_UV1,
    )

    (material, fbits), r0, r1, r2 = _gather_tri_vertices(world, tri)
    w0 = (1.0 - u - v)[..., None]
    w1 = u[..., None]
    w2 = v[..., None]

    p0, p1, p2 = r0[:, 0:3], r1[:, 0:3], r2[:, 0:3]
    pos = w0 * p0 + w1 * p1 + w2 * p2
    if (ray_origin is not None and ray_t is not None
            and world.tri_attr_rows is not None
            and world.tri_attr_rows.dtype == jnp.bfloat16):
        # bf16 attribute rows (GLTF_BF16ROWS) would put ~0.4%-relative
        # error in interpolated hit POSITIONS — the one attribute whose
        # precision is image-critical (next-bounce ray origins). The hit t
        # comes from the exact-f32 leaf-record triangle test, so o + t*d
        # recovers an f32-accurate position for free.
        pos = ray_origin + ray_t[..., None] * ray_dir
    gn_raw = cross(p1 - p0, p2 - p0)
    gn = normalize(gn_raw)

    has_ts = (fbits & TRI_HAS_TS) != 0
    n_interp = normalize(w0 * r0[:, 3:6] + w1 * r1[:, 3:6] + w2 * r2[:, 3:6])
    t_interp = normalize(w0 * r0[:, 6:9] + w1 * r1[:, 6:9] + w2 * r2[:, 6:9])
    t_w = r0[:, 9]

    normal = jnp.where(has_ts[..., None], n_interp, gn)
    tangent_xyz = jnp.where(has_ts[..., None], t_interp, _generate_tangent(gn))
    tangent_w = jnp.where(has_ts, t_w, 1.0)

    back = dot(gn_raw, ray_dir, keepdims=False) > 0.0
    if raster_flip:
        # Forward.ps.hlsl:115-120: bitangent from the pre-flip normal and
        # the UNFLIPPED tangent; only the normals are reversed.
        bitangent = tangent_w[..., None] * normalize(cross(normal, tangent_xyz))
        gn = jnp.where(back[..., None], -gn, gn)
        normal = jnp.where(back[..., None], -normal, normal)
        tangent = jnp.concatenate([tangent_xyz, tangent_w[..., None]], -1)
    else:
        # Backface flip (PathTracer.lib.hlsl:842-846; tangent.w flips too).
        gn = jnp.where(back[..., None], -gn, gn)
        normal = jnp.where(back[..., None], -normal, normal)
        tangent_xyz = jnp.where(back[..., None], -tangent_xyz, tangent_xyz)
        tangent_w = jnp.where(back, -tangent_w, tangent_w)
        tangent = jnp.concatenate([tangent_xyz, tangent_w[..., None]], -1)

        bitangent = tangent[..., 3:4] * normalize(cross(normal, tangent[..., :3]))

    has_col = ((fbits & TRI_HAS_COLOR) != 0)[..., None]
    col = jnp.where(has_col, w0 * r0[:, 14:18] + w1 * r1[:, 14:18] + w2 * r2[:, 14:18], 1.0)
    has_uv0 = ((fbits & TRI_HAS_UV0) != 0)[..., None]
    uv0 = jnp.where(has_uv0, w0 * r0[:, 10:12] + w1 * r1[:, 10:12] + w2 * r2[:, 10:12], 0.0)
    has_uv1 = ((fbits & TRI_HAS_UV1) != 0)[..., None]
    uv1 = jnp.where(has_uv1, w0 * r0[:, 12:14] + w1 * r1[:, 12:14] + w2 * r2[:, 12:14], 0.0)
    uv_area_ratio = None
    if with_footprint:
        ue1 = r1[:, 10:12] - r0[:, 10:12]
        ue2 = r2[:, 10:12] - r0[:, 10:12]
        uv_cross = jnp.abs(ue1[:, 0] * ue2[:, 1] - ue1[:, 1] * ue2[:, 0])
        w_cross = jnp.linalg.norm(gn_raw, axis=-1)
        uv_area_ratio = jnp.sqrt(uv_cross / jnp.maximum(w_cross, 1e-20))
    return HitAttributes(
        position=pos,
        geometric_normal=gn,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        color=col,
        uv0=uv0,
        uv1=uv1,
        material=material,
        back_face=back,
        uv_area_ratio=uv_area_ratio,
    )


# ---------------------------------------------------------------------------
# Alpha evaluation for any-hit semantics (AnyHit, PathTracer.lib.hlsl:1010-1035)
# ---------------------------------------------------------------------------

def _hit_base_alpha(scene: PTScene, meta: PTMeta, tri, u, v):
    """base_color.a + cutoff/mode for (tri, u, v) hits — packed-row path."""
    from gltf_renderer.ops.material import get_base_color_row
    from gltf_renderer.scene.flatten import TRI_HAS_COLOR, TRI_HAS_UV0, TRI_HAS_UV1

    world = scene.world
    (mat, fbits), r0, r1, r2 = _gather_tri_vertices(world, tri)
    w0 = (1.0 - u - v)[..., None]
    w1 = u[..., None]
    w2 = v[..., None]
    has_col = ((fbits & TRI_HAS_COLOR) != 0)[..., None]
    col = jnp.where(has_col, w0 * r0[:, 14:18] + w1 * r1[:, 14:18] + w2 * r2[:, 14:18], 1.0)
    has_uv0 = ((fbits & TRI_HAS_UV0) != 0)[..., None]
    uv0 = jnp.where(has_uv0, w0 * r0[:, 10:12] + w1 * r1[:, 10:12] + w2 * r2[:, 10:12], 0.0)
    has_uv1 = ((fbits & TRI_HAS_UV1) != 0)[..., None]
    uv1 = jnp.where(has_uv1, w0 * r0[:, 12:14] + w1 * r1[:, 12:14] + w2 * r2[:, 12:14], 0.0)
    mrow = scene.materials.rows[mat]
    base = get_base_color_row(
        mrow, scene.textures, uv0, uv1, col,
        used_slots=meta.used_slots, compact=True,
        identity_uv=meta.identity_uv, wrap_modes=meta.wrap_modes,
        any_nearest=meta.any_nearest,
    )
    return base[..., 3], mrow


def _proxy_occlusion(scene, origin, direction, t_min, t_max, want_tcap=False):
    """Brute-force ray tests against the K proxy occluder triangles as ONE
    matmul — the shadow/bounce prepass (GLTF_SHADOWPRE).

    Moller-Trumbore's det, u*det, v*det, t*det are all bilinear in (o, d):
      det    = -d.n                    (n = e1 x e2)
      u*det  =  d.([e2]x o) - d.(e2 x v0)
      v*det  = -d.([e1]x o) - d.(v0 x e1)
      t*det  =  o.n - v0.n
    so a (R, 16) ray-feature matrix F = [o, d, d_i*o_k (9), 1] times a
    per-scene (16, 4K) coefficient matrix yields every quantity for every
    (ray, tri) pair in one f32-HIGHEST matmul (~2 GFLOP at K=64/262k
    rays). Hit classification uses
    a RELATIVE margin so rounding can only produce false MISSES: a lane is
    declared occluded (or capped) only when the hit is numerically certain,
    and unmarked lanes traverse normally — the prepass is conservative and
    cannot change the image.

    Returns (occluded (R,) f32 exactly-0/1 mask, t_cap (R,) f32) — t_cap is
    NO_TCAP (1e30, large-finite so a downstream `minimum` is a no-op) where
    no certain proxy hit exists (only computed when want_tcap). Both outputs
    are float on purpose: every consumer blends arithmetically
    (bit-identical for the finite inputs here), which avoided a slow
    packed-pred layout before the GPU port.
    """
    idx = scene.occluder_idx
    tv = scene.world.tri_vertex[jnp.clip(idx, 0, None)]
    v0 = scene.world.position[tv[:, 0]]
    p1 = scene.world.position[tv[:, 1]]
    p2 = scene.world.position[tv[:, 2]]
    pad = (idx < 0)[:, None]
    e1 = jnp.where(pad, 0.0, p1 - v0)   # degenerate pad rows: det == 0, no hit
    e2 = jnp.where(pad, 0.0, p2 - v0)
    n = cross(e1, e2)
    k = idx.shape[0]

    def skew(a):  # (K,3) -> (K,3,3) with skew(a) @ x == a x x
        z = jnp.zeros_like(a[:, 0])
        return jnp.stack([
            jnp.stack([z, -a[:, 2], a[:, 1]], -1),
            jnp.stack([a[:, 2], z, -a[:, 0]], -1),
            jnp.stack([-a[:, 1], a[:, 0], z], -1),
        ], -2)

    c = jnp.zeros((16, k, 4), jnp.float32)
    c = c.at[3:6, :, 0].set(-n.T)                                  # det
    c = c.at[3:6, :, 1].set(-cross(e2, v0).T)                      # u*det: d term
    c = c.at[6:15, :, 1].set(skew(e2).transpose(1, 2, 0).reshape(9, k))
    c = c.at[3:6, :, 2].set(-cross(v0, e1).T)                      # v*det: d term
    c = c.at[6:15, :, 2].set(-skew(e1).transpose(1, 2, 0).reshape(9, k))
    c = c.at[0:3, :, 3].set(n.T)                                   # t*det
    c = c.at[15, :, 3].set(-jnp.sum(v0 * n, -1))

    o, d = origin, direction
    feats = jnp.concatenate(
        [o, d, (d[:, :, None] * o[:, None, :]).reshape(-1, 9),
         jnp.ones((o.shape[0], 1), jnp.float32)], -1,
    )
    cm = c.reshape(16, k * 4)
    g = jax.lax.dot_general(
        feats, cm, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, k, 4)
    # Rigorous rounding bound: |error(F.C)| <= n*eps * (|F|.|C|) per output.
    # A margin relative to |det| alone does NOT bound the error of a dot
    # whose feature magnitudes scale with |o| (scenes far from the origin
    # graze-classified wrong, measured 885/8192 false hits at offset 2000) —
    # the absolute-value matmul makes the verdicts conservative everywhere.
    gabs = jax.lax.dot_general(
        jnp.abs(feats), jnp.abs(cm), (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, k, 4)
    err = (64.0 * np.finfo(np.float32).eps) * gabs + 1e-30
    det, ud, vd, td = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    m_det, m_u, m_v, m_t = err[..., 0], err[..., 1], err[..., 2], err[..., 3]
    s = jnp.sign(det)
    ad = jnp.abs(det)
    us, vs, ts = ud * s, vd * s, td * s
    tmin_c = t_min[:, None]
    tmax_c = t_max[:, None]
    hit = (
        (ad > m_det)
        & (us >= m_u) & (vs >= m_v)
        & (us + vs <= ad - (m_u + m_v + m_det))
        & (ts >= tmin_c * ad + (m_t + jnp.abs(tmin_c) * m_det))
        & (ts <= tmax_c * ad - (m_t + jnp.abs(tmax_c) * m_det))
    )
    occluded = jnp.max(hit.astype(jnp.float32), -1)  # 0/1 float, full-rate write
    if not want_tcap:
        return occluded, None
    # Upper bound on the hit distance: numerator rounded up, |det| down.
    t_hi = (ts + m_t) / jnp.maximum(ad - m_det, 1e-30)
    t_hit = jnp.where(hit, t_hi, NO_TCAP)  # intra-fusion select: free
    return occluded, jnp.min(t_hit, -1)


def trace_bounce_and_shadow(
    scene: PTScene, meta: PTMeta,
    o_b, d_b, tmin_b, tmax_b,       # next-bounce closest rays
    o_s, d_s, tmin_s, tmax_s,       # binary shadow rays (same hit points)
    cull_sign=0, sort_spatial=None, trace_bounce=True,
):
    """On the kernel route, ONE merged dispatch for the next-bounce closest
    rays and the binary env-NEE shadow rays born at the same hit points: one
    kernel launch with a per-lane mode (both halves share origin locality).
    On the XLA route the two halves go out as separate wavefronts.

    Shadow half = ACCEPT_FIRST_HIT binary semantics (ShadowAnyHit,
    PathTracer.lib.hlsl:1053-1079); bounce half = closest hit with the
    masked-alpha retraversal loop. Returns (bounce Hit, shadow transmission).

    With the proxy prepass (GLTF_SHADOWPRE): shadow lanes certainly
    occluded by a big opaque triangle are killed BEFORE the dispatch (they
    end at once), and bounce lanes
    get t_max capped at a certain proxy hit — seeding t_best so traversal
    prunes everything beyond the floor/wall the ray will land on. Both are
    conservative: the image is bit-identical (tests pin it).
    """
    occ_s = None  # 0/1 float mask (see _proxy_occlusion: pred-layout rule)
    if meta.shadow_prepass and scene.occluder_idx is not None:
        r_s = o_s.shape[0]
        tmax_s = jnp.broadcast_to(tmax_s, (r_s,))
        occ_s, _ = _proxy_occlusion(
            scene, o_s, d_s, jnp.broadcast_to(tmin_s, (r_s,)), tmax_s
        )
        # Blend, don't select: occluded lanes get tmin = tmax+1 exactly
        # (occ_s is exactly 0 or 1), live lanes keep tmin bit-exactly.
        tmin_s = (tmax_s + 1.0) * occ_s + jnp.broadcast_to(tmin_s, (r_s,)) * (1.0 - occ_s)
        if trace_bounce and cull_sign == 0:
            r_b = o_b.shape[0]
            tmax_bb = jnp.broadcast_to(tmax_b, (r_b,))
            _occ_b, tcap = _proxy_occlusion(
                scene, o_b, d_b, jnp.broadcast_to(tmin_b, (r_b,)), tmax_bb,
                want_tcap=True,
            )
            # Cap just past the certain hit so traversal still finds it.
            # No-hit lanes carry NO_TCAP, so the minimum is a no-op there
            # (no isfinite pred needed).
            tmax_b = jnp.minimum(tmax_bb, tcap * (1.0 + 2e-4) + 1e-5)

    def overlay(trans):
        return trans if occ_s is None else trans * (1.0 - occ_s)

    def shadow_only():
        # Env shadow rays: direction-octant ordering only (no origin major,
        # see _octant_positions). Prepass already ran above (lanes killed
        # via tmin_s), so trace_shadow skips its own.
        return overlay(trace_shadow(
            scene, meta, o_s, d_s, tmax_s, alpha_shadow=False,
            active=tmin_s <= tmax_s, sort_spatial=None, prepass=False,
        ))

    if not trace_bounce:
        r = o_b.shape[0]
        hit = bvh_ops.Hit(
            t=jnp.broadcast_to(tmax_b, (r,)), tri=jnp.full(r, -1, jnp.int32),
            u=jnp.zeros(r), v=jnp.zeros(r),
        )
        return hit, shadow_only()
    if meta.traversal != "kernel":
        hit = trace_closest(
            scene, meta, o_b, d_b, tmin_b, tmax_b, cull_sign=cull_sign,
            sort_rays=True, sort_spatial=sort_spatial,
        )
        return hit, shadow_only()

    r = o_b.shape[0]
    s_n = o_s.shape[0]  # r (env NEE) or 2r (env + merged punctual shadows)
    origin = jnp.concatenate([o_b, o_s])
    direction = jnp.concatenate([d_b, d_s])
    t_min = jnp.concatenate([jnp.broadcast_to(tmin_b, (r,)),
                             jnp.broadcast_to(tmin_s, (s_n,))])
    t_max = jnp.concatenate([jnp.broadcast_to(tmax_b, (r,)),
                             jnp.broadcast_to(tmax_s, (s_n,))])
    lane_mode = jnp.concatenate(
        [jnp.zeros(r, jnp.int32), jnp.ones(s_n, jnp.int32)]
    )
    spatial2 = (
        jnp.concatenate([sort_spatial] * (1 + s_n // r))
        if sort_spatial is not None else None
    )
    hit2 = _kernel_closest(
        scene, meta, origin, direction, t_min, t_max,
        cull_sign=cull_sign, sort_rays=True, sort_spatial=spatial2,
        mode=lane_mode,
    )
    hit = bvh_ops.Hit(t=hit2.t[:r], tri=hit2.tri[:r], u=hit2.u[:r], v=hit2.v[:r])
    trans = overlay((hit2.tri[r:] < 0).astype(jnp.float32))
    if meta.has_masked:
        hit = _alpha_retry(scene, meta, hit, o_b, d_b, tmin_b, tmax_b,
                           cull_sign, True, sort_spatial)
    return hit, trans


def trace_closest(scene: PTScene, meta: PTMeta, origin, direction, t_min, t_max, cull_sign=0,
                  sort_rays=False, sort_spatial=None):
    """Closest hit honoring alpha-mask any-hit rejection.

    Masked triangles whose sampled base alpha < cutoff are IgnoreHit()-ed
    (PathTracer.lib.hlsl:1030-1034): re-traverse from just past the rejected
    hit, bounded by MAX_ALPHA_HOPS.
    """
    hit = closest_hit(scene, meta, origin, direction, t_min, t_max, cull_sign=cull_sign,
                      sort_rays=sort_rays, sort_spatial=sort_spatial)
    if not meta.has_masked:
        return hit
    return _alpha_retry(scene, meta, hit, origin, direction, t_min, t_max,
                        cull_sign, sort_rays, sort_spatial)


def _alpha_retry(scene: PTScene, meta: PTMeta, hit, origin, direction, t_min, t_max,
                 cull_sign, sort_rays, sort_spatial):
    """The masked-alpha IgnoreHit retraversal loop (shared by trace_closest
    and the merged bounce+shadow dispatch)."""

    # Loop-carried lane masks ride as int32, not bool: a while-carried
    # pred[R] took a slow packed layout before the GPU port. Not yet
    # measured on the H100.

    def cond(state):
        nr_i, _hit, _tmin, it = state
        return jnp.any(nr_i > 0) & (it < MAX_ALPHA_HOPS)

    def body(state):
        nr_i, cur, tmin_cur, it = state
        need_retry = nr_i > 0
        tmin_next = jnp.where(need_retry, cur.t * (1.0 + 1e-5) + 1e-6, tmin_cur)
        # Disable finished rays by collapsing their interval.
        eff_tmin = jnp.where(need_retry, tmin_next, t_max + 1.0)
        nh = closest_hit(scene, meta, origin, direction, eff_tmin, t_max, cull_sign=cull_sign,
                         sort_rays=sort_rays, sort_spatial=sort_spatial)
        merged = bvh_ops.Hit(
            t=jnp.where(need_retry, nh.t, cur.t),
            tri=jnp.where(need_retry, nh.tri, cur.tri),
            u=jnp.where(need_retry, nh.u, cur.u),
            v=jnp.where(need_retry, nh.v, cur.v),
        )
        retry = _needs_alpha_retry(scene, meta, merged) & need_retry
        return retry.astype(jnp.int32), merged, tmin_next, it + 1

    retry0 = _needs_alpha_retry(scene, meta, hit).astype(jnp.int32)
    _, hit, _, _ = jax.lax.while_loop(
        cond, body, (retry0, hit, jnp.broadcast_to(t_min, hit.t.shape), 0)
    )
    return hit


def _needs_alpha_retry(scene: PTScene, meta: PTMeta, hit: bvh_ops.Hit):
    valid = hit.tri >= 0
    alpha, mrow = _hit_base_alpha(scene, meta, hit.tri, hit.u, hit.v)
    # Alpha mode from the material row ALREADY gathered by _hit_base_alpha
    # (a triangle's alpha mode IS its material's, plan_tri_flags) — the old
    # tri_rows re-gather was one more per-iteration 262k gather for data
    # this row carries at word 33 (get_alpha_row reads the same bits).
    from gltf_renderer.ops.material import _bits

    is_mask = _bits(mrow[:, 33]) == T.ALPHA_MODE_MASK
    cutoff = mrow[:, 10]
    return valid & is_mask & (alpha < cutoff)


def trace_shadow(scene: PTScene, meta: PTMeta, origin, direction, t_max, alpha_shadow: bool,
                 active=None, sort_spatial=None, prepass=True):
    """TraceShadowRay port (PathTracer.lib.hlsl:724-742). Returns transmission.

    Binary mode: ACCEPT_FIRST_HIT + initial transmission 0 — ANY geometry
    occludes (including alpha=0 texels; see ShadowAnyHit:1053-1079 semantics).
    Alpha mode: transmission = prod(1 - alpha) over surfaces until opaque.
    An opaque proxy-prepass hit (GLTF_SHADOWPRE) forces transmission 0 in
    BOTH modes and retires the lane before traversal.

    Prepass parity caveat: binary mode is EXACTLY image-identical. Alpha
    mode is identical except when >MAX_SHADOW_HOPS(16) alpha surfaces stack
    in front of the certain opaque occluder — the truncated loop would
    return the partial product (>0) while the prepass returns the
    physically correct 0 (an opaque wall does block). Deviation is
    one-sided (darker == more correct) and needs 17+ stacked MASK/BLEND
    layers on one shadow ray to trigger.
    """
    n = origin.shape[0]
    fzero = origin[:, 0] * 0.0  # varying-axes-correct zero under shard_map
    t_min = fzero
    if active is None:
        act_f = fzero + 1.0
    else:
        # 0/1 float lane mask (pred-layout rule: a bool (R,) crossing a
        # fusion boundary materializes at the packed pred layout).
        act_f = active.astype(jnp.float32)
    if alpha_shadow and not meta.has_alpha_layer:
        # Every material is OPAQUE -> GetAlpha == 1 -> the alpha loop's
        # first hit always lands transmission 0: EXACTLY the binary
        # any-hit semantics, minus the closest-hit loop dispatches.
        alpha_shadow = False
    occ_pre = None  # 0/1 float mask
    if prepass and meta.shadow_prepass and scene.occluder_idx is not None:
        t_max_b = jnp.broadcast_to(t_max, (n,))
        occ_pre, _ = _proxy_occlusion(
            scene, origin, direction,
            t_min * act_f + (t_max_b + 1.0) * (1.0 - act_f), t_max_b,
        )
        act_f = act_f * (1.0 - occ_pre)

    def overlay(trans):
        return trans if occ_pre is None else trans * (1.0 - occ_pre)

    if not alpha_shadow:
        eff_tmin = t_min * act_f + (t_max + 1.0) * (1.0 - act_f)
        if meta.traversal == "kernel":
            # ACCEPT_FIRST_HIT: any_hit retires a lane on its first hit
            # (PathTracer.lib.hlsl:1053-1079 ShadowAnyHit semantics).
            hit = _kernel_closest(
                scene, meta, origin, direction, eff_tmin, t_max, any_hit=True,
                sort_rays=True, sort_spatial=sort_spatial,
            )
            trans = (hit.tri < 0).astype(jnp.float32)  # one fusion: i32 in, f32 out
        else:
            occluded = bvh_ops.intersect_any_p(scene.packed, origin, direction, eff_tmin, t_max)
            trans = jnp.where(occluded, 0.0, 1.0)
        return overlay(trans)

    # int32 lane-mask carry for the same pred-layout reason as _alpha_retry.
    def cond(state):
        alive_i, _trans, _tmin, it = state
        return jnp.any(alive_i > 0) & (it < MAX_SHADOW_HOPS)

    def body(state):
        alive_i, trans, tmin_cur, it = state
        alive = alive_i > 0
        eff_tmin = jnp.where(alive, tmin_cur, t_max + 1.0)
        hit = closest_hit(scene, meta, origin, direction, eff_tmin, t_max, sort_rays=True,
                          sort_spatial=sort_spatial)
        hit_valid = (hit.tri >= 0) & alive
        alpha, mrow = _hit_base_alpha(scene, meta, hit.tri, hit.u, hit.v)
        from gltf_renderer.ops.material import get_alpha_row

        a = get_alpha_row(mrow, jnp.stack([alpha, alpha, alpha, alpha], -1))
        trans = jnp.where(hit_valid, trans * (1.0 - a), trans)
        alive = hit_valid & (trans > 0.0)
        tmin_cur = jnp.where(alive, hit.t * (1.0 + 1e-5) + 1e-6, tmin_cur)
        return alive.astype(jnp.int32), trans, tmin_cur, it + 1

    alive0 = act_f.astype(jnp.int32)
    trans0 = fzero + 1.0
    _, trans, _, _ = jax.lax.while_loop(cond, body, (alive0, trans0, t_min, 0))
    return overlay(trans)


# ---------------------------------------------------------------------------
# Layered BSDF sampling (PathTracer.lib.hlsl:388-667)
# ---------------------------------------------------------------------------

def _sample_clearcoat(sp: SurfaceProperties, v, u2):
    n = sp.clearcoat_normal
    t, b = create_basis(n)
    h_local = sampling.sample_ggx_normal(sp.clearcoat_roughness[..., 0], u2)
    h = to_world(t, b, n, h_local)
    return reflect(-v, h)


def _clearcoat_pdf(sp, v, l):
    a = sp.clearcoat_roughness[..., 0]
    n = sp.clearcoat_normal
    h = normalize(v + l)
    pdf = sampling.ggx_normal_pdf(a, n, h)
    return pdf / (4.0 * dot(v, h, keepdims=False))


def _sample_specular(sp, v, u2):
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h_local = sampling.sample_ggx_anisotropic_normal(sp.roughness_squared, u2)
    h = to_world(t, b, n, h_local)
    return reflect(-v, h)


def _specular_pdf(sp, v, l):
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h = normalize(v + l)
    h_local = to_local(t, b, n, h)
    pdf = sampling.ggx_anisotropic_normal_pdf(sp.roughness_squared, h_local)
    return pdf / (4.0 * dot(v, h, keepdims=False))


def _modulated_a(sp):
    a = sp.roughness_squared[..., 1]
    return jnp.clip(a * saturate(2.0 * (sp.ior[..., 0] - 1.0)), MINIMUM_ROUGHNESS, 1.0)


def _sample_transmission(sp, v, u2):
    t, b, n = sp.anisotropy_tangent, sp.anisotropy_bitangent, sp.shading_normal
    h_local = sampling.sample_ggx_normal(_modulated_a(sp), u2)
    h = to_world(t, b, n, h_local)
    l = reflect(-v, h)
    return l - 2.0 * dot(n, l) * n


def _transmission_pdf(sp, v, l):
    a = _modulated_a(sp)
    n = sp.shading_normal
    l = l - 2.0 * dot(n, l) * n
    h = normalize(v + l)
    pdf = sampling.ggx_normal_pdf(a, n, h)
    return pdf / (4.0 * dot(v, h, keepdims=False))


def layer_probabilities(sp: SurfaceProperties, v, meta: "PTMeta" = None):
    """PathTracer.lib.hlsl LayerProbabilities:535-553.

    Layers statically absent from the scene (meta flags) get probability 0
    with no math — identical results, fewer ops."""
    zero = jnp.zeros(sp.alpha.shape[:-1], sp.alpha.dtype)
    if meta is None or meta.has_alpha_layer:
        alpha_prob = 1.0 - sp.alpha[..., 0]
    else:
        alpha_prob = zero
    remaining = 1.0 - alpha_prob
    if meta is None or meta.has_clearcoat:
        fc = fresnel_coat(
            1.5,
            sp.clearcoat,
            jnp.zeros_like(sp.albedo),
            jnp.ones_like(sp.albedo),
            dot(sp.clearcoat_normal, v),
        )[..., 0]
        clearcoat_prob = fc * remaining
        remaining = remaining - clearcoat_prob
    else:
        clearcoat_prob = zero
    if meta is None or meta.has_sheen:
        sheen_prob = jnp.where(jnp.any(sp.sheen_color > 0.0, -1), 0.5, 0.0) * remaining
        remaining = remaining - sheen_prob
    else:
        sheen_prob = zero
    specular_prob = 0.5 * remaining
    remaining = remaining - specular_prob
    if meta is None or meta.has_transmission:
        transmission_prob = sp.transmissive[..., 0] * remaining
        remaining = remaining - transmission_prob
    else:
        transmission_prob = zero
    diffuse_prob = remaining
    return alpha_prob, clearcoat_prob, sheen_prob, specular_prob, diffuse_prob, transmission_prob


def bsdf_pdf(sp, v, l, is_transmission, probs, meta: "PTMeta" = None):
    """PathTracer.lib.hlsl BsdfPdf:555-565 (mixture; alpha handled separately)."""
    _, cc_p, sh_p, sp_p, di_p, tr_p = probs
    cos_pdf = sampling.cosine_hemisphere_pdf(sp.shading_normal, l)
    refl_pdf = sp_p * _specular_pdf(sp, v, l) + di_p * cos_pdf
    if meta is None or meta.has_clearcoat:
        refl_pdf = refl_pdf + cc_p * _clearcoat_pdf(sp, v, l)
    if meta is None or meta.has_sheen:
        refl_pdf = refl_pdf + sh_p * cos_pdf
    if meta is None or meta.has_transmission:
        return jnp.where(is_transmission, tr_p * _transmission_pdf(sp, v, l), refl_pdf)
    return refl_pdf


def evaluate_bsdf(sp, geometric_normal, v, l, settings: S.PathTracerSettings, sheen_table,
                  meta: "PTMeta" = None):
    """EvaluateBsdf (PathTracer.lib.hlsl:567-593). Returns (bsdf, pdf)."""
    if settings.material_diffuse_white:
        n_dot_l = saturate(dot(sp.shading_normal, l, keepdims=False))
        pdf = n_dot_l / PI
        return jnp.broadcast_to((n_dot_l / PI)[..., None], sp.albedo.shape), pdf

    kw = dict(
        sheen_table=sheen_table,
        enable_sheen=meta.has_sheen if meta else True,
        enable_clearcoat=meta.has_clearcoat if meta else True,
        enable_transmission=meta.has_transmission if meta else True,
    )
    if settings.material_mis:
        is_t = (
            dot(geometric_normal, l, keepdims=False)
            * dot(geometric_normal, v, keepdims=False)
        ) < 0.0
        probs = layer_probabilities(sp, v, meta)
        pdf = bsdf_pdf(sp, v, l, is_t, probs, meta)
        f = sp.alpha * gltf_bsdf(sp, v, l, is_transmission=is_t, **kw)
        return f, pdf

    n_dot_l = saturate(dot(sp.shading_normal, l, keepdims=False))
    pdf = n_dot_l / PI * sp.alpha[..., 0]
    f = sp.alpha * gltf_bsdf(sp, v, l, **kw)
    return f, pdf


def sample_bsdf(sp, u3, v, settings: S.PathTracerSettings, sheen_table,
                meta: "PTMeta" = None):
    """SampleBsdf (PathTracer.lib.hlsl:595-667).

    Returns (bsdf, l, pdf, is_transmission, use_mis).
    """
    if settings.material_diffuse_white:
        n = sp.shading_normal
        l = sampling.sample_cosine_hemisphere(n, u3[..., 1:3])
        pdf = sampling.cosine_hemisphere_pdf(n, l)
        f = jnp.broadcast_to(
            (dot(n, l, keepdims=False) / PI)[..., None], sp.albedo.shape
        )
        use_mis = jnp.ones(pdf.shape, bool)
        is_t = jnp.zeros(pdf.shape, bool)
        return f, l, pdf, is_t, use_mis

    kw = dict(
        sheen_table=sheen_table,
        enable_sheen=meta.has_sheen if meta else True,
        enable_clearcoat=meta.has_clearcoat if meta else True,
        enable_transmission=meta.has_transmission if meta else True,
    )
    if settings.material_mis:
        probs = layer_probabilities(sp, v, meta)
        alpha_p, cc_p, sh_p, sp_p, di_p, tr_p = probs
        u = u3[..., 0]
        u2 = u3[..., 1:3]
        # Layer selection (SelectBsdf:511-533) — cumulative thresholds.
        c_alpha = alpha_p
        c_cc = c_alpha + cc_p
        c_sh = c_cc + sh_p
        c_sp = c_sh + sp_p
        c_tr = c_sp + tr_p
        sel_alpha = u <= c_alpha
        sel_cc = (~sel_alpha) & (u - c_alpha <= cc_p)
        sel_sh = (~sel_alpha) & (~sel_cc) & (u - c_cc <= sh_p)
        sel_sp = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (u - c_sh <= sp_p)
        sel_tr = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (~sel_sp) & (u - c_sp <= tr_p)
        sel_di = (~sel_alpha) & (~sel_cc) & (~sel_sh) & (~sel_sp) & (~sel_tr)

        l_di = sampling.sample_cosine_hemisphere(sp.shading_normal, u2)
        l_sp = _sample_specular(sp, v, u2)
        l = jnp.where(sel_sp[..., None], l_sp, l_di)  # sheen & diffuse cosine
        if meta is None or meta.has_clearcoat:
            l = jnp.where(sel_cc[..., None], _sample_clearcoat(sp, v, u2), l)
        if meta is None or meta.has_transmission:
            l = jnp.where(sel_tr[..., None], _sample_transmission(sp, v, u2), l)
        l = jnp.where(sel_alpha[..., None], -v, l)
        is_t = sel_tr | sel_alpha
        pdf = bsdf_pdf(sp, v, l, sel_tr, probs, meta)
        f = sp.alpha * gltf_bsdf(sp, v, l, is_transmission=sel_tr, **kw)
        # Alpha layer override (SampleBsdf:622-628).
        pdf = jnp.where(sel_alpha, alpha_p, pdf)
        f = jnp.where(sel_alpha[..., None], (1.0 - sp.alpha), f)
        use_mis = ~sel_alpha
        return f, l, pdf, is_t, use_mis

    # Cosine-hemisphere fallback (SampleBsdf:650-666).
    pass_through = u3[..., 0] > sp.alpha[..., 0]
    n = sp.shading_normal
    l = sampling.sample_cosine_hemisphere(n, u3[..., 1:3])
    pdf = sampling.cosine_hemisphere_pdf(n, l) * sp.alpha[..., 0]
    f = sp.alpha * gltf_bsdf(sp, v, l, **kw)
    l = jnp.where(pass_through[..., None], -v, l)
    pdf = jnp.where(pass_through, 1.0 - sp.alpha[..., 0], pdf)
    f = jnp.where(pass_through[..., None], 1.0 - sp.alpha, f)
    return f, l, pdf, pass_through, ~pass_through


# ---------------------------------------------------------------------------
# Environment hooks (filled in by env/environment.py — kept indirect so the
# tracer also runs with a constant-color environment)
# ---------------------------------------------------------------------------

def _env_radiance(scene: PTScene, meta: PTMeta, direction, params, use_env: bool):
    """Miss radiance: env cube lookup when the env map flag is on and a map is
    loaded, constant environment color otherwise (Miss:1037-1051)."""
    if use_env:
        from gltf_renderer.env.environment import env_radiance

        return params.environment_intensity * env_radiance(scene.env, direction)
    color = jnp.asarray(params.environment_color, jnp.float32)
    return params.environment_intensity * jnp.broadcast_to(color, direction.shape)


def _env_sample(scene: PTScene, meta: PTMeta, u2, params):
    from gltf_renderer.env.environment import env_sample

    d, c, pdf = env_sample(scene.env, u2)
    return d, params.environment_intensity * c, pdf


def _env_pdf(scene: PTScene, meta: PTMeta, direction):
    from gltf_renderer.env.environment import env_pdf

    return env_pdf(scene.env, direction)


def _balance_heuristic(pdf, other_pdf):
    return pdf / jnp.maximum(pdf + other_pdf, 1e-20)


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def _default_ray_chunk():
    try:
        return int(os.environ.get("GLTF_RAY_CHUNK", "0")) or 262144
    except ValueError:
        return 262144


# Rays per dispatch chunk. Bigger chunks amortize the fixed per-op cost of
# the ~110 gather/scatter/kernel ops in one chunk, bounded by the working
# set of one dispatch. Sized before the GPU port; not yet swept on the H100.
RAY_CHUNK = _default_ray_chunk()


PACKET_TILE = 32  # pixels per tile side: 32*32 = 1024 rays per tile


@functools.lru_cache(maxsize=8)
def _tile_order(w: int, h: int, tile: int = PACKET_TILE):
    """Pixel emission order that makes each block of consecutive rays a
    compact 2D tile instead of a scanline strip, so a traversal block's rays
    walk nearby nodes (coherent primary rays).

    The stream is the PADDED block order — a pure reshape/transpose of the
    edge-clamp-padded image — so mapping stream<->image needs NO gather
    (_from_tile_order). Edge tiles contain clamped
    DUPLICATE pixels; `valid` marks the real ones (duplicates trace dead and
    are cropped away).

    Returns (px, py, valid) host arrays of length ceil(h/tile)*ceil(w/tile)
    * tile^2.
    """
    hp = -(-h // tile) * tile
    wp = -(-w // tile) * tile
    ty, tx = np.meshgrid(np.arange(0, hp, tile), np.arange(0, wp, tile), indexing="ij")
    iy, ix = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    px = (tx.reshape(-1, 1) + ix.reshape(1, -1)).reshape(-1)
    py = (ty.reshape(-1, 1) + iy.reshape(1, -1)).reshape(-1)
    valid = (px < w) & (py < h)
    px = np.minimum(px, w - 1).astype(np.int32)
    py = np.minimum(py, h - 1).astype(np.int32)
    return px, py, valid


def _from_tile_order(stream, w: int, h: int, tile: int = PACKET_TILE):
    """(N', C...) tile-order stream -> (h, w, C...) image; reshape/transpose
    only (the stream layout is _tile_order's padded block order)."""
    hp = -(-h // tile) * tile
    wp = -(-w // tile) * tile
    c_shape = stream.shape[1:]
    x = stream.reshape((hp // tile, wp // tile, tile, tile) + c_shape)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape((hp, wp) + c_shape)[:h, :w]


def trace(
    scene: PTScene,
    meta: PTMeta,
    settings: S.PathTracerSettings,
    params: S.PathTracerParams,
    clip_to_world,
    resolution,          # (w, h) static
    seed,                # traced uint32
    pixel_offset=(0, 0),  # for sharded tiles: global pixel coords of (0, 0)
    full_resolution=None,  # full image size when rendering a tile
    with_stats: bool = False,  # also return traced-ray count (for Mrays/s)
):
    """One progressive sample per pixel. Returns (h, w, 3) radiance.

    Rays are processed in RAY_CHUNK-sized chunks via lax.map: one compiled
    chunk body, sequential execution — bounds peak gather/working-set size
    without growing the program.
    """
    w, h = resolution
    if full_resolution is None:
        full_resolution = resolution
    px_t, py_t, valid_t = _tile_order(w, h)
    px = jnp.asarray(px_t) + pixel_offset[0]
    py = jnp.asarray(py_t) + pixel_offset[1]
    valid = jnp.asarray(valid_t)
    n = px.shape[0]

    if n <= RAY_CHUNK:
        color, stats = _trace_rays(
            scene, meta, settings, params, clip_to_world, full_resolution, seed,
            px, py, valid,
        )
        color = _from_tile_order(color, w, h)
        if with_stats:
            return color, stats
        return color

    n_chunks = -(-n // RAY_CHUNK)
    pad = n_chunks * RAY_CHUNK - n
    px_p = jnp.concatenate([px, jnp.zeros(pad, px.dtype)]).reshape(n_chunks, RAY_CHUNK)
    py_p = jnp.concatenate([py, jnp.zeros(pad, py.dtype)]).reshape(n_chunks, RAY_CHUNK)
    va_p = jnp.concatenate([valid, jnp.zeros(pad, bool)]).reshape(n_chunks, RAY_CHUNK)

    def chunk_fn(args):
        cpx, cpy, cva = args
        return _trace_rays(
            scene, meta, settings, params, clip_to_world, full_resolution, seed,
            cpx, cpy, cva,
        )

    colors, stats = jax.lax.map(chunk_fn, (px_p, py_p, va_p))
    color = _from_tile_order(colors.reshape(-1, 3)[:n], w, h)
    if with_stats:
        return color, jnp.sum(stats, 0)
    return color


_trace_rays_jit = None

@functools.lru_cache(maxsize=8)
def _chunk_tiles(w, h, chunk_pix, spp):
    """Device-resident (px, py, valid) chunk tiles for one (resolution,
    chunk, spp) shape. They are step-invariant, so they are uploaded once
    and the dispatch loop does no host->device copy or eager slicing."""
    px_f, py_f, valid_f = _tile_order(w, h)
    n = px_f.shape[0]
    n_chunks = -(-n // chunk_pix)
    pad = n_chunks * chunk_pix - n
    px_p = np.concatenate([px_f, np.zeros(pad, px_f.dtype)]).reshape(n_chunks, chunk_pix)
    py_p = np.concatenate([py_f, np.zeros(pad, py_f.dtype)]).reshape(n_chunks, chunk_pix)
    va_p = np.concatenate([valid_f, np.zeros(pad, bool)]).reshape(n_chunks, chunk_pix)
    if spp > 1:
        px_p = np.tile(px_p, (1, spp))
        py_p = np.tile(py_p, (1, spp))
        va_p = np.tile(va_p, (1, spp))
    return (
        n,
        n_chunks,
        tuple(jnp.asarray(px_p[c]) for c in range(n_chunks)),
        tuple(jnp.asarray(py_p[c]) for c in range(n_chunks)),
        tuple(jnp.asarray(va_p[c]) for c in range(n_chunks)),
    )


def trace_chunked(
    scene: PTScene,
    meta: PTMeta,
    settings: S.PathTracerSettings,
    params: S.PathTracerParams,
    clip_to_world,
    resolution,
    seed,
    with_stats: bool = False,
    chunk: int = RAY_CHUNK,
    spp: int = 1,
):
    """Host-driven chunked trace: one jitted dispatch per RAY_CHUNK rays.

    Unlike the lax.map path inside trace(), each chunk is a separate device
    dispatch — long frames stay responsive; XLA pipelines consecutive
    dispatches.

    spp > 1 traces that many independent samples per pixel IN THE SAME
    dispatch (the pixel slice shrinks to chunk/spp so each dispatch keeps
    its ray count) and returns their mean — amortizing the ~110 fixed-cost
    ops per chunk over spp x the rays. Sample k's rays are keyed
    by seed + k*0x9E3779B9, the same schedule as the sample-axis sharding,
    so the mean is the sharded n_sample render on one chip. Equivalent of
    the reference's progressive accumulation loop (Pathtracer.cpp:344-362)
    run spp times, fused into one launch.
    """
    global _trace_rays_jit
    if _trace_rays_jit is None:
        _trace_rays_jit = jax.jit(_trace_rays, static_argnums=(1, 2, 5))
    w, h = resolution
    assert chunk % spp == 0, (chunk, spp)
    chunk_pix = chunk // spp
    n, n_chunks, px_d, py_d, va_d = _chunk_tiles(w, h, chunk_pix, spp)
    if spp > 1:
        seed_vec = jnp.repeat(
            jnp.asarray(seed, jnp.uint32)
            + jnp.arange(spp, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9),
            chunk_pix,
        )
    outs = []
    rays_total = []
    for c in range(n_chunks):
        if spp > 1:
            col, rays = _trace_rays_jit(
                scene, meta, settings, params, clip_to_world, (w, h), seed_vec,
                px_d[c], py_d[c], va_d[c],
            )
            col = col.reshape(spp, chunk_pix, 3).mean(0)
        else:
            col, rays = _trace_rays_jit(
                scene, meta, settings, params, clip_to_world, (w, h), seed,
                px_d[c], py_d[c], va_d[c],
            )
        outs.append(col)
        rays_total.append(rays)
    color = _from_tile_order(jnp.concatenate(outs, 0)[:n], w, h)
    if with_stats:
        # Each per-chunk stats vector is [ray_count, nan_count].
        return color, jnp.sum(jnp.stack(rays_total), 0)
    return color


def _trace_rays(
    scene: PTScene,
    meta: PTMeta,
    settings: S.PathTracerSettings,
    params: S.PathTracerParams,
    clip_to_world,
    full_resolution,
    seed,
    px,
    py,
    valid=None,  # (R,) bool: False lanes (tile/chunk padding) trace DEAD —
    # no work beyond lane occupancy, no stats contribution
):
    """Trace a flat batch of pixel rays -> ((R, 3) color, ray count)."""
    n_rays = px.shape[0]

    counter = 0

    def rand4():
        nonlocal counter
        r = rng.pt_random(px, py, seed, counter)
        counter += 1
        return r

    jitter = rand4()[..., 0:2] - 0.5
    origin, direction_raw = generate_camera_rays(
        px, py, (full_resolution[0], full_resolution[1]), clip_to_world, jitter
    )
    # Primary ray: t in [0, |dir|], direction normalized (RayGeneration:756).
    ray_len = jnp.sqrt(jnp.maximum(jnp.sum(direction_raw**2, -1), 1e-20))
    direction = direction_raw / ray_len[..., None]
    t_max = ray_len

    prev_tri = None  # previous bounce's hit slot: spatial sort key for
    # secondary dispatches (BVH slot order is spatially coherent)
    radiance = jnp.zeros((n_rays, 3), jnp.float32)
    prefix = jnp.ones((n_rays, 3), jnp.float32)      # prod of post-RR weights
    rr_state = jnp.ones((n_rays, 3), jnp.float32)    # reference payload.throughput
    alive = jnp.ones(n_rays, bool) if valid is None else valid.astype(bool)
    prev_pdf = jnp.zeros(n_rays, jnp.float32)
    prev_mis = jnp.zeros(n_rays, bool)

    debug_value = None

    ray_count = jnp.zeros((), jnp.float32)

    nee_env = settings.environment_map and settings.environment_mis
    nee_lights = settings.point_lights and meta.num_lights > 0
    primary_cull = 1 if settings.cull_backface else 0
    bounce_cull = -1 if settings.cull_backface else 0

    # Primary trace; on the kernel route every later bounce's closest trace
    # rides the SAME dispatch as the env-NEE shadow rays of the bounce
    # before it (they are born at the same hit points -> one launch).
    eff_tmin = jnp.where(alive, jnp.zeros(n_rays, jnp.float32), t_max + 1.0)
    hit = trace_closest(
        scene, meta, origin, direction, eff_tmin, t_max,
        cull_sign=primary_cull, sort_rays=False,
    )

    for bounce in range(settings.max_bounces + 1):
        ray_count = ray_count + jnp.sum(alive.astype(jnp.float32))

        # Miss -> environment (Miss, PathTracer.lib.hlsl:1037-1051).
        miss = alive & (hit.tri < 0)
        use_env = settings.environment_map and meta.has_env
        env_col = _env_radiance(scene, meta, normalize(direction), params, use_env)
        if use_env and settings.environment_mis:
            mis_w = jnp.where(
                prev_mis,
                _balance_heuristic(prev_pdf, _env_pdf(scene, meta, normalize(direction))),
                1.0,
            )
            env_col = env_col * mis_w[..., None]
        radiance = radiance + jnp.where(miss[..., None], prefix * env_col, 0.0)
        alive = alive & (~miss)

        # Shade hits.
        attrs = fetch_hit_attributes(scene.world, hit.tri, hit.u, hit.v, direction,
                                     ray_origin=origin, ray_t=hit.t)
        view = -direction
        sp, extras = get_surface_properties(
            scene.materials,
            scene.textures,
            attrs.material,
            attrs.uv0,
            attrs.uv1,
            attrs.color,
            attrs.normal,
            attrs.tangent,
            attrs.bitangent,
            attrs.geometric_normal,
            view,
            use_geometric_normals=settings.material_use_geometric_normals,
            shading_normal_adaptation=settings.shading_normal_adaptation,
            used_slots=meta.used_slots,
            rows_compact=True,
            identity_uv=meta.identity_uv,
            wrap_modes=meta.wrap_modes,
            any_nearest=meta.any_nearest,
        )

        if bounce == 0 and settings.debug_output != S.DEBUG_NONE:
            debug_value = _debug_channel(
                settings.debug_output, hit, attrs, sp, extras, view, alive
            )
            if debug_value is not None:
                return debug_value, ray_count

        ray_origin = offset_ray(attrs.position, attrs.geometric_normal)
        ray_origin_below = offset_ray(attrs.position, -attrs.geometric_normal)

        # Emissive (ClosestHit:924-926).
        radiance = radiance + jnp.where(alive[..., None], prefix * extras.emissive, 0.0)

        # Environment NEE + MIS (ClosestHit:928-942). The shadow ray is built
        # here but TRACED in the merged dispatch with the next bounce's
        # closest rays below; its contribution is accumulated after that.
        nee_pending = None
        if bounce < settings.max_bounces and nee_env and meta.has_env:
            u_env = rand4()  # descent uses .xy (reference); alias path all 4
            l_dir, l_col, l_pdf = _env_sample(scene, meta, u_env, params)
            f, f_pdf = evaluate_bsdf(
                sp, attrs.geometric_normal, view, l_dir, settings, scene.sheen_table,
                meta=meta,
            )
            mis = _balance_heuristic(l_pdf, f_pdf)
            contrib = (mis[..., None] * f * l_col) / jnp.maximum(l_pdf[..., None], 1e-20)
            ok = alive & jnp.any(l_col > 0.0, -1)
            # Rays whose BSDF toward the light is zero (sampled env texel below
            # the surface horizon — roughly half on convex geometry) contribute
            # nothing: kill them BEFORE the dispatch, so their lanes end at
            # once. Exact —
            # contrib is multiplied by f either way.
            s_active = ok & jnp.any(f > 0.0, -1)
            # The ok-mask must select OUTSIDE the prefix product (like every
            # other accumulation site): a lane whose BSDF sample returned an
            # inf weight (pdf underflow on a dead/garbage lane) carries an
            # inf prefix, and inf * where(False, contrib, 0) = inf * 0 = NaN
            # — which then rides s_contrib * shadow into the radiance of a
            # MISS pixel (a one-pixel NaN once pinned to a single lane +
            # seed; the reference branches on the light
            # contribution before computing, ClosestHit:928-942, so
            # where-outside is also the parity-exact form).
            nee_pending = (ray_origin, l_dir,
                           jnp.where(ok[..., None], prefix * contrib, 0.0),
                           s_active)

        # Punctual light NEE (ClosestHit:944-956). When shadows are binary
        # (alpha_shadows off, or no MASK/BLEND material in the scene) AND a
        # bounce dispatch follows, the light shadow rays RIDE the merged
        # bounce+env-shadow launch below instead of paying their own any-hit
        # dispatch — the contribution is applied after that dispatch, in the
        # same accumulation order (light before env), so radiance is
        # bit-identical to the immediate trace.
        binary_shadows = (not settings.alpha_shadows) or (not meta.has_alpha_layer)
        merge_light_shadow = (
            nee_lights and settings.shadow_rays and binary_shadows
            and settings.merged_light_dispatch
            and bounce < settings.max_bounces
        )
        light_pending = None
        if nee_lights:
            u_l = rand4()[..., 0]
            intersection = origin + direction * hit.t[..., None]
            light_ray, l_pdf = sample_point_light(
                scene.lights, meta.num_lights, intersection, u_l
            )
            l_col = light_ray.color
            if settings.shadow_rays and not merge_light_shadow:
                shadow = trace_shadow(
                    scene, meta, ray_origin, light_ray.direction,
                    jnp.full(n_rays, params.max_ray_length, jnp.float32),
                    alpha_shadow=settings.alpha_shadows, active=alive,
                    sort_spatial=hit.tri,
                )
                ray_count = ray_count + jnp.sum(alive.astype(jnp.float32))
                l_col = l_col * shadow[..., None]
            f, _ = evaluate_bsdf(
                sp, attrs.geometric_normal, view, light_ray.direction, settings,
                scene.sheen_table, meta=meta,
            )
            ok = alive & jnp.any(l_col > 0.0, -1)
            if merge_light_shadow:
                # Zero-contribution lanes trace dead (same exactness argument
                # as the env s_active kill above).
                l_active = ok & jnp.any(f > 0.0, -1)
                light_pending = (
                    ray_origin, light_ray.direction,
                    jnp.where(ok[..., None], prefix * (l_col * f) / l_pdf, 0.0),
                    l_active,
                )
                ray_count = ray_count + jnp.sum(alive.astype(jnp.float32))
            else:
                radiance = radiance + jnp.where(
                    ok[..., None], prefix * (l_col * f) / l_pdf, 0.0
                )

        # Bounce (ClosestHit:958-1006).
        if bounce < settings.max_bounces:
            u3 = rand4()[..., 0:3]
            f, l_dir, pdf, is_t, use_mis = sample_bsdf(
                sp, u3, view, settings, scene.sheen_table, meta=meta
            )
            weight = jnp.where(pdf[..., None] != 0.0, f / pdf[..., None], 0.0)
            throughput = rr_state * weight

            if bounce == 0 and settings.debug_output in (
                S.DEBUG_BOUNCE_DIRECTION, S.DEBUG_BOUNCE_BSDF, S.DEBUG_BOUNCE_PDF,
                S.DEBUG_BOUNCE_WEIGHT, S.DEBUG_BOUNCE_IS_TRANSMISSION,
            ):
                dv = {
                    S.DEBUG_BOUNCE_DIRECTION: 0.5 * (l_dir + 1.0),
                    S.DEBUG_BOUNCE_BSDF: f,
                    S.DEBUG_BOUNCE_PDF: jnp.broadcast_to(pdf[..., None], f.shape),
                    S.DEBUG_BOUNCE_WEIGHT: weight,
                    S.DEBUG_BOUNCE_IS_TRANSMISSION: jnp.where(
                        is_t[..., None],
                        jnp.asarray([0.0, 1.0, 0.0]),
                        jnp.asarray([1.0, 0.0, 0.0]),
                    ),
                }[settings.debug_output]
                return jnp.where(alive[..., None], dv, 0.0), ray_count

            u_rr = rand4()[..., 0]
            continue_prob = jnp.clip(
                max_value(throughput)[..., 0],
                params.min_russian_roulette_continue_prob,
                params.max_russian_roulette_continue_prob,
            )
            apply_rr = bounce >= settings.min_bounces
            if apply_rr:
                cont = u_rr < continue_prob
                weight = weight / jnp.where(cont, continue_prob, 1.0)[..., None]
            else:
                cont = jnp.ones(n_rays, bool)

            alive = alive & cont & jnp.any(throughput > 0.0, -1)
            prefix = prefix * weight
            rr_state = throughput * weight  # quirk kept: TraceBounceRay passes
            # throughput*weight (PathTracer.lib.hlsl:995-1003) — affects only RR.
            origin = jnp.where(is_t[..., None], ray_origin_below, ray_origin)
            direction = l_dir
            prev_tri = hit.tri
            t_max = jnp.full(n_rays, params.max_ray_length, jnp.float32)
            prev_pdf = pdf
            prev_mis = use_mis

            # Merged dispatch: next-bounce closest rays + pending env-NEE
            # shadow rays in ONE launch (kernel route).
            eff_tmin = jnp.where(alive, 0.0, t_max + 1.0)
            trace_bounce = not (settings.indirect_environment_only and bounce + 1 >= 1)
            if nee_pending is not None or light_pending is not None:
                # Stack every pending binary shadow set (env NEE, punctual
                # NEE) into ONE merged launch with the bounce rays.
                sets = []
                if nee_pending is not None:
                    sets.append(nee_pending)
                if light_pending is not None:
                    sets.append(light_pending)
                s_tmax1 = jnp.full(n_rays, params.max_ray_length, jnp.float32)
                s_orig = jnp.concatenate([s[0] for s in sets])
                s_dir = jnp.concatenate([s[1] for s in sets])
                s_tmax = jnp.concatenate([s_tmax1] * len(sets))
                s_tmin = jnp.concatenate(
                    [jnp.where(s[3], 0.0, s_tmax1 + 1.0) for s in sets]
                )
                hit, shadow = trace_bounce_and_shadow(
                    scene, meta, origin, direction, eff_tmin, t_max,
                    s_orig, s_dir, s_tmin, s_tmax,
                    cull_sign=bounce_cull, sort_spatial=prev_tri,
                    trace_bounce=trace_bounce,
                )
                # Accumulation order preserved vs the unmerged path:
                # punctual light contribution first, then env NEE.
                if light_pending is not None:
                    l_trans = shadow[n_rays * (len(sets) - 1):]
                    radiance = radiance + light_pending[2] * l_trans[..., None]
                if nee_pending is not None:
                    s_contrib, s_active = nee_pending[2], nee_pending[3]
                    radiance = radiance + s_contrib * shadow[:n_rays][..., None]
                    ray_count = ray_count + jnp.sum(s_active.astype(jnp.float32))
            elif trace_bounce:
                hit = trace_closest(
                    scene, meta, origin, direction, eff_tmin, t_max,
                    cull_sign=bounce_cull, sort_rays=True, sort_spatial=prev_tri,
                )
            else:
                hit = bvh_ops.Hit(
                    t=t_max, tri=jnp.full(n_rays, -1, jnp.int32),
                    u=jnp.zeros(n_rays), v=jnp.zeros(n_rays),
                )

    # NaN/INF scrub + luminance clamp (RayGeneration:760-774).
    nan_mask = jnp.any(jnp.isnan(radiance), -1)
    inf_mask = jnp.any(jnp.isinf(radiance), -1)
    nan_count = jnp.sum(nan_mask.astype(jnp.float32)) + jnp.sum(inf_mask.astype(jnp.float32))
    red = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    radiance = jnp.where(
        nan_mask[..., None], red if settings.show_nan else jnp.zeros(3), radiance
    )
    radiance = jnp.where(
        inf_mask[..., None], red if settings.show_inf else jnp.zeros(3), radiance
    )
    if settings.luminance_clamp_enabled:
        lum = luminance(radiance)
        scale = jnp.where(
            lum > params.luminance_clamp, params.luminance_clamp / jnp.maximum(lum, 1e-20), 1.0
        )
        radiance = radiance * scale[..., None]

    return radiance, jnp.stack([ray_count, nan_count])


def _debug_channel(which, hit, attrs, sp, extras, view, alive):
    """The 28 debug outputs (ClosestHit:806-922). Returns (R,3) or None for
    bounce-stage channels handled inline."""
    def vis(x):
        return jnp.where(alive[..., None], x, 0.0)

    g = jnp.asarray([0.0, 1.0, 0.0])
    r = jnp.asarray([1.0, 0.0, 0.0])
    if which == S.DEBUG_HIT_KIND:
        return vis(jnp.where(attrs.back_face[..., None], g, r))
    if which == S.DEBUG_VERTEX_COLOR:
        return vis(attrs.color[..., :3])
    if which == S.DEBUG_VERTEX_ALPHA:
        return vis(jnp.repeat(attrs.color[..., 3:4], 3, -1))
    if which == S.DEBUG_VERTEX_NORMAL:
        return vis((attrs.normal + 1.0) / 2.0)
    if which == S.DEBUG_VERTEX_TANGENT:
        return vis((attrs.tangent[..., :3] + 1.0) / 2.0)
    if which == S.DEBUG_VERTEX_BITANGENT:
        return vis((attrs.bitangent + 1.0) / 2.0)
    if which == S.DEBUG_TEXCOORD_0:
        return vis(jnp.concatenate([attrs.uv0, jnp.zeros_like(attrs.uv0[..., :1])], -1))
    if which == S.DEBUG_TEXCOORD_1:
        return vis(jnp.concatenate([attrs.uv1, jnp.zeros_like(attrs.uv1[..., :1])], -1))
    if which == S.DEBUG_COLOR:
        return vis(sp.albedo)
    if which == S.DEBUG_ALPHA:
        return vis(jnp.repeat(sp.alpha, 3, -1))
    if which == S.DEBUG_SHADING_NORMAL:
        return vis((sp.shading_normal + 1.0) / 2.0)
    if which == S.DEBUG_SHADING_TANGENT:
        return vis((sp.anisotropy_tangent + 1.0) / 2.0)
    if which == S.DEBUG_SHADING_BITANGENT:
        return vis((sp.anisotropy_bitangent + 1.0) / 2.0)
    if which == S.DEBUG_METALNESS:
        return vis(jnp.repeat(sp.metalness, 3, -1))
    if which == S.DEBUG_ROUGHNESS:
        return vis(jnp.repeat(jnp.sqrt(sp.roughness_squared[..., 1:2]), 3, -1))
    if which == S.DEBUG_SPECULAR:
        return vis(jnp.repeat(sp.specular_factor, 3, -1))
    if which == S.DEBUG_SPECULAR_COLOR:
        return vis(sp.specular_color)
    if which == S.DEBUG_CLEARCOAT:
        return vis(jnp.repeat(sp.clearcoat, 3, -1))
    if which == S.DEBUG_CLEARCOAT_ROUGHNESS:
        return vis(jnp.repeat(sp.clearcoat_roughness, 3, -1))
    if which == S.DEBUG_CLEARCOAT_NORMAL:
        return vis((sp.clearcoat_normal + 1.0) / 2.0)
    if which == S.DEBUG_TRANSMISSIVE:
        return vis(jnp.repeat(sp.transmissive, 3, -1))
    if which == S.DEBUG_HEMISPHERE_VIEW_SIDE:
        side = dot(view, sp.shading_normal, keepdims=False) > 0.0
        return vis(jnp.where(side[..., None], g, r))
    return None


def accumulate(history, frame, accumulated_frames, settings: S.PathTracerSettings):
    """Running-mean accumulation (RayGeneration:776-786)."""
    if not settings.accumulate:
        return frame
    blend = 1.0 / (accumulated_frames.astype(jnp.float32) + 1.0)
    return jnp.where(accumulated_frames > 0, history + (frame - history) * blend, frame)
