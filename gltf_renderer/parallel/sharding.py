"""Multi-chip scale-out: shard the pixel grid and/or the sample index over a
device mesh with shard_map (SURVEY.md §2.3 / §5).

Rendering is embarrassingly parallel: the scene/BVH pytree is replicated
(small), each chip path-traces its row-tile of the image; the only collective
is a `pmean` of radiance over the optional sample axis — one image-sized
reduction (NVLink between the cards of a host). The reference has NO
distributed machinery (single D3D12 device, Renderer.cpp:56); this is a
capability the JAX port adds.

RNG is keyed by absolute pixel coordinates + seed (ops/rng.pt_random), so the
sharded render is numerically identical to the single-device render.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import settings as S

SAMPLE_AXIS = "sample"
TILE_AXIS = "tile"


def make_mesh(n_sample: int = 1, n_tile: Optional[int] = None) -> Mesh:
    """2D device mesh: data-parallel over samples x spatial over pixel rows."""
    devices = np.asarray(jax.devices())
    if n_tile is None:
        n_tile = len(devices) // n_sample
    devices = devices[: n_sample * n_tile].reshape(n_sample, n_tile)
    return Mesh(devices, (SAMPLE_AXIS, TILE_AXIS))


def render_sharded(
    scene: pt.PTScene,
    meta: pt.PTMeta,
    settings: S.PathTracerSettings,
    params: S.PathTracerParams,
    clip_to_world,
    resolution: Tuple[int, int],
    seed,
    mesh: Mesh,
):
    """Path-trace one progressive sample, sharded over the mesh.

    Pixel rows shard over TILE_AXIS; each SAMPLE_AXIS slice renders an
    independent sample (seed offset by the axis index) and the result is the
    mean over samples — n_sample chips converge n_sample x faster per call.
    Returns the full (h, w, 3) radiance (replicated).
    """
    w, h = resolution
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    # Non-divisible heights round the tile up; rows past the image bottom are
    # extrapolated camera rays (RNG keys are absolute pixel coords, so live
    # rows are bit-identical to the single-device render) and cropped off.
    tile_h = -(-h // n_tile)

    def shard_fn(scene_rep, c2w, seed_arr):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        sample_idx = jax.lax.axis_index(SAMPLE_AXIS)
        local_seed = seed_arr[0] + sample_idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
        radiance = pt.trace(
            scene_rep,
            meta,
            settings,
            params,
            c2w,
            (w, tile_h),
            local_seed,
            pixel_offset=(0, tile_idx * tile_h),
            full_resolution=(w, h),
        )
        return jax.lax.pmean(radiance, SAMPLE_AXIS)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(TILE_AXIS, None, None),  # image rows (axis 0) over tiles
        check_vma=False,  # the traversal kernel (pallas_call) runs inside
    )
    seed_arr = jnp.atleast_1d(jnp.asarray(seed, jnp.uint32))
    return fn(scene, jnp.asarray(clip_to_world), seed_arr)[:h]


def render_sharded_jit(scene, meta, settings, params, clip_to_world, resolution, seed, mesh):
    """jitted wrapper (static: meta/settings/resolution/mesh)."""

    @functools.partial(jax.jit, static_argnums=())
    def go(scene, c2w, seed):
        return render_sharded(scene, meta, settings, params, c2w, resolution, seed, mesh)

    return go(scene, clip_to_world, seed)


def render_raster_sharded(
    scene,
    meta,
    render_settings,
    params,
    clip_to_world,
    camera_pos,
    resolution: Tuple[int, int],
    frame,
    mesh: Mesh,
    with_motion: bool = False,
    prev_world_to_clip=None,
    prev_position=None,
):
    """One raster frame (Rasterizer::DrawScene pass order) sharded over the
    mesh's TILE_AXIS — the multi-chip path for the raster backend.

    Pixel-row tiles shard exactly like render_sharded; the raster frame is
    deterministic, so the SAMPLE_AXIS (if >1) computes replicated values and
    the output stays valid on any (sample x tile) mesh. The one collective
    beyond the PT path: when the scene has blended/transmissive materials the
    transmission backdrop pyramid needs the FULL opaque image, so the lit
    tiles all_gather over TILE_AXIS (one image-sized transfer) and every
    shard builds the (small) mip pyramid redundantly — cheaper than sharding
    six tiny convs, and it keeps the blend pass bit-identical to the
    single-device render at tile seams.
    """
    from gltf_renderer.render import rasterizer

    w, h = resolution
    n_tile = mesh.shape[TILE_AXIS]
    tile_h = -(-h // n_tile)

    def shard_fn(scene_rep, c2w, prev_c2w):
        tile_idx = jax.lax.axis_index(TILE_AXIS)

        def lit_gather(tile_lit):
            full = jax.lax.all_gather(tile_lit, TILE_AXIS, axis=0, tiled=True)
            return full[:h]

        return rasterizer.render(
            scene_rep,
            meta,
            render_settings,
            params,
            c2w,
            camera_pos,
            (w, tile_h),
            frame,
            prev_world_to_clip=prev_c2w if prev_world_to_clip is not None else None,
            prev_position=prev_position,
            with_motion=with_motion,
            pixel_offset=(0, tile_idx * tile_h),
            full_resolution=(w, h),
            lit_gather=lit_gather,
        )

    out_spec = P(TILE_AXIS, None, None)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(out_spec, out_spec) if with_motion else out_spec,
        check_vma=False,  # as in render_sharded
    )
    prev = (
        jnp.asarray(prev_world_to_clip)
        if prev_world_to_clip is not None
        else jnp.eye(4, dtype=jnp.float32)
    )
    out = fn(scene, jnp.asarray(clip_to_world), prev)
    if with_motion:
        return out[0][:h], out[1][:h]
    return out[:h]
