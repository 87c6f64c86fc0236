"""Top-level renderer orchestration (port of Renderer.{h,cpp}).

Renderer::DrawFrame (Renderer.cpp:274-374) becomes: host-side animation +
node transforms -> jitted skinning -> jitted world-geometry build -> BVH
build/refit -> ONE jitted render step (path trace + accumulate, or raster) ->
jitted post (bloom + AgX tonemap + dither) -> u8 image.

No command lists, fences, or descriptor heaps: ordering is data dependence
inside the jitted graphs; double buffering is XLA's async dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.anim.animation import AnimationPlayer, LocalPose, rest_pose
from gltf_renderer.anim.skinning import DynamicMeshState
from gltf_renderer.camera import Camera
from gltf_renderer.env.environment import EnvMaps, build_environment
from gltf_renderer.env.hdr_io import read_environment_image
from gltf_renderer.ops import bvh as bvh_ops
from gltf_renderer.post.bloom import bloom as bloom_op
from gltf_renderer.post.tonemap import to_u8, tonemap
from gltf_renderer.render import pathtracer as pt
from gltf_renderer.render import settings as S
from gltf_renderer.scene import flatten
from gltf_renderer.scene import types as T
from gltf_renderer.scene.gltf import load_gltf

log = logging.getLogger("gltf_renderer.renderer")


@functools.partial(jax.jit, static_argnums=(1, 2, 5))
def _pt_step(ptscene, meta, settings, params, c2w, resolution, seed, accum, frames):
    # named_scope = the PIX pass-marker analogue (CommandContext.cpp:4-21).
    with jax.named_scope("path_trace_scene"):
        radiance = pt.trace(ptscene, meta, settings, params, c2w, resolution, seed)
    with jax.named_scope("accumulate"):
        new_accum = pt.accumulate(accum, radiance, frames, settings)
    return new_accum


@functools.partial(jax.jit, static_argnums=(1, 2, 6))
def _raster_step(ptscene, meta, settings, params, c2w, cam_pos, resolution, frame):
    # The whole DrawScene runs as ONE jitted graph (Rasterizer.cpp:150-288).
    from gltf_renderer.render import rasterizer

    with jax.named_scope("draw_scene"):
        return rasterizer.render(
            ptscene, meta, settings, params, c2w, cam_pos, resolution, frame,
        )


@functools.partial(jax.jit, static_argnums=(1, 2, 5, 9))
def _pt_step_sharded(ptscene, meta, settings, params, c2w, resolution, seed,
                     accum, frames, mesh):
    """_pt_step over a device mesh (jax.sharding.Mesh is hashable -> static):
    pixel-row tiles + independent sample seeds, one pmean (parallel/sharding)."""
    from gltf_renderer.parallel import sharding

    with jax.named_scope("path_trace_scene_sharded"):
        radiance = sharding.render_sharded(
            ptscene, meta, settings, params, c2w, resolution, seed, mesh
        )
    with jax.named_scope("accumulate"):
        return pt.accumulate(accum, radiance, frames, settings)


@functools.partial(jax.jit, static_argnums=(1, 2, 6, 8))
def _raster_step_sharded(ptscene, meta, settings, params, c2w, cam_pos,
                         resolution, frame, mesh):
    from gltf_renderer.parallel import sharding

    with jax.named_scope("draw_scene_sharded"):
        return sharding.render_raster_sharded(
            ptscene, meta, settings, params, c2w, cam_pos, resolution, frame,
            mesh,
        )


@functools.partial(jax.jit, static_argnums=(1,))
def _bloom_step(hdr, bloom_settings):
    with jax.named_scope("bloom"):
        return bloom_op(hdr, bloom_settings.max_mips, bloom_settings.strength)


@functools.partial(jax.jit, static_argnums=(1,))
def _tone_step(img, tm_settings: S.ToneMapSettings, frame):
    with jax.named_scope("tone_map"):
        return to_u8(tonemap(img, tm_settings.tonemapper, tm_settings.exposure, frame))


def _post_step(hdr, tm_settings: S.ToneMapSettings, bloom_settings, frame):
    """Bloom + tonemap + u8 as TWO dispatches, deliberately NOT one graph:
    fused, XLA's layout assignment let the tonemapper's 3x3 channel dots
    force channel-minor layouts back into the bloom pyramid. The split was
    chosen before the GPU port and is not yet measured on the H100."""
    img = hdr
    if bloom_settings is not None and bloom_settings.enabled:
        img = _bloom_step(hdr, bloom_settings)
    return _tone_step(img, tm_settings, frame)


class Renderer:
    """Interactive/offline renderer state machine."""

    def __init__(self, settings: Optional[S.RenderSettings] = None, mesh=None):
        """mesh: None = single device (default); "auto" = shard over every
        visible device (1 x n_devices tile mesh; multi-host after
        parallel.distributed.initialize); or an explicit (sample x tile)
        jax.sharding.Mesh from parallel.sharding.make_mesh. Both backends
        route through the sharded step functions when set."""
        self.settings = settings or S.RenderSettings()
        self.params = S.PathTracerParams()
        if mesh == "auto":
            from gltf_renderer.parallel import sharding

            n = jax.device_count()
            mesh = sharding.make_mesh(n_sample=1, n_tile=n) if n > 1 else None
        self.mesh = mesh
        self.scene: Optional[T.Scene] = None
        self.env: Optional[EnvMaps] = None
        self.camera = Camera(aspect_ratio=self.settings.width / self.settings.height)
        self.player = AnimationPlayer()
        # Derived state.
        self._plan = None
        self._tri_flags = None
        self._pools_dev = None
        self._materials_dev = None
        self._textures_dev = None
        self._dynamic: Optional[DynamicMeshState] = None
        self._ptscene: Optional[pt.PTScene] = None
        self._meta: Optional[pt.PTMeta] = None
        self._bvh_host = None
        self._accum = None
        self.accumulated_frames = 0
        self._last_reset_key = None
        self.frame_index = 0
        self.stats: Dict[str, float] = {}
        self.profile = False  # per-pass ms in stats["pass_ms"] (PIX markers)
        # Always-on per-frame counter ring (Tracy counter plots analogue).
        import collections

        self.history = collections.deque(maxlen=240)
        self._scene_bytes = 0  # device bytes of scene pools (memory pools)
        # glTF camera tracking: when set, the view matrix is re-derived from
        # the camera node's global transform EVERY frame, so cameras riding
        # animated nodes move with the animation (Gltf.cpp:1015-1041 node
        # globals + Camera.h:70-73 SetWorldToView).
        self._track_camera: Optional[int] = None
        self._track_camera_node: Optional[int] = None

    # -- loading -----------------------------------------------------------

    def load_scene(self, path_or_scene, scene_id=None):
        """LoadGltf (Main.cpp:43-54). scene_id selects a glTF scene (UI's
        scene selector, Main.cpp:190-200); default = document default."""
        scene = path_or_scene if isinstance(path_or_scene, T.Scene) else load_gltf(path_or_scene)
        sid = scene.default_scene if scene_id is None else scene_id
        if scene.scenes and not (0 <= sid < len(scene.scenes)):
            # Validate BEFORE mutating state: a bad UI index must not leave
            # self.scene_id out of sync with what is actually rendered.
            raise IndexError(f"scene index {sid} out of range (document has "
                             f"{len(scene.scenes)} scenes)")
        self.scene = scene
        self.scene_id = sid
        self._plan = flatten.build_instance_plan(scene, self.scene_id)
        self._tri_flags = flatten.plan_tri_flags(self._plan, scene.primitives)
        self._pools_dev = jax.tree.map(jnp.asarray, scene.pools)
        self._materials_dev = jax.tree.map(jnp.asarray, scene.materials)
        self._textures_dev = jax.tree.map(jnp.asarray, scene.textures)
        self._dynamic = DynamicMeshState(scene)
        # Named-memory-pool analogue (GpuAllocator Tracy pools): total device
        # bytes of the uploaded scene pools, recorded once per load.
        self._scene_bytes = int(sum(
            x.nbytes for t in (self._pools_dev, self._materials_dev,
                               self._textures_dev)
            for x in jax.tree.leaves(t)
        ))
        self._ptscene = None
        self._bvh_host = None
        self._accum = None
        self.accumulated_frames = 0
        self.player = AnimationPlayer()
        if scene.animations:
            self.player.animation = scene.animations[0]
        return scene

    def select_scene(self, scene_id: int):
        """Re-plan for a different glTF scene (flushes derived state)."""
        self.load_scene(self.scene, scene_id=scene_id)

    def select_animation(self, index: Optional[int]):
        self.player.animation = None if index is None else self.scene.animations[index]
        self.player.time = 0.0

    def select_camera(self, index: Optional[int], viewport_aspect: float = None):
        """Follow glTF camera `index` (None = back to the free/orbit camera).

        Intrinsics come from the camera def; the view matrix tracks the
        camera node's animated global transform each draw_frame.
        """
        self._track_camera = index
        self._track_camera_node = None
        if index is None:
            return
        cam = self.scene.cameras[index]
        self._track_camera_node = next(
            (i for i, nd in enumerate(self.scene.nodes) if nd.camera == index), None
        )
        self.camera.type = cam.type
        self.camera.y_fov = cam.yfov
        self.camera.aspect_ratio = cam.aspect or (
            viewport_aspect or self.settings.width / self.settings.height
        )
        self.camera.z_near = cam.znear
        self.camera.z_far = cam.zfar
        self.camera.x_mag = cam.xmag
        self.camera.y_mag = cam.ymag

    def _apply_tracked_camera(self, node_tf):
        if self._track_camera is None or self._track_camera_node is None:
            return
        # world_to_view = inverse of the node's global transform (the node
        # global already includes the Z-up basis change at the scene root).
        self.camera.world_to_view = np.linalg.inv(
            np.asarray(node_tf[self._track_camera_node])
        ).astype(np.float32)

    def load_environment(self, path_or_array):
        if isinstance(path_or_array, str):
            equirect = read_environment_image(path_or_array)
        else:
            equirect = np.asarray(path_or_array, np.float32)
        self.env = build_environment(equirect)
        self._ptscene = None

    # -- per-frame ---------------------------------------------------------

    def _update_geometry(self, pose: Optional[LocalPose]):
        scene = self.scene
        if pose is None:
            pose = rest_pose(scene)
        node_tf = flatten.compute_global_transforms(scene, None, pose.t, pose.r, pose.s)
        lights = flatten.gather_lights(scene, node_tf)

        has_dynamic = bool(self._dynamic.dynamic_instances)
        if has_dynamic:
            self._dynamic.update(node_tf, pose.weights)
            dyn = (self._dynamic.positions, self._dynamic.normals, self._dynamic.tangents)
        else:
            dyn = (None, None, None)

        world = flatten.build_world_geometry(
            self._pools_dev,
            self._plan,
            jnp.asarray(node_tf),
            jnp.asarray(flatten.normal_transforms(node_tf)),
            self._tri_flags,
            *dyn,
        )

        lights_dev = jax.tree.map(jnp.asarray, lights)
        if self._ptscene is None:
            self._ptscene, self._meta = pt.make_pt_scene(
                world, self._materials_dev, self._textures_dev, lights_dev, env=self.env
            )
            self._bvh_host = None if not has_dynamic else self._host_bvh_copy()
        else:
            # Geometry moved: update world pools; refit BVH (static topology)
            # and refresh the packed traversal tables on-device.
            tree = self._ptscene.bvh
            packed = self._ptscene.packed
            if has_dynamic:
                tv = world.tri_vertex
                p0 = world.position[tv[:, 0]]
                p1 = world.position[tv[:, 1]]
                p2 = world.position[tv[:, 2]]
                host = self._refit_topo()
                refitted = bvh_ops.refit(host, p0, p1, p2)
                tree = self._ptscene.bvh._replace(
                    aabb_min=refitted.aabb_min, aabb_max=refitted.aabb_max
                )
                order = host.tri_order
                packed = bvh_ops.pack_update(
                    packed, host, p0[order], (p1 - p0)[order], (p2 - p0)[order],
                    refitted=refitted,
                )
            self._ptscene = self._ptscene._replace(
                world=world, bvh=tree, packed=packed, lights=lights_dev,
            )
        return node_tf

    def _host_bvh_copy(self):
        b = self._ptscene.bvh
        return jax.tree.map(np.asarray, b)

    def _refit_topo(self):
        if self._bvh_host is None:
            self._bvh_host = self._host_bvh_copy()
        return self._bvh_host

    def _reset_key(self):
        # Dynamic params join the key: the reference resets accumulation on
        # any Graphics-tab change (Main.cpp:262-337 `reset |=` chains).
        param_key = tuple(
            tuple(np.asarray(leaf).ravel().tolist())
            for leaf in jax.tree.leaves(self.params)
        )
        return (
            self.settings.pt,
            param_key,
            tuple(np.asarray(self.camera.world_to_clip()).ravel().tolist()),
            id(self.scene),
            id(self.env),
            self.player.time if self.player.animation else 0.0,
        )

    def save_state(self, path: str):
        """Checkpoint the progressive accumulation (SURVEY.md §5: the PT's
        history image + accumulated_frames counter, Pathtracer.cpp:259-272 —
        the reference cannot persist this; we can)."""
        np.savez(
            path,
            accum=np.asarray(self._accum) if self._accum is not None else np.zeros(0),
            accumulated_frames=self.accumulated_frames,
            frame_index=self.frame_index,
        )

    def load_state(self, path: str):
        """Resume a checkpointed progressive render (camera/scene/settings
        must match — the reset key will clear it otherwise)."""
        data = np.load(path)
        accum = data["accum"]
        self._accum = jnp.asarray(accum) if accum.size else None
        self.accumulated_frames = int(data["accumulated_frames"])
        self.frame_index = int(data["frame_index"])
        # Adopt the current reset key so resuming does not clear the history.
        self._last_reset_key = self._reset_key()

    def draw_frame(self, delta: float = 0.0, seed: Optional[int] = None) -> np.ndarray:
        """One frame -> (H, W, 3) u8. Progressive accumulation persists across
        calls until camera/settings/animation change (Pathtracer.cpp:259-272)."""
        assert self.scene is not None, "no scene loaded"
        import time as _time

        t_frame = _time.perf_counter()
        st = self.settings
        pass_ms = {}

        def _timed(name, fn, *a, **kw):
            if not self.profile:
                return fn(*a, **kw)
            t0 = _time.perf_counter()
            out = fn(*a, **kw)
            jax.block_until_ready(out) if out is not None else None
            pass_ms[name] = round((_time.perf_counter() - t0) * 1e3, 3)
            return out

        pose = self.player.tick(self.scene, delta) if self.player.animation else None
        node_tf = _timed("skin_and_refit", self._update_geometry, pose)
        self._apply_tracked_camera(node_tf)

        key = self._reset_key()
        if key != self._last_reset_key:
            self._last_reset_key = key
            self.accumulated_frames = 0

        resolution = (st.width, st.height)
        c2w = jnp.asarray(self.camera.clip_to_world())
        if self._accum is None or self._accum.shape[:2] != (st.height, st.width):
            self._accum = jnp.zeros((st.height, st.width, 3), jnp.float32)
            self.accumulated_frames = 0

        if st.backend == "pathtracer":
            if self.accumulated_frames < st.pt.max_accumulated_frames:
                # Pathtracer.cpp:316: seed = frame counter when
                # use_frame_as_seed, else the pinned settings seed.
                if seed is not None:
                    frame_seed = seed
                elif st.pt.use_frame_as_seed:
                    frame_seed = self.accumulated_frames
                else:
                    frame_seed = self.params.fixed_seed
                if self.mesh is not None:
                    self._accum = _timed("path_trace_scene", _pt_step_sharded,
                        self._ptscene, self._meta, st.pt, self.params, c2w,
                        resolution, jnp.uint32(frame_seed), self._accum,
                        jnp.int32(self.accumulated_frames), self.mesh,
                    )
                else:
                    self._accum = _timed("path_trace_scene", _pt_step,
                        self._ptscene,
                        self._meta,
                        st.pt,
                        self.params,
                        c2w,
                        resolution,
                        jnp.uint32(frame_seed),
                        self._accum,
                        jnp.int32(self.accumulated_frames),
                    )
                self.accumulated_frames += 1
            hdr = self._accum
            bloom_settings = None  # bloom is raster-only (Rasterizer.cpp:281)
        else:
            if self.mesh is not None:
                hdr = _timed("draw_scene", _raster_step_sharded,
                    self._ptscene, self._meta, st, self.params, c2w,
                    jnp.asarray(self.camera.position()), resolution,
                    jnp.uint32(self.frame_index), self.mesh,
                )
            else:
                hdr = _timed("draw_scene", _raster_step,
                    self._ptscene, self._meta, st, self.params, c2w,
                    jnp.asarray(self.camera.position()), resolution,
                    jnp.uint32(self.frame_index),
                )
            self._accum = hdr
            bloom_settings = st.bloom

        img = _timed("post(bloom+tonemap)", _post_step,
                     hdr, st.tonemap, bloom_settings, jnp.uint32(self.frame_index))
        img_np = np.asarray(img)  # blocks: frame_ms below is true wall time
        self.frame_index += 1
        frame_ms = round((_time.perf_counter() - t_frame) * 1e3, 3)
        self.stats = {
            "frame": self.frame_index,
            "frame_ms": frame_ms,
            "accumulated_frames": self.accumulated_frames,
            "backend": st.backend,
            "triangles": int(np.asarray(self._ptscene.world.tri_vertex).shape[0]),
            "scene_bytes": self._scene_bytes,
        }
        if self.profile:
            self.stats["pass_ms"] = pass_ms
        # Always-on counter ring (the Tracy counter-plot / named-memory-pool
        # analogue, Profiling.h:21-43 + Renderer.cpp:372-373): cheap enough
        # to keep on every frame; viewers/tools read it for live plots.
        self.history.append({
            "frame": self.frame_index,
            "frame_ms": frame_ms,
            "spp": self.accumulated_frames,
            "backend": st.backend,
        })
        return img_np

    def capture_trace(self, log_dir: str):
        """jax.profiler trace capture around frames (the Tracy/PIX timeline
        analogue, Profiling.h:21-43): use as

            with renderer.capture_trace("/tmp/trace"):
                renderer.draw_frame()

        then inspect with TensorBoard / xprof."""
        return jax.profiler.trace(log_dir)
