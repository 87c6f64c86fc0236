"""Keyframe animation sampling + playback (port of Animation.cpp:72-123,
AnimationPlayer.cpp:3-23, Gltf::Animate Gltf.cpp:992-1013).

Host-side numpy: per-frame channel evaluation is tiny (dozens of channels).
Deviations from the reference (both flagged broken in the source):
  - CUBICSPLINE uses the correct glTF [in_tangent, value, out_tangent] layout
    (Animation.cpp:111 reads the same element for value and tangents,
    commented "TODO: I think this is wrong").
  - LINEAR rotation slerp uses glTF (x, y, z, w) component order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from gltf_renderer.scene import types as T


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def sample_channel(ch: T.AnimationChannel, time: float) -> np.ndarray:
    """Evaluate one channel at `time` (clamped to its key range)."""
    times = ch.times
    time = float(np.clip(time, times[0], times[-1]))
    k0 = int(np.searchsorted(times, time, side="right") - 1)
    k0 = max(0, min(k0, len(times) - 1))
    k1 = k0 + 1 if (k0 + 1 < len(times) and times[k0] < time) else k0
    dt = times[k1] - times[k0]
    f = 0.0 if dt == 0.0 else (time - times[k0]) / dt

    vals = ch.values
    if ch.interpolation == T.INTERP_STEP:
        return vals[k0].copy()
    if ch.interpolation == T.INTERP_CUBICSPLINE:
        # glTF layout: per keyframe [in_tangent, value, out_tangent].
        v0 = vals[3 * k0 + 1]
        b0 = vals[3 * k0 + 2]  # out-tangent of k0
        v1 = vals[3 * k1 + 1]
        a1 = vals[3 * k1 + 0]  # in-tangent of k1
        t2 = f * f
        t3 = t2 * f
        out = (
            (2 * t3 - 3 * t2 + 1) * v0
            + dt * (t3 - 2 * t2 + f) * b0
            + (-2 * t3 + 3 * t2) * v1
            + dt * (t3 - t2) * a1
        )
        if ch.path == T.PATH_ROTATION:
            out = out / max(np.linalg.norm(out), 1e-12)
        return out
    # LINEAR
    if ch.path == T.PATH_ROTATION:
        return _slerp(vals[k0], vals[k1], f)
    return vals[k0] + f * (vals[k1] - vals[k0])


@dataclasses.dataclass
class LocalPose:
    """Per-frame node-local TRS + morph weights (Gltf node state mirror)."""

    t: np.ndarray                      # (N, 3)
    r: np.ndarray                      # (N, 4) xyzw
    s: np.ndarray                      # (N, 3)
    weights: Dict[int, np.ndarray]     # node -> morph weights


def rest_pose(scene: T.Scene) -> LocalPose:
    """Gltf::ApplyRestTransforms (Gltf.cpp:977-990)."""
    n = scene.num_nodes()
    t = np.stack([nd.translation for nd in scene.nodes]) if n else np.zeros((0, 3), np.float32)
    r = np.stack([nd.rotation for nd in scene.nodes]) if n else np.zeros((0, 4), np.float32)
    s = np.stack([nd.scale for nd in scene.nodes]) if n else np.zeros((0, 3), np.float32)
    weights: Dict[int, np.ndarray] = {}
    for i, nd in enumerate(scene.nodes):
        if nd.weights is not None and len(nd.weights):
            weights[i] = np.array(nd.weights, np.float32)
        elif nd.mesh >= 0 and scene.meshes[nd.mesh].weights is not None:
            weights[i] = np.array(scene.meshes[nd.mesh].weights, np.float32)
        elif nd.mesh >= 0:
            k = max(
                (int(scene.primitives.morph_count[p]) for p in scene.meshes[nd.mesh].primitives),
                default=0,
            )
            if k:
                weights[i] = np.zeros(k, np.float32)
    return LocalPose(t.copy(), r.copy(), s.copy(), weights)


def animate(scene: T.Scene, animation: T.Animation, time: float) -> LocalPose:
    """Gltf::Animate (Gltf.cpp:992-1013): rest pose + channel overrides."""
    pose = rest_pose(scene)
    for ch in animation.channels:
        v = sample_channel(ch, time)
        if ch.path == T.PATH_TRANSLATION:
            pose.t[ch.node] = v
        elif ch.path == T.PATH_ROTATION:
            pose.r[ch.node] = v
        elif ch.path == T.PATH_SCALE:
            pose.s[ch.node] = v
        elif ch.path == T.PATH_WEIGHTS:
            pose.weights[ch.node] = np.asarray(v, np.float32).reshape(-1)
    return pose


@dataclasses.dataclass
class AnimationPlayer:
    """AnimationPlayer.cpp:3-23: playhead advance with looping."""

    animation: Optional[T.Animation] = None
    time: float = 0.0
    playing: bool = True
    looping: bool = True

    def tick(self, scene: T.Scene, delta: float) -> Optional[LocalPose]:
        if self.animation is None:
            return None
        if self.playing:
            self.time += delta
            duration = self.animation.duration
            if self.looping and duration > 0 and self.time > duration:
                self.time = self.time % duration
        return animate(scene, self.animation, self.time)
