"""Disk cache for finished PTScene tables.

make_pt_scene is a pure function of the (world, materials, textures, lights,
env) numpy leaves, the GLTF_* build knobs, and the builder code — but
rebuilding its tables (quad-atlas/mip pyramid builds + BVH + packing) takes
a long time at bench scale. Same pattern as the env-prefilter disk cache:
key = content hash of every input leaf + knobs + a digest of the builder
source files, value = the pickled host-side (scene, meta) pytree.
A code edit to any builder module auto-invalidates (source digest changes).

Cache dir: $GLTF_SCENE_CACHE or ~/.cache/gltf_renderer/ptscene
(set to 0/off/none to disable).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys
import tempfile

_DEFAULT_DIR = os.path.expanduser("~/.cache/gltf_renderer/ptscene")

# Modules whose code determines the built tables (relative to the package
# root). Over-inclusion only costs a rebuild after unrelated edits.
_SOURCE_FILES = (
    "render/pathtracer.py",
    "ops/bvh.py",
    "ops/texture.py",
    "env/environment.py",
    "scene/types.py",
    "scene/flatten.py",
)
_VERSION = b"ptscene-cache-v1"


def cache_dir() -> str | None:
    d = os.environ.get("GLTF_SCENE_CACHE", _DEFAULT_DIR)
    return None if d.lower() in ("0", "off", "none") else d


def _code_digest() -> bytes:
    h = hashlib.sha256(_VERSION)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in _SOURCE_FILES:
        try:
            with open(os.path.join(pkg, rel), "rb") as f:
                h.update(hashlib.sha256(f.read()).digest())
        except OSError:
            h.update(b"missing:" + rel.encode())
    return h.digest()


def compute_key(inputs) -> str:
    """Content hash of an arbitrary pytree of array/scalar leaves, plus the
    GLTF_* knob environment and the builder source digest."""
    import jax
    import numpy as np

    h = hashlib.sha256(_code_digest())
    for k in sorted(k for k in os.environ if k.startswith("GLTF_")):
        if k == "GLTF_SCENE_CACHE":
            continue  # the cache location doesn't change what gets built
        h.update(f"{k}={os.environ[k]};".encode())
    leaves, treedef = jax.tree.flatten(inputs)
    h.update(str(treedef).encode())
    for leaf in leaves:
        a = np.asarray(leaf)
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def load(key: str):
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".pkl")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return None
    except Exception as e:  # e.g. a renamed NamedTuple class
        print(f"[scene_cache] discarding stale entry {path}: {e}",
              file=sys.stderr)
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def store(key: str, value) -> None:
    d = cache_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(value, f, protocol=4)
        os.replace(tmp, os.path.join(d, key + ".pkl"))
    except OSError as e:  # a full disk must never sink the build
        print(f"[scene_cache] store failed: {e}", file=sys.stderr)
