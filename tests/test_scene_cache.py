"""PTScene disk-cache invariants (utils/scene_cache.py).

The cache is only EXERCISED end-to-end on an accelerator default device
(make_pt_scene's run-on-CPU branch); these tests pin the key/value contract
on any backend: content-addressed keys, knob + code sensitivity, atomic
store/load roundtrip of a nested NamedTuple pytree, corrupt-entry recovery.
"""

import os
from collections import namedtuple

import numpy as np
import pytest

from gltf_renderer.utils import scene_cache

Pair = namedtuple("Pair", "a b")


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "ptscene")
    monkeypatch.setenv("GLTF_SCENE_CACHE", d)
    return d


def test_key_is_content_addressed(cache_dir):
    x = Pair(np.arange(12, dtype=np.float32), np.ones((3, 4), np.int32))
    y = Pair(np.arange(12, dtype=np.float32), np.ones((3, 4), np.int32))
    assert scene_cache.compute_key(x) == scene_cache.compute_key(y)
    z = Pair(np.arange(12, dtype=np.float32), 2 * np.ones((3, 4), np.int32))
    assert scene_cache.compute_key(x) != scene_cache.compute_key(z)
    # dtype and shape are part of the identity, not just the bytes
    w = Pair(np.arange(12, dtype=np.float32),
             np.ones((4, 3), np.int32))
    assert scene_cache.compute_key(x) != scene_cache.compute_key(w)


def test_key_depends_on_build_knobs(cache_dir, monkeypatch):
    x = Pair(np.zeros(4, np.float32), None)
    k0 = scene_cache.compute_key(x)
    monkeypatch.setenv("GLTF_QUAD", "0")
    assert scene_cache.compute_key(x) != k0
    # ... but NOT on the cache-location knobs themselves
    monkeypatch.delenv("GLTF_QUAD")
    monkeypatch.setenv("GLTF_SCENE_CACHE", "/elsewhere")
    assert scene_cache.compute_key(x) == k0


def test_store_load_roundtrip(cache_dir):
    val = (Pair(np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32),
                np.asarray([1, 2, 3], np.int64)),
           {"meta": (1, True, (0, 1, 2))})
    key = scene_cache.compute_key(val[0])
    assert scene_cache.load(key) is None
    scene_cache.store(key, val)
    out = scene_cache.load(key)
    assert out is not None
    np.testing.assert_array_equal(out[0].a, val[0].a)
    np.testing.assert_array_equal(out[0].b, val[0].b)
    assert out[1] == val[1]


def test_corrupt_entry_is_discarded(cache_dir):
    key = "deadbeef"
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, key + ".pkl"), "wb") as f:
        f.write(b"not a pickle")
    assert scene_cache.load(key) is None


def test_disabled_cache(monkeypatch):
    monkeypatch.setenv("GLTF_SCENE_CACHE", "off")
    assert scene_cache.cache_dir() is None
    scene_cache.store("k", {"x": 1})  # must be a no-op, not an error
    assert scene_cache.load("k") is None
