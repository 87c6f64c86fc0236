"""Multi-host (multi-process) scale-out story — explicit and minimal.

SURVEY.md §2.3/§5: the reference has NO distributed machinery (single D3D12
device, Renderer.cpp:56); this framework's communication needs are minimal BY
CONSTRUCTION and are stated as such here:

* Inside one host, rendering shards over the (sample x tile) device mesh
  (parallel/sharding.py; on GPUs the cards of a host are joined all to all
  by NVLink, so the mesh follows the algorithm, not a topology) with exactly one collective per frame — a pmean of
  radiance over the sample axis (plus one all_gather of lit tiles for the
  raster transmission backdrop).
* Across hosts, there is NOTHING to communicate at render time beyond those
  same compiler-inserted collectives: the scene pytree is
  replicated (each process loads the same glTF from disk — deterministic
  build, no asset broadcast protocol needed), and RNG is keyed by absolute
  pixel coordinates (ops/rng.pt_random), so every process computes
  bit-identical tiles for its mesh slice. The host network carries only
  jax.distributed startup (coordinator handshake).

Usage across processes (one per host, or one per card):

    from gltf_renderer.parallel import distributed, sharding
    distributed.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = sharding.make_mesh(n_sample=..., n_tile=...)  # global devices
    scene_g = distributed.replicate(ptscene, mesh)
    img = sharding.render_sharded(scene_g, meta, ...)    # same API

make_mesh already builds over jax.devices(), which is the GLOBAL device list
after initialize(); the only multi-host-specific step is replicate(), which
turns host-local scene arrays into globally-replicated jax.Arrays so
shard_map accepts them in multi-process runs.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the multi-process JAX runtime; no-op for single-process runs.

    Arguments default to the standard JAX env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); nothing on a plain GPU host tells JAX
    of a cluster, so a multi-process run passes them explicitly. Returns
    (process_index, process_count).
    """
    explicit = (
        coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
        or int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1) > 1
    )
    if explicit:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Host-local pytree -> globally-REPLICATED jax.Arrays on the mesh.

    Single-process: equivalent to device_put (cheap, idempotent). Multi-
    process: every process must call this with the SAME values (each loads
    the same scene file); the result is addressable everywhere, which is
    what shard_map's in_specs=P() requires across hosts.
    """
    sharding = NamedSharding(mesh, P())

    def put(x):
        if x is None:
            return None
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)
