"""Device-mesh construction helpers.

The reference is single-process (SURVEY §2: no MPI/NCCL, only a std::async
thread fan-out).  Here the communication backend is
``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives (NCCL on GPUs,
whose cards are joined all to all, so a mesh follows the algorithm alone);
these helpers
centralise mesh creation so every distributed entry point (solver, bench,
dryrun) builds meshes the same way.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


EDGE_AXIS = "edges"   # data-parallel axis over graph edges
BLOCK_AXIS = "blocks" # map-block axis for the partitioned Schur solver
REPLICA_AXIS = "replicas"  # pure-DP axis over independent problems (seeds)


def make_edge_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over the edge data-parallel axis."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (EDGE_AXIS,))


def make_block_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over graph partitions (map blocks)."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (BLOCK_AXIS,))


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Multi-host process bootstrap: ``jax.distributed.initialize``.

    The replacement for an MPI launcher (the reference is single-process
    -- SURVEY §2; a multi-host deployment of the distributed solvers needs
    one JAX process per host, all joined to a coordinator before any mesh
    is built).  Pass the arguments explicitly or via
    ``SLAM_TPU_COORDINATOR`` / ``SLAM_TPU_NUM_PROCESSES`` /
    ``SLAM_TPU_PROCESS_ID``; one process driving all the cards of one
    host needs none of this.  Safe to call twice (second call is a no-op).
    Returns True if distributed mode is active (more than one process).
    """
    import os

    import jax

    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "SLAM_TPU_COORDINATOR"
    )
    if num_processes is None and "SLAM_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SLAM_TPU_NUM_PROCESSES"])
    if process_id is None and "SLAM_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SLAM_TPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # Single-host usage (this repo's test/bench environment): nothing
        # to join; meshes build from the local devices.
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def make_replica_block_mesh(
    num_replicas: int, num_blocks: int
) -> Mesh:
    """2-D mesh: pure-DP replica axis (independent problems, e.g. outlier
    seeds -- the reference's Try1/Try2 Monte-Carlo pattern) x map-block axis
    (partitioned Schur).  No collective crosses the replica axis; the
    block axis carries the separator psums, so across hosts it is the
    axis to keep within one host."""
    devs = jax.devices()[: num_replicas * num_blocks]
    if len(devs) != num_replicas * num_blocks:
        raise ValueError(
            f"need {num_replicas * num_blocks} devices, "
            f"have {len(jax.devices())}"
        )
    return Mesh(
        np.array(devs).reshape(num_replicas, num_blocks),
        (REPLICA_AXIS, BLOCK_AXIS),
    )


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
