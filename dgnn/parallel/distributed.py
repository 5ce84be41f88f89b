"""Multi-host process-group entry.

The reference is strictly single-GPU (SURVEY.md §2.6); this supplies the
missing distributed runtime axis: one JAX process per host,
`jax.distributed.initialize` to form the process group, a global `Mesh`
over every device of every host, and the same `shard_map`ped layers
(parallel/spmd.py) — XLA lowers the halo `all_to_all` to NCCL, over NVLink
between the cards of a host.  No hand-written transport exists anywhere
(the design rule: collectives are compiler-scheduled, reference SURVEY.md
§5 "Distributed communication backend").
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["initialize_cluster", "graph_mesh"]


def initialize_cluster(coordinator_address: str, num_processes: int,
                       process_id: int) -> None:
    """Join (or form) the multi-host process group.

    All three arguments are required: nothing in a plain GPU cluster tells
    JAX about its peers (e.g. ``coordinator_address="localhost:<port>"`` for
    several processes on one host).  Call once, before any jax array op, in
    every process (SURVEY.md §7 step 6).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def graph_mesh(axis_name: str = "graph"):
    """1-D mesh over every device in the process group (all cards of all
    hosts; the cards of a host are joined all to all, so the mesh follows
    the algorithm alone).  Shards from partition_graph(num_shards=mesh.size)
    drop into shard_map over this mesh unchanged — single-host multi-card
    and multi-host execution share one code path."""
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))
