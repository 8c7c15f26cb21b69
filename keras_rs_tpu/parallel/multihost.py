"""Multi-host utilities.

The reference relies on `jax.distributed` initialization implicitly via
TPU-VM tooling, `multihost_utils.process_allgather` for input-stat sync
(jax/distributed_embedding.py:663), and per-process dataset sharding with
identical seeded shuffles (examples/ml_perf/dataloader.py:210-234). These
helpers package the same capabilities; on a single process they are
no-ops, so the same training script runs on one device and on many hosts.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(**kwargs: Any) -> None:
    """jax.distributed.initialize, tolerant of single-process runs."""
    if jax.process_count() > 1 or kwargs:
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError:
            pass  # already initialized


def process_allgather(x: Any) -> Any:
    """Gathers host-local values from every process (stats sync parity)."""
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(
            lambda v: np.asarray(v)[None], x
        )
    return multihost_utils.process_allgather(x)


#: Stats that are additive across hosts (each host drops its own ids);
#: everything else merges with max (capacities are per-shard maxima).
_SUM_STATS = frozenset({"dropped_ids"})


def sync_max_stats(
    stats: dict[str, int], sum_keys: frozenset[str] = _SUM_STATS
) -> dict[str, int]:
    """Merges integer stats across processes (update_stats parity,
    jax/distributed_embedding.py:658-719): max for capacity watermarks,
    SUM for additive counters like `dropped_ids` (each host's drops are
    disjoint, so a max would under-report the global count)."""
    keys = sorted(stats)
    local = np.asarray([stats[k] for k in keys], np.int64)
    gathered = np.asarray(process_allgather(local))
    merged_max = np.max(gathered, axis=0)
    merged_sum = np.sum(gathered, axis=0)
    return {
        k: int(merged_sum[i] if k in sum_keys else merged_max[i])
        for i, k in enumerate(keys)
    }


def global_batch_from_host_shards(
    mesh: Mesh, batch: Any, axis_name: str = "data"
) -> Any:
    """Assembles per-host shards into globally-sharded device arrays.

    Each process passes its local slice of the global batch (first dim =
    global_batch / process_count); the result is a global array sharded
    over `axis_name`. Single-process: plain device_put with batch
    sharding.
    """
    sharding = NamedSharding(mesh, P(axis_name))

    def put(x):
        x = np.asarray(x)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        global_shape = (
            x.shape[0] * jax.process_count(),
        ) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            sharding, x, global_shape
        )

    return jax.tree_util.tree_map(put, batch)
