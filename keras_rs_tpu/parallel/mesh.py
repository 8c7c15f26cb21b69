"""Mesh construction and sharding helpers.

The reference builds a dedicated 1-D mesh over all TPU devices for
embedding sharding plus `keras.distribution.DataParallel` for the dense
model (jax/distributed_embedding.py:203-255, examples/ml_perf/main.py:
117-119). Here a single 1-D mesh serves both roles: the batch is
sharded over the axis (data parallel) AND embedding tables are row-sharded
over the same axis (model parallel), exactly the hybrid described in
SURVEY.md §2.9.

2-D meshes are supported by passing a TUPLE of axis names everywhere an
`axis_name` is accepted (parity with the reference's model x data mesh
exploration, jax/embedding_lookup_test.py:216-310): batch and table rows
shard over the flattened product of the axes, and the lookup's
collectives run over the axis tuple.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def create_mesh(
    devices: list[jax.Device] | None = None,
    axis_name: str | tuple[str, ...] = DATA_AXIS,
    axis_sizes: tuple[int, ...] | None = None,
) -> Mesh:
    """Mesh over all (or the given) devices.

    With a tuple `axis_name`, builds an N-D mesh; `axis_sizes` gives the
    shape (required unless len(axis_name) == 1).
    """
    if devices is None:
        devices = jax.devices()
    arr = np.asarray(devices)
    if isinstance(axis_name, tuple):
        if len(axis_name) > 1:
            if axis_sizes is None:
                # Default: all devices on the first axis (e.g. when a
                # layer serialized from a 2-D mesh is rebuilt without an
                # explicit mesh).
                axis_sizes = (len(arr),) + (1,) * (len(axis_name) - 1)
            arr = arr.reshape(axis_sizes)
        return Mesh(arr, axis_name)
    return Mesh(arr, (axis_name,))


def axis_size(mesh: Mesh, axis_name: str | tuple[str, ...]) -> int:
    """Total number of shards named by `axis_name` (product for tuples)."""
    if isinstance(axis_name, tuple):
        out = 1
        for a in axis_name:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis_name]


def batch_sharding(
    mesh: Mesh, axis_name: str | tuple[str, ...] = DATA_AXIS
) -> NamedSharding:
    """Shard dim 0 (batch) over the mesh axis (or axes)."""
    return NamedSharding(mesh, P(axis_name))


def table_sharding(
    mesh: Mesh, axis_name: str | tuple[str, ...] = DATA_AXIS
) -> NamedSharding:
    """Row-shard dim 0 (vocabulary) over the mesh axis (or axes)."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_batch(
    mesh: Mesh, batch: Any, axis_name: str | tuple[str, ...] = DATA_AXIS
) -> Any:
    """Device-put a host batch, sharding dim 0 of every leaf."""
    sharding = batch_sharding(mesh, axis_name)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), batch
    )


def replicate(mesh: Mesh, tree: Any) -> Any:
    sharding = replicated(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding)
        if hasattr(x, "shape")
        else x,
        tree,
    )
