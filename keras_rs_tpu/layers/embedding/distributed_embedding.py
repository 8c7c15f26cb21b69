"""DistributedEmbedding: the user-facing sharded embedding layer.

JAX rebuild of the reference's flagship layer
(keras_rs/src/layers/embedding/base_distributed_embedding.py and
jax/distributed_embedding.py): nested feature structures, per-table
placement dispatch ("sharded" over the mesh vs "default_device"
EmbedReduce), table sharing by TableConfig identity, auto table stacking,
host-side `preprocess`, table import/export, and input-stats tracking for
capacity auto-growth (`update_stats` parity).

Usage:
    layer = DistributedEmbedding(feature_configs, mesh=mesh, key=key)
    pre = layer.preprocess(inputs, weights)          # host, per batch
    activations = layer(pre)                         # inside jit
Training integrates via keras_rs_tpu.training: the sharded table states
are `Overwrite`-wrapped so their fused in-kernel optimizer updates flow
through the standard train step.
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from keras_rs_tpu.core import initializers as init_lib
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.layers.embedding.config import FeatureConfig, TableConfig
from keras_rs_tpu.layers.embedding.embed_reduce import (
    EmbedReduce,
    QuantizedEmbedReduce,
)
from keras_rs_tpu.layers.embedding.lookup import (
    init_stack_state,
    split_activations,
    stack_lookup,
)
from keras_rs_tpu.layers.embedding.device_preprocessing import (
    DeviceStats,
    preprocess_stack_device,
)
from keras_rs_tpu.layers.embedding.preprocessing import (
    InputStats,
    preprocess_stack,
)
from keras_rs_tpu.layers.embedding.stacking import (
    build_stacks,
    gather_table,
    init_stack_table,
    scatter_table,
)
from keras_rs_tpu.parallel import mesh as mesh_lib
from keras_rs_tpu.training.train_state import Overwrite

PREPROCESSED_KEY = "__keras_rs_tpu_preprocessed__"


class _StatsBox:
    """Identity-hashed mutable stats holder.

    Stats change every batch but must not change the module's jit cache
    key, so they live behind an identity-stable box.
    """

    def __init__(self) -> None:
        self.stats: dict[str, InputStats] = {}


def _flatten_features(feature_configs: Any):
    leaves, treedef = jax.tree_util.tree_flatten(
        feature_configs,
        is_leaf=lambda x: isinstance(x, FeatureConfig),
    )
    for leaf in leaves:
        if not isinstance(leaf, FeatureConfig):
            raise ValueError(
                f"Expected FeatureConfig leaves, got {type(leaf)}."
            )
    names = [fc.name for fc in leaves]
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate feature names: {names}")
    return leaves, treedef


@export("keras_rs_tpu.layers.DistributedEmbedding")
class DistributedEmbedding(Module):
    def __init__(
        self,
        feature_configs: Any,
        *,
        key: jax.Array | None = None,
        mesh: Mesh | None = None,
        axis_name: str | tuple[str, ...] = mesh_lib.DATA_AXIS,
        table_stacking: Any = "auto",
        dtype: Any = jnp.float32,
        auto_grow: bool = True,
        comm_dtype: str | None = None,
        shard_rotation: bool = True,
    ) -> None:
        if key is None:
            key = jax.random.key(0)
        if mesh is None:
            mesh = mesh_lib.create_mesh(axis_name=axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self._table_stacking = (
            [list(g) for g in table_stacking]
            if not isinstance(table_stacking, str)
            and table_stacking is not None
            else table_stacking
        )
        self._dtype_str = np.dtype(dtype).name
        #: When True (reference parity, jax/distributed_embedding.py:
        #: 658-719), `preprocess(..., training=True)` syncs observed stats
        #: across hosts and automatically grows COO capacities + redoes
        #: the batch when limits are exceeded — no ids are ever dropped.
        #: False restores warn-only behavior (manual rebuild_capacities).
        self.auto_grow = auto_grow
        #: "bfloat16" compresses the lookup's two [B, F, dim]-sized
        #: collectives (fwd activation reduce-scatter, bwd cotangent
        #: all-gather) on the wire — half the exchange bytes per step; local
        #: accumulation stays f32 (see lookup.stack_lookup).
        if comm_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"Unsupported comm_dtype: {comm_dtype!r} (use "
                "None/'float32' or 'bfloat16')."
            )
        self.comm_dtype = comm_dtype
        #: Rotated MOD sharding (SparseCore stacking parity): table t of
        #: a stack starts at shard `t % D`, spreading hot head rows of
        #: frequency-sorted vocabularies across shards. Layouts differ
        #: across this switch, so checkpoints are not interchangeable.
        self.shard_rotation = bool(shard_rotation)
        self._feature_leaves, self._feature_treedef = _flatten_features(
            feature_configs
        )

        num_shards = mesh_lib.axis_size(mesh, axis_name)

        # Placement resolution (parity with TableConfig.placement "auto"):
        # sharded when the mesh has >1 device, else default_device.
        def resolved(table: TableConfig) -> str:
            if table.placement in ("sharded", "sparsecore"):
                return "sharded"
            if table.placement == "default_device":
                return "default_device"
            return "sharded" if num_shards > 1 else "default_device"

        sharded_fcs = [
            fc for fc in self._feature_leaves if resolved(fc.table) == "sharded"
        ]
        dense_fcs = [
            fc
            for fc in self._feature_leaves
            if resolved(fc.table) != "sharded"
        ]
        self._sharded_feature_names = tuple(fc.name for fc in sharded_fcs)

        # --- sharded path: stacks + on-device sharded init ---------------
        self.stacks = tuple(
            build_stacks(
                sharded_fcs,
                num_shards,
                stacking=table_stacking,
                shard_rotation=self.shard_rotation,
            )
            if sharded_fcs
            else ()
        )
        self._table_configs = {
            fc.table.name: fc.table for fc in self._feature_leaves
        }
        states = {}
        if self.stacks:
            keys = jax.random.split(key, len(self.stacks) + 1)
            key = keys[0]
            for stack, k in zip(self.stacks, keys[1:]):
                stack_dtype = (
                    jnp.bfloat16
                    if stack.dtype == "bfloat16"
                    else dtype
                )

                def make_state(kk, s=stack, sd=stack_dtype):
                    return init_stack_state(
                        s, init_stack_table(s, self._table_configs, kk, sd)
                    )

                # Shard every table-shaped state leaf (2-D split table
                # + slots, 1-D row-wise scalar slots, or the 3-D packed
                # table+slots array) by rows; the scalar step counter
                # replicates. Slots sharded at init matters for
                # multi-chip HBM and for checkpoint restore (template
                # shardings must be consistent).
                row_sharding = mesh_lib.table_sharding(mesh, axis_name)
                rep = mesh_lib.replicated(mesh)
                out_sh = jax.tree_util.tree_map(
                    lambda x: row_sharding if x.ndim >= 1 else rep,
                    jax.eval_shape(make_state, k),
                )
                states[stack.name] = jax.jit(
                    make_state, out_shardings=out_sh
                )(k)
        self.state = Overwrite(states)

        # --- dense path: one EmbedReduce per unique table -----------------
        dense_tables: dict[str, EmbedReduce] = {}
        feature_to_table: dict[str, str] = {}
        for fc in dense_fcs:
            t = fc.table
            feature_to_table[fc.name] = t.name
            if t.name not in dense_tables:
                key, sub = jax.random.split(key)
                dense_tables[t.name] = EmbedReduce(
                    t.vocabulary_size,
                    t.embedding_dim,
                    key=sub,
                    embeddings_initializer=init_lib.get(t.initializer),
                    combiner=t.combiner,
                    dtype=dtype,
                    name=t.name,
                )
        self.dense_tables = dense_tables
        self._dense_feature_to_table = feature_to_table
        self._stats = _StatsBox()

    # ------------------------------------------------------------------
    def preprocess(
        self,
        inputs: Any,
        weights: Any = None,
        training: bool = False,
    ) -> dict[str, Any]:
        """Host-side preprocessing: COO bucketing + device placement.

        `inputs` / `weights` are nested structures matching the layer's
        feature_configs (numpy or jax arrays, (B,) or (B, L) per feature).
        Returns a marker-wrapped dict to pass to `__call__` inside jit.
        Parity: base_distributed_embedding.py:630-738.
        """
        in_leaves = self._match_features(inputs)
        w_leaves = (
            self._match_features(weights, allow_partial=True)
            if weights is not None
            else {fc.name: None for fc in self._feature_leaves}
        )
        self._densify_ragged(in_leaves, w_leaves)
        self._flatten_high_rank(in_leaves, w_leaves)

        if training and self.auto_grow and self.stacks:
            # Capacity overflow in this pass is handled by regrowing below,
            # so the per-stack "raise max_ids..." warnings would be noise.
            import warnings as _warnings

            with _warnings.catch_warnings():
                _warnings.simplefilter("ignore")
                coos, stats_by_stack = self._preprocess_stacks(
                    in_leaves, w_leaves
                )
        else:
            coos, stats_by_stack = self._preprocess_stacks(
                in_leaves, w_leaves
            )
        if training and self.auto_grow and self.stacks:
            grown = self._maybe_grow(stats_by_stack)
            if grown:
                # Capacities grew (consistently across hosts) — redo the
                # affected stacks so nothing from THIS batch is dropped
                # (parity: jax/distributed_embedding.py:658-719).
                new_coos, new_stats = self._preprocess_stacks(
                    in_leaves, w_leaves, only=grown
                )
                coos.update(new_coos)
                stats_by_stack.update(new_stats)

        sharded = {}
        sharding = mesh_lib.batch_sharding(self.mesh, self.axis_name)
        for stack in self.stacks:
            if training:
                self._fold_stats(stack.name, stats_by_stack[stack.name])
            sharded[stack.name] = {
                k: jax.device_put(v, sharding)
                for k, v in coos[stack.name].arrays().items()
            }

        dense = {}
        batch_sharding = mesh_lib.batch_sharding(self.mesh, self.axis_name)
        for fc in self._feature_leaves:
            if fc.name in self._dense_feature_to_table:
                ids = jnp.asarray(np.asarray(in_leaves[fc.name]))
                w = w_leaves[fc.name]
                w = None if w is None else jnp.asarray(np.asarray(w))
                ids = jax.device_put(ids, batch_sharding)
                if w is not None:
                    w = jax.device_put(w, batch_sharding)
                dense[fc.name] = (ids, w)

        return {PREPROCESSED_KEY: np.zeros(()), "sharded": sharded,
                "dense": dense}

    def preprocess_on_device(
        self,
        inputs: Any,
        weights: Any = None,
        return_stats: bool = False,
    ) -> Any:
        """Jittable preprocessing: the whole COO transform runs on-device.

        Unlike `preprocess` (host-side, reference parity), this compiles
        into the surrounding XLA program, so raw int id tensors can be fed
        straight into a jitted train step — no host bottleneck, no worker
        threads (the reference needs a 4-thread loader just to keep up,
        examples/ml_perf/main.py:35-105). Bit-exact with the host path
        (tests/test_device_preprocessing.py).

        Returns the same marker-wrapped structure as `preprocess`; with
        `return_stats=True` also returns `{stack_name: DeviceStats}` for
        capacity monitoring (update_stats parity) as device scalars.

        Capacity overflow on this path silently truncates (shapes are
        static inside jit — there is no host to warn). For a device-only
        pipeline, periodically host-read the returned DeviceStats and feed
        them to `record_stats(...)`; then `update_stats()` /
        `rebuild_capacities()` work exactly as on the host path.
        """
        in_leaves = self._match_features(inputs)
        w_leaves = (
            self._match_features(weights, allow_partial=True)
            if weights is not None
            else {fc.name: None for fc in self._feature_leaves}
        )
        self._densify_ragged(in_leaves, w_leaves)
        self._flatten_high_rank(in_leaves, w_leaves)

        sharded = {}
        stats: dict[str, DeviceStats] = {}
        for stack in self.stacks:
            coo, st = preprocess_stack_device(
                stack,
                {f.name: in_leaves[f.name] for f in stack.features},
                {
                    f.name: w_leaves[f.name]
                    for f in stack.features
                    if w_leaves[f.name] is not None
                },
            )
            sharded[stack.name] = coo
            stats[stack.name] = st

        dense = {}
        for fc in self._feature_leaves:
            if fc.name in self._dense_feature_to_table:
                ids = jnp.asarray(in_leaves[fc.name])
                w = w_leaves[fc.name]
                w = None if w is None else jnp.asarray(w)
                dense[fc.name] = (ids, w)

        pre = {
            PREPROCESSED_KEY: np.zeros(()),
            "sharded": sharded,
            "dense": dense,
        }
        if return_stats:
            return pre, stats
        return pre

    def _preprocess_stacks(
        self,
        in_leaves: dict[str, Any],
        w_leaves: dict[str, Any],
        only: set[str] | None = None,
    ):
        """Runs host COO preprocessing for each (selected) stack."""
        coos: dict[str, Any] = {}
        stats: dict[str, InputStats] = {}
        for stack in self.stacks:
            if only is not None and stack.name not in only:
                continue
            coos[stack.name], stats[stack.name] = preprocess_stack(
                stack,
                {f.name: in_leaves[f.name] for f in stack.features},
                {
                    f.name: w_leaves[f.name]
                    for f in stack.features
                    if w_leaves[f.name] is not None
                },
            )
        return coos, stats

    def _fold_stats(self, stack_name: str, stats: InputStats) -> None:
        prev = self._stats.stats.get(stack_name)
        if prev is None:
            self._stats.stats[stack_name] = stats
        else:
            self._stats.stats[stack_name] = InputStats(
                max_ids_per_bucket=max(
                    prev.max_ids_per_bucket, stats.max_ids_per_bucket
                ),
                max_unique_per_shard=max(
                    prev.max_unique_per_shard, stats.max_unique_per_shard
                ),
                dropped_ids=prev.dropped_ids + stats.dropped_ids,
            )

    def record_stats(self, stats: Mapping[str, Any]) -> None:
        """Folds externally observed stats into the layer's stat store.

        For the device preprocessing pipeline: periodically host-read the
        `DeviceStats` returned by `preprocess_on_device(...,
        return_stats=True)` and pass them here, then `update_stats()` /
        `rebuild_capacities()` work exactly as with the host path.
        Accepts `{stack_name: InputStats | DeviceStats}`.
        """
        for name, st in stats.items():
            self._fold_stats(
                name,
                InputStats(
                    max_ids_per_bucket=int(st.max_ids_per_bucket),
                    max_unique_per_shard=int(st.max_unique_per_shard),
                    dropped_ids=int(st.dropped_ids),
                ),
            )

    def _maybe_grow(self, stats_by_stack: Mapping[str, InputStats]):
        """Syncs this batch's stats across hosts; grows exceeded stacks.

        Every host calls this on every training batch (so the collective
        allgather is always matched) and all hosts derive the SAME new
        capacities — the static shapes of the jitted step stay consistent
        across the slice. Returns the set of stack names that grew.
        """
        from keras_rs_tpu.parallel import multihost

        flat: dict[str, int] = {}
        for name, st in stats_by_stack.items():
            flat[f"{name}\0ids"] = st.max_ids_per_bucket
            flat[f"{name}\0unique"] = st.max_unique_per_shard
            flat[f"{name}\0dropped"] = st.dropped_ids
        synced = multihost.sync_max_stats(
            flat,
            sum_keys=frozenset(
                k for k in flat if k.endswith("\0dropped")
            ),
        )
        merged = {
            name: InputStats(
                max_ids_per_bucket=synced[f"{name}\0ids"],
                max_unique_per_shard=synced[f"{name}\0unique"],
                dropped_ids=synced[f"{name}\0dropped"],
            )
            for name in stats_by_stack
        }
        exceeded = {
            stack.name
            for stack in self.stacks
            if stack.name in merged
            and (
                merged[stack.name].max_ids_per_bucket
                > stack.max_ids_per_partition
                or merged[stack.name].max_unique_per_shard
                > stack.max_unique_ids_per_shard - 1
                or merged[stack.name].dropped_ids > 0
            )
        }
        if exceeded:
            self._grow_stacks(merged, only=exceeded)
        return exceeded

    def _match_features(
        self, structure: Any, allow_partial: bool = False
    ) -> dict[str, Any]:
        """Binds an input nest to the layer's features.

        Accepted forms (anything else raises — a structurally different
        nest with a coincidentally equal leaf count must never bind
        features positionally to the wrong tables):
          * a nest with EXACTLY the feature_configs treedef;
          * a flat dict keyed by feature names (order-independent;
            with `allow_partial`, e.g. for weights, a subset is fine);
          * a bare array for a single-feature layer.
        """
        from keras_rs_tpu.data.ragged import Ragged
        from keras_rs_tpu.data.sparse_utils import is_bcoo

        def is_leaf(x):
            return (
                x is None
                or isinstance(x, (np.ndarray, jax.Array, Ragged))
                or is_bcoo(x)
            )

        names = [fc.name for fc in self._feature_leaves]
        if isinstance(structure, Mapping) and all(
            is_leaf(v) for v in structure.values()
        ):
            unknown = set(structure) - set(names)
            missing = set(names) - set(structure)
            if not unknown and (not missing or allow_partial):
                return {
                    name: structure.get(name) for name in names
                }
            # Keys don't line up with feature names — fall through to the
            # treedef comparison below: a dict whose keys differ from the
            # FeatureConfig.name values but whose STRUCTURE exactly
            # matches feature_configs (e.g. configs keyed "a"/"b" with
            # names "movie"/"user") is still an unambiguous binding.

        leaves, treedef = jax.tree_util.tree_flatten(
            structure, is_leaf=is_leaf
        )
        if treedef != self._feature_treedef and not (
            len(names) == 1
            and len(leaves) == 1
            and jax.tree_util.treedef_is_leaf(treedef)
        ):
            if isinstance(structure, Mapping):
                unknown = set(structure) - set(names)
                missing = set(names) - set(structure)
                raise ValueError(
                    "Feature inputs keyed by name do not match the "
                    f"layer's features (unknown {sorted(unknown)}, "
                    f"missing {sorted(missing)}) and their structure "
                    f"does not match feature_configs either: expected "
                    f"{self._feature_treedef}, got {treedef}."
                )
            raise ValueError(
                "Feature inputs do not match the layer's feature_configs "
                f"structure. Expected {self._feature_treedef} (or a flat "
                f"dict keyed by feature names {names}), got {treedef}."
            )
        return {name: leaf for name, leaf in zip(names, leaves)}

    def _flatten_high_rank(
        self, in_leaves: dict[str, Any], w_leaves: dict[str, Any]
    ) -> None:
        """Rank>2 features -> (flat_batch, valence) in place.

        Leading axes are fused into one batch axis (the sharded lookup
        and EmbedReduce are rank-2 engines); `__call__` restores each
        feature's declared output_shape. Parity with the reference's
        higher-rank densification (base_distributed_embedding.py:31-92).
        """
        for fc in self._feature_leaves:
            x = in_leaves[fc.name]
            if x is None:
                continue
            # Keep the ACTUAL last-axis length for reduced features: a
            # densified ragged input may be narrower than the configured
            # valence (capacities, not shapes, bound the id count).
            target = (
                (fc.batch_size, x.shape[-1])
                if fc.reduced
                else (fc.batch_size,)
            )
            if tuple(x.shape) != target:
                in_leaves[fc.name] = x.reshape(target)
            w = w_leaves.get(fc.name)
            if w is not None and tuple(w.shape) != target:
                w_leaves[fc.name] = w.reshape(target)

    @staticmethod
    def _densify_ragged(
        in_leaves: dict[str, Any], w_leaves: dict[str, Any]
    ) -> None:
        """Ragged inputs -> padded ids + synthesized weights, in place.

        Parity with the reference's ragged densification
        (base_distributed_embedding.py:31-92): 0/1 validity weights,
        multiplied into any explicit per-id weights.
        """
        from keras_rs_tpu.data.ragged import Ragged

        from keras_rs_tpu.data.sparse_utils import bcoo_densify, is_bcoo

        for name, leaf in list(in_leaves.items()):
            if is_bcoo(leaf):
                # Sparse ids -> padded dense + 0/1 mask (reference
                # semantics, embed_reduce.py:36-87): masked positions
                # read row 0 but contribute nothing.
                ids, mask = bcoo_densify(leaf)
                w = w_leaves.get(name)
                if w is not None:
                    if is_bcoo(w):
                        w = w.todense()
                    mask = mask * np.asarray(w, np.float32)
                in_leaves[name] = ids
                w_leaves[name] = mask
            elif isinstance(leaf, Ragged):
                ids, mask = leaf.to_padded()
                w = w_leaves.get(name)
                if isinstance(w, Ragged):
                    # Per-id ragged weights: densify on the SAME grid.
                    if not np.array_equal(
                        np.asarray(w.row_lengths),
                        np.asarray(leaf.row_lengths),
                    ):
                        raise ValueError(
                            f"Feature {name!r}: Ragged weights "
                            "row_lengths must equal the ids row_lengths."
                        )
                    wv, _ = w.to_padded(max_length=ids.shape[1])
                    mask = mask * np.asarray(wv, np.float32)
                elif w is not None:
                    mask = mask * np.asarray(w, np.float32)
                in_leaves[name] = ids
                w_leaves[name] = mask
            elif isinstance(w_leaves.get(name), Ragged):
                raise ValueError(
                    f"Feature {name!r}: Ragged weights require Ragged "
                    "ids (shapes must align)."
                )

    # ------------------------------------------------------------------
    def has_sharded_tables(self) -> bool:
        """Whether any table resolved to the mesh-sharded placement.

        Parity: `DistributedEmbedding.has_sparsecores()`
        (base_distributed_embedding.py:940-988) — there the question is
        "is SparseCore hardware driving lookups"; here it is "are lookups
        running through the sharded stack engine".
        """
        return bool(self.stacks)

    def update_stats(self, warn: bool = True) -> dict[str, InputStats]:
        """Cross-host merge of observed preprocessing stats (max of
        capacity watermarks, sum of dropped counts), with capacity
        warnings.

        Parity: the reference's `update_stats` path allgathers input
        stats over DCN and re-preprocesses when limits grew
        (jax/distributed_embedding.py:658-719). With the default
        `auto_grow=True` this happens automatically inside
        `preprocess(..., training=True)`; this method is the manual path:
        call it after some training steps (host pipeline) or after
        `record_stats` (device pipeline, see `preprocess_on_device`),
        then `rebuild_capacities(synced=...)` if anything exceeded its
        configured limit.
        """
        from keras_rs_tpu.parallel import multihost

        synced: dict[str, InputStats] = {}
        for stack in self.stacks:
            st = self._stats.stats.get(stack.name)
            if st is None:
                continue
            agg = multihost.sync_max_stats(
                {
                    "max_ids_per_bucket": st.max_ids_per_bucket,
                    "max_unique_per_shard": st.max_unique_per_shard,
                    "dropped_ids": st.dropped_ids,
                }
            )
            synced[stack.name] = InputStats(**agg)
            if warn and (
                agg["max_ids_per_bucket"] > stack.max_ids_per_partition
                or agg["max_unique_per_shard"]
                > stack.max_unique_ids_per_shard - 1
                or agg["dropped_ids"]
            ):
                import warnings

                warnings.warn(
                    f"Stack {stack.name!r}: observed stats exceed "
                    f"capacities (ids {agg['max_ids_per_bucket']}/"
                    f"{stack.max_ids_per_partition}, unique "
                    f"{agg['max_unique_per_shard']}/"
                    f"{stack.max_unique_ids_per_shard - 1}, dropped "
                    f"{agg['dropped_ids']}). Call rebuild_capacities().",
                    stacklevel=2,
                )
        return synced

    def rebuild_capacities(
        self,
        margin: float = 1.25,
        synced: Mapping[str, InputStats] | None = None,
    ) -> bool:
        """Grows per-stack COO capacities to observed cross-host maxima.

        Capacities are static shapes of the preprocessed arrays only —
        tables, optimizer slots, and the step counter carry over
        untouched. Returns True if anything changed (then re-preprocess
        upcoming batches; old preprocessed batches remain valid but jit
        will recompile for the new shapes). Pass `synced` stats (e.g. the
        return of a prior `update_stats()`) to skip the internal sync.
        """
        if synced is None:
            synced = self.update_stats(warn=False)
        return self._grow_stacks(synced, margin=margin)

    def _grow_stacks(
        self,
        synced: Mapping[str, InputStats],
        only: set[str] | None = None,
        margin: float = 1.25,
    ) -> bool:
        import dataclasses
        import math

        changed = False
        new_stacks = []
        for stack in self.stacks:
            st = synced.get(stack.name)
            if st is None or (only is not None and stack.name not in only):
                new_stacks.append(stack)
                continue
            C = max(
                stack.max_ids_per_partition,
                int(math.ceil(st.max_ids_per_bucket * margin)),
            )
            U = max(
                stack.max_unique_ids_per_shard,
                int(math.ceil(st.max_unique_per_shard * margin)) + 1,
            )
            if st.dropped_ids:
                # Entries were dropped BEFORE dedup, so the observed
                # unique count is an underestimate. A shard receives at
                # most D * C entries — size U for the worst case so one
                # rebuild converges (the reference instead loops
                # re-preprocessing, jax/distributed_embedding.py:658-719).
                U = max(U, stack.num_shards * C + 1)
            if (C, U) != (
                stack.max_ids_per_partition,
                stack.max_unique_ids_per_shard,
            ):
                changed = True
                stack = dataclasses.replace(
                    stack,
                    max_ids_per_partition=C,
                    max_unique_ids_per_shard=U,
                )
            new_stacks.append(stack)
        self.stacks = tuple(new_stacks)
        return changed

    # ------------------------------------------------------------------
    def __call__(
        self, inputs: Any, weights: Any = None, training: bool = False
    ) -> Any:
        """Looks up embeddings; accepts raw inputs or preprocessed ones."""
        if not (isinstance(inputs, dict) and PREPROCESSED_KEY in inputs):
            inputs = self.preprocess(inputs, weights, training)

        acts_by_name: dict[str, jax.Array] = {}
        for stack in self.stacks:
            acts = stack_lookup(
                stack,
                self.mesh,
                self.axis_name,
                self.state.value[stack.name],
                inputs["sharded"][stack.name],
                comm_dtype=self.comm_dtype,
            )
            acts_by_name.update(split_activations(stack, acts))
        for name, (ids, w) in inputs["dense"].items():
            table = self.dense_tables[self._dense_feature_to_table[name]]
            acts_by_name[name] = table(ids, w)

        # Restore each feature's declared (possibly rank>2) output shape
        # from the flattened (batch, dim) lookup result.
        outs = []
        for fc in self._feature_leaves:
            act = acts_by_name[fc.name]
            out_shape = tuple(fc.output_shape[:-1]) + (act.shape[-1],)
            if tuple(act.shape) != out_shape:
                act = act.reshape(out_shape)
            outs.append(act)
        return jax.tree_util.tree_unflatten(self._feature_treedef, outs)

    # ------------------------------------------------------------------
    def get_embedding_tables(self) -> dict[str, np.ndarray]:
        """Unstacked, unsharded [vocab, dim] tables by name.

        Parity: jax/distributed_embedding.py:819-840.
        """
        out = {}
        for stack in self.stacks:
            stacked = np.asarray(self.state.value[stack.name]["table"])
            for ts in stack.tables:
                out[ts.name] = gather_table(stack, stacked, ts.name)
        for name, layer in self.dense_tables.items():
            out[name] = np.asarray(layer.embeddings)
        return out

    def set_embedding_tables(
        self, tables: Mapping[str, np.ndarray]
    ) -> None:
        """Imports [vocab, dim] values (host -> sharded device layout)."""
        for stack in self.stacks:
            present = [t for t in stack.tables if t.name in tables]
            if not present:
                continue
            stacked = np.asarray(self.state.value[stack.name]["table"])
            for ts in present:
                stacked = scatter_table(
                    stack, stacked, ts.name, np.asarray(tables[ts.name])
                )
            self.state.value[stack.name]["table"] = jax.device_put(
                stacked,
                mesh_lib.table_sharding(self.mesh, self.axis_name),
            )
        for name, layer in self.dense_tables.items():
            if name in tables:
                layer.embeddings = jnp.asarray(tables[name])

    @property
    def input_stats(self) -> dict[str, InputStats]:
        """Observed preprocessing stats (update_stats parity)."""
        return dict(self._stats.stats)

    def freeze(self, quantize: str | None = None) -> "FrozenEmbedding":
        """Inference-only snapshot: tables without optimizer slots.

        The training state carries 2-3x the table bytes in optimizer
        slots (Adagrad/Adam/FTRL); a serving process needs none of it.
        Returns a lightweight module holding each logical [vocab, dim]
        table once, looking features up with plain gathers + combiner
        reduction — jit/AOT/export friendly (serving.py), no mesh or
        preprocessing required. For tables too large for one host,
        keep serving through the sharded layer itself instead.

        `quantize="int8"` stores each table int8 with per-row scales
        (ops/quant.py): 4x less serving HBM than f32 at <=absmax/254
        per-element error — serve 4x the vocabulary per chip.
        """
        return FrozenEmbedding(self, quantize=quantize)

    def serving_copy(self) -> "DistributedEmbedding":
        """MESH-SHARDED inference twin without optimizer slots.

        `freeze()` collects every table onto one device — right for
        host-scale serving, impossible when the tables only exist
        sharded. This builds a new DistributedEmbedding over the SAME
        mesh and stack grouping but with the slot-free SGD optimizer,
        and transplants each stack's table shard-locally (the packed
        [R, stride, dim] state is sliced to its table plane; split and
        bit-packed tables transfer as-is) — no host gather, no
        unsharded intermediate. Serving HBM drops to the table bytes
        alone (1/2-1/3 of the Adagrad/Adam training state). The copy
        serves through the normal preprocess + __call__ path; training
        it would train plain SGD from the copied tables.
        """
        import dataclasses

        new_tables: dict[str, TableConfig] = {}

        def conv(t: TableConfig) -> TableConfig:
            if t.name not in new_tables:
                new_tables[t.name] = dataclasses.replace(
                    t, optimizer="sgd"
                )
            return new_tables[t.name]

        leaves = [
            dataclasses.replace(fc, table=conv(fc.table))
            for fc in self._feature_leaves
        ]
        configs = jax.tree_util.tree_unflatten(
            self._feature_treedef, leaves
        )
        # Pin the old stack grouping: "auto" groups by optimizer+dim and
        # the optimizer swap could merge groups, changing row layouts.
        stacking = (
            [[ts.name for ts in s.tables] for s in self.stacks]
            if self.stacks
            else "never"
        )
        new = DistributedEmbedding(
            configs,
            mesh=self.mesh,
            axis_name=self.axis_name,
            table_stacking=stacking,
            dtype=self._dtype_str,
            auto_grow=self.auto_grow,
        )
        states = {}
        for old_stack, new_stack in zip(self.stacks, new.stacks):
            if {t.name for t in old_stack.tables} != {
                t.name for t in new_stack.tables
            }:
                raise AssertionError(
                    "serving_copy stack grouping diverged: "
                    f"{old_stack.name} vs {new_stack.name}"
                )
            old = self.state.value[old_stack.name]
            table = (
                old["table"][:, 0]
                if old_stack.packed_state
                else old["table"]
            )
            states[new_stack.name] = {
                "table": table,
                "slots": {},
                "step": old["step"],
            }
        new.state = Overwrite(states)
        # default_device tables: share the EmbedReduce modules (same
        # arrays — no copy, no extra HBM).
        new.dense_tables = dict(self.dense_tables)
        return new

    # ------------------------------------------------------------------
    def get_config(self) -> dict[str, Any]:
        # Dedup shared tables by index (parity with
        # base_distributed_embedding.py:1053-1139).
        tables: list[TableConfig] = []
        table_index: dict[int, int] = {}
        feature_specs = []
        for fc in self._feature_leaves:
            tid = id(fc.table)
            if tid not in table_index:
                table_index[tid] = len(tables)
                tables.append(fc.table)
            feature_specs.append(
                {
                    "name": fc.name,
                    "table_index": table_index[tid],
                    "input_shape": tuple(fc.input_shape),
                    "output_shape": tuple(fc.output_shape),
                }
            )
        return {
            "tables": [t.get_config() for t in tables],
            "features": feature_specs,
            "axis_name": (
                list(self.axis_name)
                if isinstance(self.axis_name, tuple)
                else self.axis_name
            ),
            "table_stacking": self._table_stacking,
            "dtype": self._dtype_str,
            "auto_grow": self.auto_grow,
            "comm_dtype": self.comm_dtype,
            "shard_rotation": self.shard_rotation,
        }

    @classmethod
    def from_config(
        cls,
        config: dict[str, Any],
        *,
        mesh: Mesh | None = None,
        key: jax.Array | None = None,
    ) -> "DistributedEmbedding":
        """Rebuilds the layer from `get_config` output.

        Restores the full constructor state — shared-table dedup,
        table_stacking, dtype, auto_grow, and mesh axis names (parity:
        base_distributed_embedding.py:1053-1139). The mesh itself is
        runtime state: by default a fresh mesh over the available devices
        is built with the serialized axis names; pass `mesh=` to place
        the layer on an existing mesh. Table VALUES come from
        checkpoints (`set_embedding_tables` / Orbax state restore), not
        from the config.
        """
        tables = [
            TableConfig.from_config(c) for c in config["tables"]
        ]
        fcs = [
            FeatureConfig(
                name=f["name"],
                table=tables[f["table_index"]],
                input_shape=tuple(f["input_shape"]),
                output_shape=tuple(f["output_shape"]),
            )
            for f in config["features"]
        ]
        axis_name = config.get("axis_name", "data")
        if isinstance(axis_name, list):
            axis_name = tuple(axis_name)
        return cls(
            fcs,
            axis_name=axis_name,
            mesh=mesh,
            key=key,
            table_stacking=config.get("table_stacking", "auto"),
            dtype=np.dtype(config.get("dtype", "float32")),
            auto_grow=config.get("auto_grow", True),
            comm_dtype=config.get("comm_dtype"),
            shard_rotation=config.get("shard_rotation", True),
        )


class FrozenEmbedding(Module):
    """Slot-free inference view of a `DistributedEmbedding`.

    Accepts the same raw feature structures as the training layer
    (dense ids, Ragged, BCOO; rank>2 per the FeatureConfig contract) and
    returns the same activation structure — computed with plain
    per-table gathers, no COO preprocessing, no mesh, no optimizer
    state. Built via `DistributedEmbedding.freeze()`.
    """

    def __init__(
        self,
        layer: DistributedEmbedding,
        quantize: str | None = None,
    ) -> None:
        if quantize not in (None, "int8", "int8_packed", "int8_fused"):
            raise ValueError(
                f"Unsupported `quantize`: {quantize!r} (use None, "
                "'int8', 'int8_packed', or 'int8_fused')."
            )
        tables = {
            name: jnp.asarray(v)
            for name, v in layer.get_embedding_tables().items()
        }
        self._feature_leaves = list(layer._feature_leaves)
        self._feature_treedef = layer._feature_treedef
        self._feature_to_table = {
            fc.name: fc.table.name for fc in self._feature_leaves
        }
        self._combiners = {
            fc.name: fc.table.combiner for fc in self._feature_leaves
        }
        # Pre-built per-feature EmbedReduce modules: constructing them
        # per __call__ would cost Python object churn and a retrace
        # hazard in the serving hot path this class exists for. The
        # table arrays live ONLY here (shared-table features reference
        # the same jax.Array, which costs no extra HBM); `tables` below
        # derives the export view so the pytree holds each buffer once
        # per feature, not once per feature plus once per table.
        if quantize in ("int8", "int8_packed", "int8_fused"):
            # Quantize each TABLE once; shared-table features reference
            # the same (q, scale) arrays. "int8_packed" selects the
            # group-packed word-typed gather layout (embed_reduce.py).
            from keras_rs_tpu.ops.quant import quantize_rows_int8

            qtables = {
                name: quantize_rows_int8(v)
                for name, v in tables.items()
            }
            if quantize == "int8_fused":
                # Scale rides the data gather: 8 rows + 8 scales per
                # group row, no separate scale gather.
                from keras_rs_tpu.ops.quant import pack_rows_int8_fused

                # dim-128 tables only (one lane tile per byte plane);
                # other widths keep the plain rows layout.
                ftables = {
                    name: (
                        pack_rows_int8_fused(q, scale.reshape(-1)),
                        q.shape[0],
                    )
                    for name, (q, scale) in qtables.items()
                    if q.shape[1] == 128
                }
                self._reducers = {
                    fc.name: (
                        QuantizedEmbedReduce._from_fused(
                            *ftables[self._feature_to_table[fc.name]],
                            combiner=self._combiners[fc.name],
                            name=fc.name,
                        )
                        if self._feature_to_table[fc.name] in ftables
                        else QuantizedEmbedReduce(
                            *qtables[self._feature_to_table[fc.name]],
                            combiner=self._combiners[fc.name],
                            name=fc.name,
                        )
                    )
                    for fc in self._feature_leaves
                }
            elif quantize == "int8_packed":
                from keras_rs_tpu.ops.quant import pack_rows_int8_groups

                ptables = {
                    name: (
                        pack_rows_int8_groups(q),
                        scale.reshape(-1),
                        q.shape[0],
                    )
                    for name, (q, scale) in qtables.items()
                }
                self._reducers = {
                    fc.name: QuantizedEmbedReduce._from_packed(
                        *ptables[self._feature_to_table[fc.name]],
                        combiner=self._combiners[fc.name],
                        name=fc.name,
                    )
                    for fc in self._feature_leaves
                }
            else:
                self._reducers = {
                    fc.name: QuantizedEmbedReduce(
                        *qtables[self._feature_to_table[fc.name]],
                        combiner=self._combiners[fc.name],
                        name=fc.name,
                    )
                    for fc in self._feature_leaves
                }
        else:
            self._reducers = {
                fc.name: EmbedReduce(
                    tables[self._feature_to_table[fc.name]].shape[0],
                    tables[self._feature_to_table[fc.name]].shape[1],
                    table=tables[self._feature_to_table[fc.name]],
                    combiner=self._combiners[fc.name],
                    name=fc.name,
                )
                for fc in self._feature_leaves
            }

    @property
    def tables(self) -> dict[str, jax.Array]:
        """Logical [vocab, dim] table per table name (export view)."""
        return {
            self._feature_to_table[name]: er.embeddings
            for name, er in self._reducers.items()
        }

    def __call__(self, inputs: Any, weights: Any = None) -> Any:
        in_leaves = DistributedEmbedding._match_features(
            self, inputs
        )
        w_leaves = (
            DistributedEmbedding._match_features(
                self, weights, allow_partial=True
            )
            if weights is not None
            else {fc.name: None for fc in self._feature_leaves}
        )
        DistributedEmbedding._densify_ragged(in_leaves, w_leaves)
        DistributedEmbedding._flatten_high_rank(
            self, in_leaves, w_leaves
        )
        outs = []
        for fc in self._feature_leaves:
            ids = jnp.asarray(in_leaves[fc.name])
            w = w_leaves.get(fc.name)
            er = self._reducers[fc.name]
            act = er(ids, None if w is None else jnp.asarray(w))
            out_shape = tuple(fc.output_shape[:-1]) + (act.shape[-1],)
            if tuple(act.shape) != out_shape:
                act = act.reshape(out_shape)
            outs.append(act)
        return jax.tree_util.tree_unflatten(self._feature_treedef, outs)
