"""Table stacking and MOD-sharded layout.

Rebuild of the concepts in jax-tpu-embedding's table stacking used by the
reference (keras_rs/src/layers/embedding/jax/distributed_embedding.py:
413-458): many small tables are fused into one row-sharded buffer so the
lookup/update kernels launch once per *stack* instead of once per table.

Layout (for a mesh of D shards):
  * each table's vocabulary is padded up to a multiple of D;
  * global row r of table t lives on shard `(r + rot_t) % D` at local
    slot `offset_t + r // D` (rotated MOD sharding: parity with the
    reference's "MOD" strategy, jax/embedding_lookup.py:78-93, plus the
    per-table shard rotation of SparseCore table stacking — SURVEY §7
    hard part (c). rot_t = the table's index within its stack, so the
    hot low-id head rows of frequency-sorted vocabularies land on a
    DIFFERENT shard per table instead of all piling onto shard 0 —
    without rotation the per-shard unique-row/update load skews badly
    on power-law data);
  * per-shard buffers from all tables in the stack are concatenated, plus
    one trailing "sink" row that absorbs padding-entry scatter traffic;
  * the stacked global array has shape [D * rows_per_shard, stack_dim]
    with rows_per_shard = sum_t(padded_vocab_t / D) + 1, sharded
    contiguously over dim 0 (shard s owns block s) — so NamedSharding
    P('data', None) puts exactly the MOD-interleaved rows of every table
    on the right device.
  * stack_dim = max table dim, padded to a multiple of 8 (f32 sublane);
    features slice [:, :dim] of their activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core import initializers as init_lib
from keras_rs_tpu.layers.embedding import optimizers as opt_lib
from keras_rs_tpu.layers.embedding.config import FeatureConfig, TableConfig


from keras_rs_tpu.utils.shape_utils import round_up as _round_up


@dataclasses.dataclass(frozen=True)
class StackedTableSpec:
    """Static layout of one table inside a stack."""

    name: str
    vocabulary_size: int
    embedding_dim: int
    padded_vocab: int  # multiple of num_shards
    local_offset: int  # first local slot of this table on every shard
    combiner: str
    rotation: int = 0  # shard rotation: row r lives on (r + rotation) % D


@dataclasses.dataclass(frozen=True)
class StackedFeatureSpec:
    """Static binding of one feature to its stack."""

    name: str
    table_name: str
    stack_name: str
    feature_index: int  # block index within the stack's sample space
    batch_size: int  # global batch
    valence: int
    embedding_dim: int


@dataclasses.dataclass(frozen=True)
class TableStack:
    """One fused, sharded table group."""

    name: str
    num_shards: int
    stack_dim: int
    rows_per_shard: int  # includes the trailing sink row
    tables: tuple[StackedTableSpec, ...]
    features: tuple[StackedFeatureSpec, ...]
    optimizer: opt_lib.EmbeddingOptimizer
    max_ids_per_partition: int  # capacity C of each (src, dst) bucket
    max_unique_ids_per_shard: int  # capacity U of per-shard unique list
    dtype: str = "float32"  # storage dtype (see TableConfig.dtype)
    #: Packed state layout: the table row and its optimizer-slot rows
    #: form the [state_stride, dim] groups of one 3-D
    #: [global_rows, state_stride, dim] array, so each group is one
    #: contiguous byte range: the backward fetches table+slots with ONE
    #: block gather and writes them back with ONE unique-index scatter
    #: instead of one per stream.
    packed_state: bool = False
    #: Bit-packed state layout for bf16 stacks: the table lives as ONE
    #: uint32 [global_rows/2, dim] array, word [p, i] packing element i
    #: of logical rows (2p, 2p+1); gathers and updates move whole 32-bit
    #: words (ops/bitpack.py). rows_per_shard is kept EVEN with the sink row given a dead pair
    #: partner, so pairing is shard-local and sink-duplicate writes stay
    #: benign.
    bitpacked_state: bool = False

    @property
    def state_stride(self) -> int:
        """Rows per logical row in the state array (1 + #slots if packed)."""
        return (
            1 + len(self.optimizer.slot_names) if self.packed_state else 1
        )

    @property
    def sink_slot(self) -> int:
        return self.rows_per_shard - 1

    @property
    def construction_entries(self) -> int:
        """Total id slots in CONSTRUCTION order (features concatenated,
        each sample-major (B, valence) — invalid ids included)."""
        return sum(f.batch_size * f.valence for f in self.features)

    @property
    def construction_fwd(self) -> bool:
        """Whether the D == 1 construction-order forward applies.

        At one shard, no entry routing happens and the forward can
        consume entries in construction order, where the segment
        structure is STATIC (feature f's entries are a contiguous
        [B, valence_f] block): the combiner reduce becomes a dense
        per-feature reshape-sum instead of a 1.4M-entry segment-sum
        (tools/probe_preproc_ops.py times both). Requires every entry to fit the bucket (no drop semantics in
        construction order): N <= C, which also guarantees the sorted
        send buffers dropped nothing.
        """
        return (
            self.num_shards == 1
            and self.construction_entries <= self.max_ids_per_partition
        )

    @property
    def global_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def num_features(self) -> int:
        return len(self.features)

    @property
    def batch_size(self) -> int:
        return self.features[0].batch_size

    def table_spec(self, name: str) -> StackedTableSpec:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)


def _optimizer_key(table: TableConfig) -> str:
    opt = opt_lib.get(table.optimizer)
    try:
        return f"{opt.name}:{sorted(opt.get_config().items())}"
    except ValueError:
        # Callable learning rate: key the rest of the config by value
        # and the schedule by identity (two tables only stack when they
        # share the SAME schedule object AND all other hyperparams).
        cfg = {
            k: v
            for k, v in vars(opt).items()
            if k != "learning_rate" and not callable(v)
        }
        return (
            f"{opt.name}:{id(opt.learning_rate)}:{sorted(cfg.items())}"
        )


def build_stacks(
    feature_configs: Sequence[FeatureConfig],
    num_shards: int,
    *,
    stacking: str | Sequence[Sequence[str]] = "auto",
    shard_rotation: bool = True,
) -> list[TableStack]:
    """Groups tables into stacks and computes the sharded layout.

    `stacking`:
      * "auto": tables with the same optimizer and padded dim are fused
        (parity with jte's auto_stack_tables semantics);
      * "never": one stack per table;
      * explicit: list of lists of table names (unlisted tables get their
        own stack).

    `shard_rotation`: rotate table t's rows by `t's index within its
    stack` shards (SparseCore stacking parity) so the hot head rows of
    stacked frequency-sorted vocabularies spread across shards instead
    of all landing on shard 0. Off = plain MOD (the pre-rotation
    layout; checkpoints are layout-specific across this switch).
    """
    # Collect unique tables (by identity, like the reference's shared-table
    # handling, base_distributed_embedding.py:827-938) with their features.
    tables: list[TableConfig] = []
    table_features: dict[int, list[FeatureConfig]] = {}
    for fc in feature_configs:
        tid = id(fc.table)
        if tid not in table_features:
            tables.append(fc.table)
            table_features[tid] = []
        table_features[tid].append(fc)

    names = [t.name for t in tables]
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate table names: {names}")

    # Group tables into stacks.
    groups: list[list[TableConfig]]
    if stacking == "never":
        groups = [[t] for t in tables]
    elif stacking == "auto":
        by_key: dict[str, list[TableConfig]] = {}
        for t in tables:
            key = (
                f"{_optimizer_key(t)}|dim{_round_up(t.embedding_dim, 8)}"
                f"|{t.dtype}"
            )
            by_key.setdefault(key, []).append(t)
        groups = list(by_key.values())
    else:
        explicit = {name: i for i, g in enumerate(stacking) for name in g}
        grouped: dict[int | str, list[TableConfig]] = {}
        for t in tables:
            grouped.setdefault(explicit.get(t.name, f"solo_{t.name}"), []
                               ).append(t)
        groups = list(grouped.values())

    stacks = []
    for group in groups:
        stack_dim = max(_round_up(t.embedding_dim, 8) for t in group)
        opts = {_optimizer_key(t) for t in group}
        if len(opts) != 1:
            raise ValueError(
                "All tables in a stack must share the same optimizer; got "
                f"{[t.name for t in group]}."
            )
        if len({t.dtype for t in group}) != 1:
            raise ValueError(
                "All tables in a stack must share the same dtype; got "
                f"{[t.name for t in group]}."
            )
        specs: list[StackedTableSpec] = []
        offset = 0
        for ti, t in enumerate(group):
            padded = _round_up(t.vocabulary_size, num_shards)
            specs.append(
                StackedTableSpec(
                    name=t.name,
                    vocabulary_size=t.vocabulary_size,
                    embedding_dim=t.embedding_dim,
                    padded_vocab=padded,
                    local_offset=offset,
                    combiner=t.combiner,
                    rotation=(ti % num_shards) if shard_rotation else 0,
                )
            )
            offset += padded // num_shards

        feature_specs: list[StackedFeatureSpec] = []
        stack_name = "_".join(t.name for t in group)
        if len(stack_name) > 64:
            # Truncate but keep uniqueness (states/preprocessed inputs
            # are keyed by stack name).
            import hashlib

            digest = hashlib.sha1(
                stack_name.encode()
            ).hexdigest()[:8]
            stack_name = f"{stack_name[:55]}_{digest}"
        batch_sizes = set()
        for t in group:
            for fc in table_features[id(t)]:
                batch_sizes.add(fc.batch_size)
                feature_specs.append(
                    StackedFeatureSpec(
                        name=fc.name,
                        table_name=t.name,
                        stack_name=stack_name,
                        feature_index=len(feature_specs),
                        batch_size=fc.batch_size,
                        valence=fc.valence,
                        embedding_dim=t.embedding_dim,
                    )
                )
        if len(batch_sizes) != 1:
            raise ValueError(
                "All features of stacked tables must share the same global "
                f"batch size; got {sorted(batch_sizes)} in stack "
                f"{stack_name}."
            )
        if batch_sizes.pop() % num_shards != 0:
            raise ValueError(
                "Global batch size must be divisible by the number of "
                f"shards ({num_shards})."
            )

        optimizer = opt_lib.get(group[0].optimizer)
        n_slots = len(optimizer.slot_names)
        # Packed (row-interleaved table+slots) layout: f32 state (slots
        # are f32, so a bf16 table cannot share the buffer) with
        # 128-wide rows and at most 512 floats per [stride, dim] group.
        # These bounds are the layout rule as first chosen; whether the
        # packed layout beats the split one on this device is an open
        # measurement (ROADMAP S4).
        packed = (
            group[0].dtype == "float32"
            and n_slots >= 1
            and not optimizer.rowwise_slots  # scalar slots can't be rows
            and stack_dim % 128 == 0
            and (1 + n_slots) * stack_dim <= 512
        )
        # Bit-packed 32-bit-word layout for 128-wide bf16 stacks
        # (ops/bitpack.py).
        bitpacked = (
            group[0].dtype == "bfloat16"
            and stack_dim % 128 == 0
            and stack_dim <= 128
        )
        rows_per_shard = offset + 1  # + sink row
        if bitpacked:
            # Even row count, and the sink row's pair partner is a dead
            # padding row no update ever targets — required for the
            # benign-duplicate merge contract (bitpack.merge_updated_rows).
            rows_per_shard = _round_up(offset, 2) + 2
        stacks.append(
            TableStack(
                name=stack_name,
                num_shards=num_shards,
                stack_dim=stack_dim,
                rows_per_shard=rows_per_shard,
                tables=tuple(specs),
                features=tuple(feature_specs),
                optimizer=optimizer,
                max_ids_per_partition=max(
                    t.max_ids_per_partition for t in group
                ),
                max_unique_ids_per_shard=(
                    max(t.max_unique_ids_per_partition for t in group)
                    * num_shards
                ),
                dtype=group[0].dtype,
                packed_state=packed,
                bitpacked_state=bitpacked,
            )
        )
    return stacks


def init_stack_table(
    stack: TableStack,
    table_configs: dict[str, TableConfig],
    key: jax.Array,
    dtype: Any = jnp.float32,
) -> jax.Array:
    """Materializes the stacked global array [D * rows_per_shard, dim].

    Each table is initialized with its own initializer over its full
    (padded) vocabulary, then MOD-interleaved into the stacked layout:
    T.reshape(V/D, D, dim).transpose(1, 0, 2) puts shard-s rows together.
    Intended to be called under jit with an out_sharding of P(axis, None).
    """
    D = stack.num_shards
    parts = []
    keys = jax.random.split(key, len(stack.tables))
    for t, k in zip(stack.tables, keys):
        cfg = table_configs[t.name]
        initializer = init_lib.get(cfg.initializer)
        # Initialize at the TABLE's true dim so fan-based initializers
        # (e.g. the default VarianceScaling fan_out) see embedding_dim,
        # not the stack's padded dim; zero-pad columns afterwards.
        full = initializer(k, (t.padded_vocab, t.embedding_dim), dtype)
        if t.embedding_dim < stack.stack_dim:
            full = jnp.pad(
                full,
                ((0, 0), (0, stack.stack_dim - t.embedding_dim)),
            )
        # Zero padded vocab rows.
        if t.padded_vocab > t.vocabulary_size:
            row_mask = (
                jnp.arange(t.padded_vocab) < t.vocabulary_size
            ).astype(dtype)
            full = full * row_mask[:, None]
        part = full.reshape(
            t.padded_vocab // D, D, stack.stack_dim
        ).transpose(1, 0, 2)
        if t.rotation:
            # Rotated MOD: shard e holds rows l*D + (e - rot) % D, i.e.
            # the unrotated shard axis rolled forward by rot.
            part = jnp.roll(part, t.rotation, axis=0)
        parts.append(part)
    # Trailing zero rows: dead padding (bitpacked parity pad + the
    # sink's dead pair partner) and the sink itself — everything past
    # the tables' local offsets.
    n_tail = stack.rows_per_shard - sum(
        t.padded_vocab // D for t in stack.tables
    )
    tail = jnp.zeros((D, n_tail, stack.stack_dim), dtype)
    stacked = jnp.concatenate(parts + [tail], axis=1)
    return stacked.reshape(stack.global_rows, stack.stack_dim)


def gather_table(
    stack: TableStack, stacked: jax.Array | np.ndarray, table_name: str
) -> np.ndarray:
    """Unstacks + unshards one table back to [vocab, dim] (host-side).

    `stacked` is the stack's state array: [global_rows, dim] for the
    split layout, [global_rows * state_stride, dim] for the packed
    layout (table rows at stride intervals). Parity with
    `get_embedding_tables` (jax/distributed_embedding.py:819-840).
    """
    t = stack.table_spec(table_name)
    D = stack.num_shards
    arr = np.asarray(stacked)
    if arr.ndim == 3:
        # Packed 3-D state [global_rows, stride, dim]: table rows are
        # the leading row of each group.
        arr = arr[:, 0, :]
    elif stack.bitpacked_state:
        # Bit-packed bf16 state: f32-typed words [global_rows/2, dim]
        # (ops/bitpack.py).
        from keras_rs_tpu.ops import bitpack

        arr = np.asarray(bitpack.unpack_rows(jnp.asarray(arr)))
    r = np.arange(t.vocabulary_size)
    global_idx = (
        (r + t.rotation) % D
    ) * stack.rows_per_shard + t.local_offset + r // D
    return arr[global_idx, : t.embedding_dim]


def scatter_table(
    stack: TableStack,
    stacked: np.ndarray,
    table_name: str,
    values: np.ndarray,
) -> np.ndarray:
    """Writes [vocab, dim] values for one table into the stacked layout
    (split or packed — slot rows are untouched)."""
    t = stack.table_spec(table_name)
    D = stack.num_shards
    if values.shape != (t.vocabulary_size, t.embedding_dim):
        raise ValueError(
            f"Expected shape {(t.vocabulary_size, t.embedding_dim)}, got "
            f"{values.shape}."
        )
    r = np.arange(t.vocabulary_size)
    global_idx = (
        (r + t.rotation) % D
    ) * stack.rows_per_shard + t.local_offset + r // D
    out = np.array(stacked)
    if out.ndim == 3:  # packed: write the table row of each group
        out[global_idx, 0, : t.embedding_dim] = values
    elif stack.bitpacked_state:  # bit-packed bf16: unpack-write-repack
        from keras_rs_tpu.ops import bitpack

        flat = np.array(bitpack.unpack_rows(jnp.asarray(out)))
        flat[global_idx, : t.embedding_dim] = values
        out = np.asarray(bitpack.pack_rows(jnp.asarray(flat)))
    else:
        out[global_idx, : t.embedding_dim] = values
    return out
