"""Host-side COO preprocessing for the sharded embedding lookup.

Rebuild of the preprocessing the reference delegates to jax-tpu-embedding's
native `preprocess_sparse_dense_matmul_input`
(keras_rs/src/layers/embedding/jax/embedding_utils.py:144-217): translate
per-feature id matrices into per-(source device, destination shard) COO
buckets with static capacities, plus the dedup structures the backward
pass needs and the input stats used for capacity auto-growth
(`update_stats` parity, jax/distributed_embedding.py:658-719).

Everything here is vectorized numpy (no Python loops over ids); a C++
version is a planned drop-in replacement for multi-GB/s host throughput.

Layout produced for a stack with D shards, bucket capacity C, unique
capacity U, F features and local batch Bl (S_l = F * Bl local segments):

  send_slots  [D, D, C] i32   entry local row slot, bucketed (src, dst)
  send_segs   [D, D, C] i32   entry local segment id (SAMPLE-major:
                              seg = local_sample * F + feature_index, so
                              the lookup's activations reshape straight
                              to [B, F, dim] with no transpose between
                              the embedding path and the dense stack)
  send_gains  [D, D, C] f32   entry weight PRE-DIVIDED by its segment's
                              combiner divisor (0 marks padding) — the
                              lookup does no division on device
  unique_slots[D, U]    i32   per-shard deduped slots (padded with sink)
  entry_unique[D, D*C]  i32   received-entry -> unique-slot index; U
                              (one past the last unique slot) for
                              padding and unique-capacity overflow —
                              out-of-range ids are DROPPED by the
                              backward's segment-sum, so no sink-row
                              gradient mask is needed on device
  divisors    [D, S_l]  f32   per-segment combiner divisor (stats /
                              debugging; already folded into the gains)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Sequence

import numpy as np

from keras_rs_tpu.layers.embedding.stacking import TableStack


@dataclasses.dataclass
class CooBatch:
    """Device-ready preprocessed inputs for one stack."""

    send_slots: np.ndarray
    send_segs: np.ndarray
    send_gains: np.ndarray
    unique_slots: np.ndarray
    entry_unique: np.ndarray
    divisors: np.ndarray
    #: CONSTRUCTION-order forward arrays (D == 1 only, see
    #: TableStack.construction_fwd): the masked raw entries, features
    #: concatenated, each sample-major [B, valence] flattened. The
    #: lookup's forward gathers these and combiner-reduces with dense
    #: per-feature reshape-sums (static segment structure) instead of a
    #: segment-sum over the sorted send buffer. Derived elementwise
    #: from the raw inputs — NO sort, same fold expression as
    #: send_gains, so cross-backend bit parity is by construction.
    fwd_slots: np.ndarray | None = None  # [1, N] int32, sink = invalid
    fwd_gains: np.ndarray | None = None  # [1, N] f32, divisor-folded

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if v is not None
        }


@dataclasses.dataclass(frozen=True)
class InputStats:
    """Observed stats for capacity validation / auto-growth."""

    max_ids_per_bucket: int
    max_unique_per_shard: int
    dropped_ids: int


def construction_fwd_arrays(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None,
    divisors: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | tuple[None, None]:
    """(fwd_slots [1, N] i32, fwd_gains [1, N] f32) in construction
    order, or (None, None) when the path doesn't apply.

    Shared by the numpy backend and the native-engine wrapper so both
    emit bit-identical arrays from one implementation. Applies when
    `stack.construction_fwd` holds AND every feature's runtime shape
    matches its declared (batch, valence) — the lookup reconstructs the
    per-feature segmentation from those statics, so a shape mismatch
    must fall back to the sorted path in every backend identically.
    """
    if not stack.construction_fwd:
        return None, None
    F = stack.num_features
    sink = stack.sink_slot
    all_sum = all(t.combiner == "sum" for t in stack.tables)
    N = stack.construction_entries
    # Preallocated outputs, slice-written in place (a first version
    # built per-feature temporaries + concatenate and cost 41 ms/batch
    # at flagship valence — real money on the host-preprocess path).
    fwd_slots = np.empty(N, np.int32)
    fwd_gains = np.empty(N, np.float32)
    off = 0
    for fspec in stack.features:
        ids = np.asarray(inputs[fspec.name])
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape != (fspec.batch_size, fspec.valence):
            # Same gate as the device backend (_norm_shape check) —
            # all backends must fall back together.
            return None, None
        w = None if weights is None else weights.get(fspec.name)
        tspec = stack.table_spec(fspec.table_name)
        n = fspec.batch_size * fspec.valence
        r = ids.reshape(-1)
        sl = fwd_slots[off : off + n]
        gn = fwd_gains[off : off + n]
        if w is None:
            valid = (r >= 0) & (r < tspec.vocabulary_size)
            gn[:] = valid
        else:
            w = np.asarray(w, np.float32)
            if w.ndim == 1:
                w = w[:, None]
            g = w.reshape(-1)
            valid = (g != 0) & (r >= 0) & (r < tspec.vocabulary_size)
            # where, not g*valid: an inf/nan weight at an invalid id
            # must mask to exactly 0.0 (device-path parity).
            gn[:] = np.where(valid, g, np.float32(0.0))
        # slot = local_offset + r at D == 1 (construction_fwd implies
        # one shard: r // D == r, (r + rotation) % D == 0).
        np.add(
            np.where(valid, r, np.int64(sink - tspec.local_offset)),
            tspec.local_offset,
            out=sl,
            casting="unsafe",
        )
        if not all_sum:
            # Same fold expression as send_gains (elementwise gather +
            # divide of the same two floats) — bit parity with the
            # sorted buffer's folded gains holds per entry.
            seg = (
                np.repeat(
                    np.arange(fspec.batch_size, dtype=np.int64),
                    fspec.valence,
                )
                * F
                + fspec.feature_index
            )
            np.divide(gn, divisors[0, seg], out=gn)
        off += n
    return fwd_slots[None], fwd_gains[None]


def preprocess_stack(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None = None,
    *,
    allow_drop: bool = True,
    backend: str = "auto",
) -> tuple[CooBatch, InputStats]:
    """Builds the CooBatch for one stack from per-feature id matrices.

    `inputs[feature_name]`: int array (B,) or (B, L); ids outside
    [0, vocab) are ignored. `weights[feature_name]`: float array of the
    same shape; zeros mark padding. Ragged data is represented as padded
    ids + 0/1 weights (SURVEY.md §7 hard part (e)).

    `backend`: "auto" uses the native C++ engine when available
    (native/coo_preprocess.cc), "numpy" forces the reference
    implementation below, "native" requires the C++ engine.

    Note on capacity drops: combiner divisors are computed over ALL
    valid ids of a segment, including ids later dropped for exceeding
    bucket capacity — i.e. a "mean" stays the mean over the declared
    list. Dropping is an overload condition (warned, counted in stats);
    fix capacities rather than relying on drop semantics. All three
    backends implement this identically.
    """
    if backend in ("auto", "native"):
        from keras_rs_tpu.layers.embedding import native as native_lib

        if native_lib.available():
            coo, stats = native_lib.preprocess_stack_native(
                stack, inputs, weights
            )
            coo.fwd_slots, coo.fwd_gains = construction_fwd_arrays(
                stack, inputs, weights, coo.divisors
            )
            if stats.dropped_ids:
                msg = (
                    f"Stack {stack.name!r}: {stats.dropped_ids} "
                    "ids/updates dropped (bucket capacity "
                    f"{stack.max_ids_per_partition}, max observed "
                    f"{stats.max_ids_per_bucket}; unique capacity "
                    f"{stack.max_unique_ids_per_shard - 1}, max observed "
                    f"{stats.max_unique_per_shard}). Raise "
                    "max_ids_per_partition / "
                    "max_unique_ids_per_partition."
                )
                if not allow_drop:
                    raise ValueError(msg)
                warnings.warn(msg, stacklevel=2)
            return coo, stats
        if backend == "native":
            raise RuntimeError("Native preprocessing unavailable.")
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    F = stack.num_features
    B = stack.batch_size
    Bl = B // D
    S_l = F * Bl
    sink = stack.sink_slot

    # --- flatten all features into one entry list -------------------------
    all_d = []  # source device
    all_s = []  # destination shard
    all_slot = []  # local row slot on destination
    all_seg = []  # local segment id on source
    all_gain = []
    divisors = np.ones((D, S_l), np.float32)

    for fspec in stack.features:
        ids = np.asarray(inputs[fspec.name])
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape[0] != B:
            raise ValueError(
                f"Feature {fspec.name}: expected global batch {B}, got "
                f"{ids.shape[0]}."
            )
        w = None if weights is None else weights.get(fspec.name)
        if w is None:
            w = np.ones(ids.shape, np.float32)
        else:
            w = np.asarray(w, np.float32)
            if w.ndim == 1:
                w = w[:, None]
            if w.shape != ids.shape:
                raise ValueError(
                    f"Feature {fspec.name}: weights shape {w.shape} != ids "
                    f"shape {ids.shape}."
                )

        tspec = stack.table_spec(fspec.table_name)
        b = np.repeat(np.arange(B, dtype=np.int64), ids.shape[1])
        r = ids.reshape(-1).astype(np.int64)
        g = w.reshape(-1)
        keep = (g != 0) & (r >= 0) & (r < tspec.vocabulary_size)
        b, r, g = b[keep], r[keep], g[keep]

        d = b // Bl
        seg = (b % Bl) * F + fspec.feature_index
        all_d.append(d)
        all_s.append((r + tspec.rotation) % D)
        all_slot.append(tspec.local_offset + r // D)
        all_seg.append(seg)
        all_gain.append(g)

        # Combiner divisors per segment.
        seg_w = np.zeros((D, Bl), np.float32)
        if tspec.combiner == "sqrtn":
            np.add.at(seg_w, (d, b % Bl), g * g)
            seg_w = np.sqrt(seg_w)
        elif tspec.combiner == "mean":
            np.add.at(seg_w, (d, b % Bl), g)
        else:  # sum
            seg_w = np.ones((D, Bl), np.float32)
        seg_w[seg_w == 0] = 1.0
        # Sample-major layout: feature fi's segments sit at fi, fi+F, ...
        divisors[:, fspec.feature_index :: F] = seg_w

    d = np.concatenate(all_d) if all_d else np.zeros(0, np.int64)
    s = np.concatenate(all_s) if all_s else np.zeros(0, np.int64)
    slot = np.concatenate(all_slot) if all_slot else np.zeros(0, np.int64)
    seg = np.concatenate(all_seg) if all_seg else np.zeros(0, np.int64)
    gain = np.concatenate(all_gain) if all_gain else np.zeros(0, np.float32)

    # --- bucket by (src device, dst shard), pad to capacity C -------------
    # Entry-order contract (all three backends): bucket-major, SLOT-
    # ascending within bucket, original order for full ties. Slot-major
    # order lets the device backend dedup by adjacency straight out of
    # its bucket sort (no second N-entry sort at D=1); nothing needs
    # seg order — the lookup's segment-sums are order-independent.
    order = np.lexsort((slot, s, d))
    d, s, slot, seg, gain = (
        d[order], s[order], slot[order], seg[order], gain[order]
    )
    bucket = d * D + s
    # Rank of each entry within its bucket.
    starts = np.searchsorted(bucket, np.arange(D * D))
    rank = np.arange(len(bucket)) - starts[bucket]

    within = rank < C
    dropped = int((~within).sum())
    counts = np.bincount(bucket, minlength=D * D)
    max_ids = int(counts.max()) if len(counts) else 0

    send_slots = np.full((D, D, C), sink, np.int32)
    send_segs = np.zeros((D, D, C), np.int32)
    send_gains = np.zeros((D, D, C), np.float32)
    dd, ss, rr = d[within], s[within], rank[within]
    send_slots[dd, ss, rr] = slot[within]
    send_segs[dd, ss, rr] = seg[within]
    send_gains[dd, ss, rr] = gain[within]

    # Fold the combiner divisor into the gains (one f32 gather+divide
    # per entry at preprocess time). The lookup kernel then computes
    # acts = sum(folded_gain * row) with NO per-step divisions on
    # device, forward or backward.
    # Padding entries have gain 0, so 0/div stays 0. All three backends
    # apply this identical elementwise expression to bit-identical
    # inputs, preserving cross-backend bit parity.
    send_gains = send_gains / divisors[
        np.arange(D, dtype=np.int64)[:, None, None], send_segs
    ]
    # Globalize segment ids: entry segs become src_device * S_l + seg,
    # exactly the flat offsets the lookup's segment-sums consume — the
    # per-step iota*S_l+add on [D*C] ints disappears from the kernel
    # (fwd src_offsets and bwd flat_idx, lookup.py). Padding entries
    # (gain 0) land on segment src*S_l and contribute nothing.
    send_segs = send_segs + (
        np.arange(D, dtype=np.int32)[:, None, None] * S_l
    )

    # --- per-shard dedup for the backward pass ----------------------------
    # Received layout on shard e: concat over src d of bucket (d, e),
    # flattened to D*C entries.
    unique_slots = np.full((D, U), sink, np.int32)
    # Sentinel U = "drop this entry's update" (padding / unique
    # overflow): one past the valid range, so the backward segment-sum
    # discards it natively — no [U, dim] mask multiply on device.
    entry_unique = np.full((D, D * C), U, np.int32)
    max_unique = 0
    for e in range(D):
        recv_slots = send_slots[:, e, :].reshape(-1)  # [D*C]
        # Dedup membership = "entry occupies a bucket position": slot
        # != sink (the sink row is reserved — no real slot equals it).
        # NOT folded-gain != 0: a mean/sqrtn fold can underflow a tiny
        # valid weight to exactly 0.0, and the C++ and device backends
        # key membership off buffer occupancy — gain-based membership
        # would diverge bit-wise on such inputs (review finding r4).
        real = recv_slots != sink
        vals = recv_slots[real]
        if D == 1 and len(vals):
            # Already slot-sorted (the entry-order contract): adjacency
            # dedup — np.unique would re-sort 1.4M entries per batch at
            # flagship valence.
            new_u = np.empty(len(vals), bool)
            new_u[0] = True
            np.not_equal(vals[1:], vals[:-1], out=new_u[1:])
            uniq = vals[new_u]
            inv = np.cumsum(new_u) - 1
        else:
            uniq, inv = np.unique(vals, return_inverse=True)
        max_unique = max(max_unique, len(uniq))
        n = min(len(uniq), U - 1)  # last unique slot is the sink
        unique_slots[e, :n] = uniq[:n]
        # Entries whose unique row overflowed capacity map to the drop
        # sentinel U (counted in stats).
        inv = np.where(inv < n, inv, U)
        entry_unique[e, np.nonzero(real)[0]] = inv

    unique_overflow = max(0, max_unique - (U - 1))
    stats = InputStats(
        max_ids_per_bucket=max_ids,
        max_unique_per_shard=max_unique,
        dropped_ids=dropped + unique_overflow,
    )
    if stats.dropped_ids:
        msg = (
            f"Stack {stack.name!r}: {dropped} ids over bucket capacity "
            f"{C} (max observed {max_ids}; raise max_ids_per_partition)"
            f" and {unique_overflow} unique rows over capacity {U - 1} "
            f"(max observed {max_unique}; raise "
            "max_unique_ids_per_partition)."
        )
        if not allow_drop:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    fwd_slots, fwd_gains = construction_fwd_arrays(
        stack, inputs, weights, divisors
    )
    return (
        CooBatch(
            send_slots=send_slots,
            send_segs=send_segs,
            send_gains=send_gains,
            unique_slots=unique_slots,
            entry_unique=entry_unique,
            divisors=divisors,
            fwd_slots=fwd_slots,
            fwd_gains=fwd_gains,
        ),
        stats,
    )
