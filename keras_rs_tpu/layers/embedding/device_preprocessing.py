"""Device-side (jittable) COO preprocessing for the sharded embedding path.

The reference performs COO preprocessing on the HOST on every batch
(jax-tpu-embedding `preprocess_sparse_dense_matmul_input`, called at
keras_rs/src/layers/embedding/jax/embedding_utils.py:144-217) and needs a
4-thread `ThreadedDataLoader` just to keep the accelerator fed
(examples/ml_perf/main.py:35-105). This module moves the whole transform
onto the device as pure XLA (stable multi-key sorts + segment sums + static
scatters), so it can be jitted INTO the train step:

  raw int ids [B, L] --jit--> CooBatch arrays --lookup kernel--> acts

Benefits over the host path:
  * no host CPU bottleneck, no worker threads, no numpy<->device copies
    of six preprocessed arrays per stack per step — only the raw ids move;
  * the preprocess fuses into the step's XLA program and overlaps with
    unrelated compute;
  * identical semantics to preprocessing.preprocess_stack (same bucket
    layout, same stable entry order, same dedup/sink contracts) —
    verified bit-exactly in tests/test_device_preprocessing.py.

Static-shape notes: every output has the same [D, D, C] / [D, U] / ...
shapes as the host path; capacity overflow drops entries exactly like the
host path, with observed stats returned as device scalars (`DeviceStats`)
instead of a host-side warning (parity with `update_stats`,
jax/distributed_embedding.py:658-719).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import jax
import jax.numpy as jnp

from keras_rs_tpu.layers.embedding.stacking import TableStack

_INT_MAX = jnp.iinfo(jnp.int32).max
_COMBINER_CODE = {"sum": 0, "mean": 1, "sqrtn": 2}


class DeviceStats(NamedTuple):
    """Observed input stats as device scalars (jit-friendly)."""

    max_ids_per_bucket: jax.Array  # i32 []
    max_unique_per_shard: jax.Array  # i32 []
    dropped_ids: jax.Array  # i32 []


def preprocess_stack_device(
    stack: TableStack,
    inputs: Mapping[str, jax.Array],
    weights: Mapping[str, jax.Array] | None = None,
) -> tuple[dict[str, jax.Array], DeviceStats]:
    """Jittable equivalent of preprocessing.preprocess_stack.

    `inputs[feature_name]`: int array (B,) or (B, L); ids outside
    [0, vocab) or with zero weight are ignored. Returns the same six
    arrays as the host `CooBatch` (as jnp arrays) plus `DeviceStats`.
    """
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    B = stack.batch_size
    Bl = B // D
    F = stack.num_features
    S_l = F * Bl
    sink = stack.sink_slot

    # --- flatten all features into one static entry list -------------------
    ds, ss, slots, segs, gains, valids = [], [], [], [], [], []
    combiner_code = jnp.zeros((S_l,), jnp.int32)

    for fspec in stack.features:
        ids = jnp.asarray(inputs[fspec.name])
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape[0] != B:
            raise ValueError(
                f"Feature {fspec.name}: expected global batch {B}, got "
                f"{ids.shape[0]}."
            )
        w = None if weights is None else weights.get(fspec.name)
        if w is None:
            w = jnp.ones(ids.shape, jnp.float32)
        else:
            w = jnp.asarray(w, jnp.float32)
            if w.ndim == 1:
                w = w[:, None]
            if w.shape != ids.shape:
                raise ValueError(
                    f"Feature {fspec.name}: weights shape {w.shape} != "
                    f"ids shape {ids.shape}."
                )

        tspec = stack.table_spec(fspec.table_name)
        L = ids.shape[1]
        b = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None], (B, L)
        ).reshape(-1)
        r = ids.reshape(-1).astype(jnp.int32)
        g = w.reshape(-1)
        valid = (g != 0) & (r >= 0) & (r < tspec.vocabulary_size)
        r_safe = jnp.where(valid, r, 0)

        ds.append(b // Bl)
        ss.append((r_safe + tspec.rotation) % D)
        slots.append(tspec.local_offset + r_safe // D)
        # Sample-major segment ids (host-path parity): activations
        # reshape straight to [B, F, dim], no transpose downstream.
        segs.append((b % Bl) * F + fspec.feature_index)
        gains.append(g)
        valids.append(valid)

        combiner_code = combiner_code.at[
            fspec.feature_index :: F
        ].set(_COMBINER_CODE[tspec.combiner])

    d = jnp.concatenate(ds)
    s = jnp.concatenate(ss)
    slot = jnp.concatenate(slots)
    seg = jnp.concatenate(segs)
    gain = jnp.concatenate(gains)
    valid = jnp.concatenate(valids)
    N = d.shape[0]

    gain = jnp.where(valid, gain, 0.0)

    # --- combiner divisors (per source device, per local segment) ----------
    # Static skip when every table uses the "sum" combiner (divisors are
    # identically 1.0 and x / 1.0 is an IEEE identity): saves two
    # N-entry segment-sums and an N-entry gather+divide per step — at
    # flagship valence (1.4M entries/batch) this is real step time.
    all_sum = all(
        stack.table_spec(f.table_name).combiner == "sum"
        for f in stack.features
    )
    if all_sum:
        divisors = jnp.ones((D, S_l), jnp.float32)
    else:
        div_idx = jnp.where(valid, d * S_l + seg, D * S_l)
        sum_g = jax.ops.segment_sum(
            gain, div_idx, num_segments=D * S_l + 1
        )
        sum_g2 = jax.ops.segment_sum(
            gain * gain, div_idx, num_segments=D * S_l + 1
        )
        sum_g = sum_g[: D * S_l].reshape(D, S_l)
        sum_g2 = sum_g2[: D * S_l].reshape(D, S_l)
        code = combiner_code[None, :]
        divisors = jnp.where(
            code == 0,
            1.0,
            jnp.where(code == 1, sum_g, jnp.sqrt(sum_g2)),
        )
        divisors = jnp.where(divisors == 0, 1.0, divisors).astype(
            jnp.float32
        )

    # --- bucket by (src device, dst shard); SLOT-sorted within bucket ------
    # Entry-order contract (shared by all three backends): bucket-major
    # (d * D + s), slot-ascending within bucket, original order for full
    # ties — the host path's np.lexsort((slot, s, d)). Slot-major order
    # makes every shard's received entries a concatenation of
    # slot-sorted runs, and at D = 1 FULLY slot-sorted: the backward
    # dedup falls out of THIS sort by adjacency, where the old seg-major
    # contract needed a second full N-entry stable sort per step (at
    # flagship valence N = 1.4M). Nothing
    # requires seg order: the forward segment-sum is order-independent.
    R_l = stack.rows_per_shard
    bucket = jnp.where(valid, d * D + s, D * D).astype(jnp.int32)
    if (D * D + 1) * R_l <= _INT_MAX:
        # Fused i32 key (bucket * R_l + slot): a single-key sort moving
        # 3 operands instead of a 2-key sort moving 4; bucket and slot
        # are recovered from the sorted key by a constant divmod.
        key = bucket * R_l + slot
        key_s, seg_s, gain_s = jax.lax.sort(
            (key, seg, gain), num_keys=1, is_stable=True
        )
        bucket_s = key_s // R_l
        slot_s = key_s - bucket_s * R_l
    else:  # i32 overflow guard (huge D * rows_per_shard): same order
        bucket_s, slot_s, seg_s, gain_s = jax.lax.sort(
            (bucket, slot, seg, gain), num_keys=2, is_stable=True
        )
    # Bucket start offsets in the sorted order, from a counts cumsum
    # (a static-shape scan, no searchsorted).
    bucket_counts = jax.ops.segment_sum(
        jnp.ones((N,), jnp.int32), bucket, num_segments=D * D + 1
    )
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(bucket_counts[: D * D])]
    ).astype(jnp.int32)
    rank = jnp.arange(N, dtype=jnp.int32) - starts[
        jnp.clip(bucket_s, 0, D * D - 1)
    ]
    within = (bucket_s < D * D) & (rank < C)

    ok = None
    if D == 1:
        # Single-shard fast path: one bucket, and the sort put its valid
        # entries first — the "scatter" is a slice + mask (XLA int
        # scatters cost ~190 us each at 40960 entries; this is free).
        m = min(N, C)
        ok = bucket_s[:m] == 0

        def fill(x_s, pad_value, dtype):
            part = jnp.where(ok, x_s[:m], pad_value)
            if m < C:
                part = jnp.pad(
                    part, (0, C - m), constant_values=pad_value
                )
            return part.reshape(1, 1, C).astype(dtype)

        send_slots = fill(slot_s, sink, jnp.int32)
        send_segs = fill(seg_s, 0, jnp.int32)
        send_gains = fill(gain_s, 0.0, jnp.float32)
    else:
        flat_idx = jnp.where(within, bucket_s * C + rank, D * D * C)
        send_slots = (
            jnp.full((D * D * C,), sink, jnp.int32)
            .at[flat_idx]
            .set(slot_s, mode="drop")
            .reshape(D, D, C)
        )
        send_segs = (
            jnp.zeros((D * D * C,), jnp.int32)
            .at[flat_idx]
            .set(seg_s, mode="drop")
            .reshape(D, D, C)
        )
        send_gains = (
            jnp.zeros((D * D * C,), jnp.float32)
            .at[flat_idx]
            .set(gain_s, mode="drop")
            .reshape(D, D, C)
        )

    # Fold the combiner divisor into the gains (host-path parity: the
    # same elementwise gather+divide, so bit-identical inputs give
    # bit-identical folded gains). The lookup kernel never divides.
    # All-sum stacks skip the fold entirely (divisors ≡ 1.0, an IEEE
    # division identity — bit parity holds).
    if not all_sum:
        send_gains = send_gains / divisors[
            jnp.arange(D, dtype=jnp.int32)[:, None, None], send_segs
        ]
    # Globalize segment ids (src_device * S_l + seg) — host-path parity;
    # the lookup consumes these as flat segment-sum offsets.
    send_segs = send_segs + (
        jnp.arange(D, dtype=jnp.int32)[:, None, None] * S_l
    )

    # Bucket fill stats.
    counts = bucket_counts[: D * D]
    max_ids = jnp.max(counts) if D * D else jnp.zeros((), jnp.int32)
    dropped = jnp.sum(jnp.maximum(counts - C, 0))

    # --- per-shard dedup of received slots (for the backward pass) ---------
    if D == 1:
        # The send order IS slot-ascending for in-bucket entries (the
        # contract above), and the single shard receives exactly the
        # send buffer: dedup is an adjacency scan over the ALREADY
        # sorted slots — no second sort, and entry_unique needs no
        # position scatter (entry order == sorted order).
        m = min(N, C)
        key_u = jnp.where(ok, slot_s[:m], _INT_MAX)
        prev = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32), key_u[:-1]]
        )
        new_unique = ok & (key_u != prev)
        uidx = jnp.cumsum(new_unique, dtype=jnp.int32) - 1
        max_unique = jnp.sum(new_unique)

        # unique_slots[u] = u-th distinct slot (ascending), sink padded;
        # uniques beyond U-1 overflow to the sink slot.
        u_flat = jnp.where(new_unique & (uidx < U - 1), uidx, U)
        unique_slots = (
            jnp.full((U,), sink, jnp.int32)
            .at[u_flat]
            .set(key_u, mode="drop")[None]
        )
        # Drop sentinel U for padding and unique-capacity overflow; the
        # backward segment-sum discards out-of-range ids natively.
        inv = jnp.where(ok & (uidx < U - 1), uidx, U)
        if m < C:
            inv = jnp.pad(inv, (0, C - m), constant_values=U)
        entry_unique = inv.reshape(1, C)
    else:
        # Received layout on shard e: concat over sources d of bucket
        # (d, e) — D slot-sorted runs, still merged by one stable sort.
        recv_slots = jnp.transpose(send_slots, (1, 0, 2)).reshape(
            D, D * C
        )
        # Dedup membership = buffer occupancy (slot != sink; the sink
        # row is reserved so no real slot equals it) — matches the
        # numpy and C++ backends even when a mean/sqrtn gain fold
        # underflows a valid weight to exactly 0.0.
        real = recv_slots != sink

        key = jnp.where(real, recv_slots, _INT_MAX)
        pos = jnp.broadcast_to(
            jnp.arange(D * C, dtype=jnp.int32)[None, :], (D, D * C)
        )
        key_s, pos_s = jax.lax.sort(
            (key, pos), num_keys=1, is_stable=True, dimension=1
        )
        real_s = key_s != _INT_MAX
        prev = jnp.pad(
            key_s[:, :-1], ((0, 0), (1, 0)), constant_values=-1
        )
        new_unique = real_s & (key_s != prev)
        uidx = jnp.cumsum(new_unique, axis=1, dtype=jnp.int32) - 1
        n_unique = jnp.sum(new_unique, axis=1)  # [D]

        row = jnp.broadcast_to(
            jnp.arange(D, dtype=jnp.int32)[:, None], (D, D * C)
        )
        # unique_slots[e, u] = u-th distinct slot (ascending), sink
        # padded; uniques beyond U-1 overflow to the sink slot
        # (host-path parity). Flat scatter index; dropped entries
        # (duplicates, sink padding, overflow past U-1) go to the
        # GLOBAL out-of-bounds index D*U — a per-row sentinel like
        # row*U + U would land in the NEXT shard's unique_slots[row+1, 0].
        u_flat = jnp.where(
            new_unique & (uidx < U - 1), row * U + uidx, D * U
        )
        unique_slots = (
            jnp.full((D * U,), sink, jnp.int32)
            .at[u_flat.reshape(-1)]
            .set(key_s.reshape(-1), mode="drop")
            .reshape(D, U)
        )
        # Unique-overflow entries map to the drop sentinel U (one past
        # the valid range; the backward segment-sum discards
        # out-of-range ids natively), and padding entries keep the U
        # default fill — host-path parity.
        inv = jnp.where(uidx < U - 1, uidx, U)
        e_write = jnp.where(real_s, row * (D * C) + pos_s, D * D * C)
        entry_unique = (
            jnp.full((D * D * C,), U, jnp.int32)
            .at[e_write.reshape(-1)]
            .set(inv.reshape(-1), mode="drop")
            .reshape(D, D * C)
        )

        max_unique = jnp.max(n_unique)
    dropped_total = dropped + jnp.maximum(max_unique - (U - 1), 0)

    coo = {
        "send_slots": send_slots,
        "send_segs": send_segs,
        "send_gains": send_gains,
        "unique_slots": unique_slots,
        "entry_unique": entry_unique,
        "divisors": divisors,
    }
    # CONSTRUCTION-order forward arrays (host parity:
    # preprocessing.construction_fwd_arrays): the pre-sort entry list,
    # masked — pure elementwise, no extra sort. Emitted only when the
    # stack qualifies AND runtime shapes match the declared
    # (batch, valence) statics, same gate as the host backends.
    def _norm_shape(x):
        s = tuple(jnp.asarray(x).shape)
        return s + (1,) if len(s) == 1 else s

    if stack.construction_fwd and all(
        _norm_shape(inputs[f.name]) == (f.batch_size, f.valence)
        for f in stack.features
    ):
        fwd_slots = jnp.where(valid, slot, sink).astype(jnp.int32)
        fwd_gains = gain  # already masked (gain = where(valid, g, 0))
        if not all_sum:
            # Same fold expression as the send-buffer gains: gather the
            # entry's divisor, divide — bit-identical per entry.
            fwd_gains = fwd_gains / divisors[d, seg]
        coo["fwd_slots"] = fwd_slots[None]
        coo["fwd_gains"] = fwd_gains.astype(jnp.float32)[None]
    stats = DeviceStats(
        max_ids_per_bucket=max_ids.astype(jnp.int32),
        max_unique_per_shard=max_unique.astype(jnp.int32),
        dropped_ids=dropped_total.astype(jnp.int32),
    )
    return coo, stats
