"""Flagship-scale microbench of the device-preprocessing primitives.

Candidates for the device-preprocessing share of the flagship DLRM step
are all inside `device_preprocessing.preprocess_stack_device`: the
1.4M-entry stable sort, the N-entry glue (wheres/cumsums/fills), and — for a
hypothetical sort-free construction-order layout — a vocab-sized
mark/cumsum/compact dedup. This tool times each primitive AT THE
FLAGSHIP SHAPE (N = 172 ids/example x 8192 = 1,409,024 entries,
R_l = 7.03M stacked rows, S_l = 8192 x 9 large-feature segments), each
chained in one jitted scan, plus the full
`preprocess_stack_device` call itself, so the step's preprocess-vs-
lookup split and the sort-vs-scatter redesign decision are grounded in
measured numbers rather than attribution guesswork.

Variants:
  preproc_full     jitted preprocess_stack_device on the flagship stack
  sort3            lax.sort((key, seg, gain), num_keys=1) — current path
  sort2_idx        lax.sort((key, idx)) + take(seg) + take(gain)
  sort2            lax.sort((key, seg)) — payload-scaling midpoint
  sort1            lax.sort((key,))     — payload-scaling floor
  scatter_marks    zeros(R_l).at[slot].set(1)   (construction-order dedup)
  cumsum_Rl        jnp.cumsum over R_l i32      (construction-order dedup)
  take_rank        jnp.take(R_l-array, slot)    (construction-order dedup)
  compact_scatter  at[rank].set over N entries  (the D>1 bucket fill)
  segsum_N         segment_sum(gain, seg, S_l)  (divisor / combiner cost)

Run:  python tools/probe_preproc_ops.py            (on the accelerator)
      python tools/probe_preproc_ops.py --small    (CPU smoke)
"""

from __future__ import annotations

import json
import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.utils.timing import chained_call_ms  # noqa: E402

B = 8192
VOCAB_CAP = 1_000_000
THRESHOLD = 21_000

if "--small" in _sys.argv:  # CPU smoke of every code path
    _os.environ["XLA_FLAGS"] = (
        _os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
    B = 64
    VOCAB_CAP = 2_000


def flagship_stack():
    from examples.ml_perf.configs import (
        CRITEO_MULTI_HOT_SIZES,
        CRITEO_VOCAB_SIZES,
    )
    from keras_rs_tpu.layers.embedding.config import (
        FeatureConfig,
        TableConfig,
    )
    from keras_rs_tpu.layers.embedding.stacking import build_stacks

    tables, feats = [], []
    for i, (v, m) in enumerate(
        zip(CRITEO_VOCAB_SIZES, CRITEO_MULTI_HOT_SIZES)
    ):
        if v < THRESHOLD:
            continue
        t = TableConfig(
            name=f"t{i}",
            vocabulary_size=min(v, VOCAB_CAP),
            embedding_dim=128,
            combiner="sum",
            max_ids_per_partition=B * m + 8,
            max_unique_ids_per_partition=B * m + 8,
        )
        tables.append(t)
        feats.append(
            FeatureConfig(
                name=f"f{i}",
                table=t,
                input_shape=(B, m),
                output_shape=(B, 128),
            )
        )
    stacks = build_stacks(feats, num_shards=1)
    assert len(stacks) == 1, [s.name for s in stacks]
    return stacks[0], feats


def main() -> None:
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x1")
    out: dict = {}

    stack, feats = flagship_stack()
    R_l = stack.rows_per_shard
    F = stack.num_features
    S_l = B * F
    rng = np.random.default_rng(3)
    inputs = {
        f.name: rng.integers(
            0, f.table.vocabulary_size, size=f.input_shape,
            dtype=np.int64,
        )
        for f in feats
    }
    N = sum(int(np.prod(f.input_shape)) for f in feats)
    # Actual unique rows at this shape (for the floor model).
    all_slots = np.concatenate(
        [
            (
                stack.table_spec(f.table.name).local_offset
                + inputs[f.name].reshape(-1)
            )
            for f in feats
        ]
    )
    n_unique = len(np.unique(all_slots))
    print(
        f"flagship: N={N} R_l={R_l} S_l={S_l} unique_rows={n_unique} "
        f"({n_unique / N:.2%} of entries)"
    )
    out["shape"] = {
        "N": N, "R_l": int(R_l), "S_l": int(S_l),
        "unique_rows": int(n_unique),
    }

    # --- full device preprocess ------------------------------------------
    from keras_rs_tpu.layers.embedding.device_preprocessing import (
        preprocess_stack_device,
    )

    jinputs = {k: jnp.asarray(v) for k, v in inputs.items()}
    vocabs = {f.name: f.table.vocabulary_size for f in feats}

    def pre_fn(ins):
        coo, _ = preprocess_stack_device(stack, ins, None)
        return coo

    def pre_perturb(args, tick):
        (ins,) = args
        t = tick.astype(jnp.int32)
        return ({k: (v + t) % vocabs[k] for k, v in ins.items()},)

    def pre_derive(coo):
        return (
            coo["send_gains"].reshape(-1)[0] * 1e-6
            + coo["send_slots"].reshape(-1)[0].astype(jnp.float32)
            * 1e-12
        )

    ms = chained_call_ms(pre_fn, (jinputs,), pre_perturb, pre_derive)
    print(f"preproc_full          {ms:9.3f} ms")
    out["preproc_full_ms"] = round(ms, 3)

    # --- sort payload scaling ---------------------------------------------
    key0 = jnp.asarray(
        rng.integers(0, 2 * R_l, size=N, dtype=np.int64).astype(np.int32)
    )
    seg0 = jnp.asarray(
        rng.integers(0, S_l, size=N, dtype=np.int64).astype(np.int32)
    )
    gain0 = jnp.asarray(rng.random(N, dtype=np.float32))
    idx0 = jnp.arange(N, dtype=jnp.int32)

    def kperturb(args, tick):
        k = args[0] + tick.astype(jnp.int32)
        return (k,) + tuple(args[1:])

    def first_f32(o):
        x = o[0] if isinstance(o, (tuple, list)) else o
        return x.reshape(-1)[0].astype(jnp.float32) * 1e-9

    for name, fn, args in [
        (
            "sort3",
            lambda k, s, g: jax.lax.sort(
                (k, s, g), num_keys=1, is_stable=True
            ),
            (key0, seg0, gain0),
        ),
        (
            "sort2_idx",
            lambda k, s, g, i: (
                lambda ks_is: (
                    ks_is[0],
                    jnp.take(s, ks_is[1]),
                    jnp.take(g, ks_is[1]),
                )
            )(jax.lax.sort((k, i), num_keys=1, is_stable=True)),
            (key0, seg0, gain0, idx0),
        ),
        (
            "sort2",
            lambda k, s: jax.lax.sort((k, s), num_keys=1, is_stable=True),
            (key0, seg0),
        ),
        (
            "sort1",
            lambda k: jax.lax.sort((k,), num_keys=1, is_stable=True),
            (key0,),
        ),
    ]:
        ms = chained_call_ms(fn, args, kperturb, first_f32)
        print(f"{name:<20} {ms:9.3f} ms")
        out[f"{name}_ms"] = round(ms, 3)

    # --- construction-order dedup primitives -------------------------------
    slot0 = jnp.asarray(all_slots.astype(np.int32))

    def marks_fn(slot):
        return (
            jnp.zeros((R_l,), jnp.int32).at[slot].set(1, mode="drop")
        )

    def slot_perturb(args, tick):
        return ((args[0] + tick.astype(jnp.int32)) % R_l,) + tuple(
            args[1:]
        )

    ms = chained_call_ms(marks_fn, (slot0,), slot_perturb, first_f32)
    print(f"{'scatter_marks':<20} {ms:9.3f} ms")
    out["scatter_marks_ms"] = round(ms, 3)

    marks0 = marks_fn(slot0)

    def cumsum_fn(m):
        return jnp.cumsum(m)

    ms = chained_call_ms(
        cumsum_fn,
        (marks0,),
        lambda a, t: (a[0] + t.astype(jnp.int32) * 0 + t.astype(jnp.int32),),
        first_f32,
    )
    print(f"{'cumsum_Rl':<20} {ms:9.3f} ms")
    out["cumsum_Rl_ms"] = round(ms, 3)

    ranks0 = jnp.cumsum(marks0)

    def take_fn(r, slot):
        return jnp.take(r, slot)

    ms = chained_call_ms(
        take_fn,
        (ranks0, slot0),
        lambda a, t: (a[0], (a[1] + t.astype(jnp.int32)) % R_l),
        first_f32,
    )
    print(f"{'take_rank':<20} {ms:9.3f} ms")
    out["take_rank_ms"] = round(ms, 3)

    # --- D>1-style bucket-fill scatter at N entries -------------------------
    C = N + 8

    def compact_fn(slot, pos):
        return (
            jnp.zeros((C,), jnp.int32).at[pos].set(slot, mode="drop")
        )

    pos0 = jnp.asarray(
        rng.permutation(N).astype(np.int32)
    )
    ms = chained_call_ms(
        compact_fn,
        (slot0, pos0),
        lambda a, t: ((a[0] + t.astype(jnp.int32)) % R_l, a[1]),
        first_f32,
    )
    print(f"{'compact_scatter':<20} {ms:9.3f} ms")
    out["compact_scatter_ms"] = round(ms, 3)

    # --- segment sum at N entries -------------------------------------------
    def segsum_fn(g, s):
        return jax.ops.segment_sum(g, s, num_segments=S_l)

    ms = chained_call_ms(
        segsum_fn,
        (gain0, seg0),
        lambda a, t: (a[0] + t * 1e-6, a[1]),
        first_f32,
    )
    print(f"{'segsum_N':<20} {ms:9.3f} ms")
    out["segsum_N_ms"] = round(ms, 3)

    # --- the forward's ROW-level ops at flagship scale ----------------------
    # (the lookup's hot pair: gather N rows from the table, then
    # segment-sum [N, dim] into [S_l, dim]; the r4 slot-major contract
    # made the forward's segment ids UNSORTED — measure whether XLA's
    # row segment_sum cares.)
    dim = 128
    table0 = jnp.zeros((R_l, dim), jnp.float32)
    rows0 = jnp.asarray(
        rng.normal(size=(min(N, 1 << 21), dim)).astype(np.float32)
    )
    n_rows = rows0.shape[0]
    seg_rows = jnp.asarray(
        rng.integers(0, S_l, size=n_rows, dtype=np.int64).astype(
            np.int32
        )
    )
    seg_rows_sorted = jnp.sort(seg_rows)

    def take_rows_fn(tab, slot):
        return jnp.take(tab, slot, axis=0)

    ms = chained_call_ms(
        take_rows_fn,
        (table0, slot0),
        lambda a, t: (a[0], (a[1] + t.astype(jnp.int32)) % R_l),
        first_f32,
    )
    print(f"{'take_rows':<20} {ms:9.3f} ms")
    out["take_rows_ms"] = round(ms, 3)

    def segsum_rows_fn(r, s):
        return jax.ops.segment_sum(r, s, num_segments=S_l)

    ms = chained_call_ms(
        segsum_rows_fn,
        (rows0, seg_rows),
        lambda a, t: (a[0] + t * 1e-6, a[1]),
        first_f32,
        iters=4,
    )
    print(f"{'segsum_rows_unsorted':<20} {ms:9.3f} ms")
    out["segsum_rows_unsorted_ms"] = round(ms, 3)

    def segsum_rows_sorted_fn(r, s):
        return jax.ops.segment_sum(
            r, s, num_segments=S_l, indices_are_sorted=True
        )

    ms = chained_call_ms(
        segsum_rows_sorted_fn,
        (rows0, seg_rows_sorted),
        lambda a, t: (a[0] + t * 1e-6, a[1]),
        first_f32,
        iters=4,
    )
    print(f"{'segsum_rows_sorted':<20} {ms:9.3f} ms")
    out["segsum_rows_sorted_ms"] = round(ms, 3)

    # --- PACKED-state fetch variants (the forward's real choice) ------------
    # The forward's [N, 2, 128] block gather from the packed
    # [R, 2, 128] state fetches the slot rows only to discard them.
    # Candidate: a 2-index lax.gather of (slot, 0) rows — half the bytes
    # if it runs at the same rate.
    packed0 = jnp.zeros((R_l, 2, dim), jnp.float32)

    def take_blocks_fn(tab, slot):
        return jnp.take(tab, slot, axis=0)

    ms = chained_call_ms(
        take_blocks_fn,
        (packed0, slot0),
        lambda a, t: (a[0], (a[1] + t.astype(jnp.int32)) % R_l),
        lambda o: o.reshape(-1)[0].astype(jnp.float32) * 1e-9,
        iters=4,
    )
    print(f"{'take_blocks_packed':<20} {ms:9.3f} ms")
    out["take_blocks_packed_ms"] = round(ms, 3)

    def take_rows2d_fn(tab, slot):
        idx2 = jnp.stack(
            [slot, jnp.zeros_like(slot)], axis=1
        )  # [N, 2] -> (row, 0)
        return jax.lax.gather(
            tab,
            idx2,
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1,),
                collapsed_slice_dims=(0, 1),
                start_index_map=(0, 1),
            ),
            slice_sizes=(1, 1, dim),
        )

    ms = chained_call_ms(
        take_rows2d_fn,
        (packed0, slot0),
        lambda a, t: (a[0], (a[1] + t.astype(jnp.int32)) % R_l),
        lambda o: o.reshape(-1)[0].astype(jnp.float32) * 1e-9,
        iters=4,
    )
    print(f"{'take_rows2d_packed':<20} {ms:9.3f} ms")
    out["take_rows2d_packed_ms"] = round(ms, 3)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
