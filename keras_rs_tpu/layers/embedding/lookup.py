"""Sharded embedding lookup: all-to-all exchange + fused optimizer update.

Rebuild, in plain JAX collectives and XLA gathers/scatters, of the two
native kernels the reference delegates to jax-tpu-embedding (SURVEY.md
§2.10 items 1-2):

  forward  (parity: `tpu_sparse_dense_matmul`, called at
            keras_rs/src/layers/embedding/jax/embedding_lookup.py:137):
    all_to_all the pre-bucketed COO ids -> each shard gathers its
    local rows -> weighted segment-sum partials per (source device,
    segment) -> all_to_all partials back -> sum over shards -> combiner
    divisor. Comm volume: ids (small) + one [B_global, dim] activation
    exchange, identical to the SparseCore dataflow.

  backward (parity: `tpu_sparse_dense_matmul_grad`,
            embedding_lookup.py:225): all_gather the segment cotangents ->
    per-entry grads -> segment-sum into deduped unique rows -> gather rows
    + optimizer slots -> fused SGD/Adagrad/Adam/FTRL row update -> scatter
    back. The custom_vjp returns the UPDATED table/slots as the cotangent
    and step+1 as the step's cotangent (the reference's
    `overwrite_with_gradient` contract, jax/distributed_embedding.py:313,
    518-536), which `keras_rs_tpu.training.Overwrite` assigns.

No dense [vocab, dim] gradient is ever materialized: update cost is
O(unique_ids * dim).
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from keras_rs_tpu.layers.embedding.stacking import TableStack
from keras_rs_tpu.ops import bitpack
from keras_rs_tpu.ops.quant import cast_rows_for_storage


def init_stack_state(
    stack: TableStack, table: jax.Array
) -> dict[str, Any]:
    """Bundles a stacked table with its optimizer slots and step counter.

    Split layout (default for bf16 / SGD / wide stacks):
      {"table": [R, dim], "slots": {name: [R, dim]}, "step": []}.
    Packed layout (`stack.packed_state`): the table row and its slot rows
    form the [state_stride, dim] groups of ONE 3-D array —
      {"table": [R, state_stride, dim], "step": []} —
    so the backward fetches table+slots with one block gather and writes
    them back with one unique-index scatter. The array must stay 3-D end
    to end — reshaping it breaks XLA's in-place aliasing and costs a full
    table copy per step. `stacking.gather_table` / `scatter_table` are
    layout-aware, so export/import sees the same logical [vocab, dim]
    tables either way.
    """
    if stack.packed_state:
        parts = [table] + [
            stack.optimizer.init_slot(name, table.shape, table.dtype)
            for name in stack.optimizer.slot_names
        ]
        packed = jnp.stack(parts, axis=1)  # [R, stride, dim]
        return {"table": packed, "step": jnp.zeros((), jnp.float32)}
    logical_shape = table.shape
    if stack.bitpacked_state:
        # bf16 rows bit-packed pairwise into 32-bit words
        # (ops/bitpack.py). Slots stay f32 at the LOGICAL row count.
        table = bitpack.pack_rows(table.astype(jnp.bfloat16))
    # Optimizer slots stay f32 even for bf16 tables (accumulators need
    # the precision). Row-wise slots hold one scalar per row ([R] 1-D,
    # 4 B/row — see optimizers.RowWiseAdagrad).
    slots = {
        name: stack.optimizer.init_slot(
            name,
            logical_shape[:1]
            if name in stack.optimizer.rowwise_slots
            else logical_shape,
            jnp.float32,
        )
        for name in stack.optimizer.slot_names
    }
    return {
        "table": table,
        "slots": slots,
        "step": jnp.zeros((), jnp.float32),
    }


#: Forward table-row fetch from the packed [R, stride, dim] state:
#: False = axis-0 block gather + row-0 slice (fetches the optimizer
#: slot rows too — 2x the bytes); True = 2-index lax.gather of
#: (slot, 0) rows. Unmeasured on the GPU; the A/B is
#: tools/probe_preproc_ops.py take_rows2d_packed vs take_blocks_packed.
FWD_ROW_GATHER = False


def _shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: the in/out specs here are explicit and
    # authoritative.
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def stack_lookup(
    stack: TableStack,
    mesh: Mesh,
    axis: str,
    state: Mapping[str, Any],
    coo: Mapping[str, jax.Array],
    comm_dtype: str | None = None,
) -> jax.Array:
    """Differentiable lookup for one stack.

    Returns activations [D * S_l, dim] = [B, F, dim] flattened
    (segments are sample-major: device, local sample, feature),
    sample-sharded over `axis`. Gradient side effect: the cotangent of
    `state` is the post-update state (Overwrite contract).

    `comm_dtype="bfloat16"` compresses the two [B, F, dim]-sized
    collectives — the forward's partial-activation reduce-scatter and
    the backward's cotangent all-gather — to bf16 on the wire, halving
    the embedding path's exchange bytes (tools/weak_scaling.py accounts the
    exact volumes). Local math stays f32: partials are accumulated in
    f32 before the cast, and gradients are upcast right after the
    gather, so only the exchanged values round.
    """
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    S_l = stack.num_features * (stack.batch_size // D)
    dim = stack.stack_dim
    optimizer = stack.optimizer
    packed = stack.packed_state
    bitpacked = stack.bitpacked_state
    is_bf16 = stack.dtype == "bfloat16"
    if comm_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(
            f"Unsupported comm_dtype: {comm_dtype!r} (use None/'float32' "
            "or 'bfloat16')."
        )
    comm_bf16 = comm_dtype == "bfloat16"

    send_slots = coo["send_slots"]  # [D, D, C] int32, P(axis)
    send_segs = coo["send_segs"]
    send_gains = coo["send_gains"]
    unique_slots = coo["unique_slots"]  # [D, U] int32, P(axis)
    entry_unique = coo["entry_unique"]  # [D, D*C] int32, P(axis)
    # NOTE: coo["divisors"] is stats/debug only — the combiner divisor
    # is pre-folded into send_gains by all three preprocessing backends,
    # so this kernel performs no division in either direction.

    def fetch_rows(table, flat_slots):
        """Table rows (no slot rows) from whichever state layout."""
        if packed:
            if FWD_ROW_GATHER:
                # 2-index gather of (slot, 0): fetches HALF the bytes
                # of the block gather (which drags the optimizer-slot
                # rows along only to slice them off).
                idx2 = jnp.stack(
                    [flat_slots, jnp.zeros_like(flat_slots)], axis=1
                )
                return jax.lax.gather(
                    table,
                    idx2,
                    jax.lax.GatherDimensionNumbers(
                        offset_dims=(1,),
                        collapsed_slice_dims=(0, 1),
                        start_index_map=(0, 1),
                    ),
                    slice_sizes=(1, 1, dim),
                )
            # mode="clip": slots are in-bounds by construction (sink
            # = R-1); the default "fill" mode adds an out-of-bounds
            # select pass over the gathered bytes.
            return jnp.take(
                table, flat_slots, axis=0, mode="clip"
            )[:, 0]
        if bitpacked:
            return bitpack.take_rows(table, flat_slots, mode="clip")[0]
        return jnp.take(table, flat_slots, axis=0, mode="clip")

    def fwd_shard(table, s_slots, s_segs, s_gains):
        # Local blocks: table [rows_per_shard, dim]; s_* [1, D, C].
        s_slots, s_segs, s_gains = (
            s_slots[0], s_segs[0], s_gains[0]
        )
        recv_slots = jax.lax.all_to_all(s_slots, axis, 0, 0, tiled=True)
        recv_segs = jax.lax.all_to_all(s_segs, axis, 0, 0, tiled=True)
        recv_gains = jax.lax.all_to_all(s_gains, axis, 0, 0, tiled=True)

        flat_slots = recv_slots.reshape(-1)
        rows = fetch_rows(table, flat_slots)
        contrib = rows.astype(jnp.float32) * recv_gains.reshape(-1, 1)
        # recv_segs are GLOBAL (src * S_l + seg), pre-offset by the
        # preprocessing backends — no per-step index arithmetic here.
        partial = jax.ops.segment_sum(
            contrib, recv_segs.reshape(-1), num_segments=D * S_l
        )  # [D * S_l, dim]
        # Partial activations back to each segment's owner: every shard
        # holds dense per-segment partials, so "all_to_all then sum over
        # sources" IS a reduce-scatter — one ring collective, no
        # [D, S_l, dim] intermediate or separate reduction.
        if comm_bf16:
            # Halve the wire bytes: partials were accumulated in f32
            # locally; only the D-way ring reduction rounds to bf16.
            partial = partial.astype(jnp.bfloat16)
        acts = jax.lax.psum_scatter(
            partial, axis, scatter_dimension=0, tiled=True
        )  # [S_l, dim] on the segment-owner device
        if comm_bf16:
            acts = acts.astype(jnp.float32)
        return (
            acts[None],  # [1, S_l, dim]
            recv_slots[None],
            recv_segs[None],
            recv_gains[None],
        )

    fwd_mapped = _shard_map(
        fwd_shard,
        mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )

    # CONSTRUCTION-order forward (D == 1, see
    # TableStack.construction_fwd): entries arrive in raw feature-
    # concatenated order where the segment structure is STATIC — the
    # combiner reduce is a dense per-feature reshape-sum instead of a
    # segment-sum over the slot-sorted buffer, which XLA lowers to an
    # internal sort plus a segmented combine; the reshape-sum is one
    # elementwise pass. The backward is untouched: it consumes the
    # slot-sorted residuals, whose dedup adjacency and sorted segment
    # ids it needs.
    fwd_slots_c = coo.get("fwd_slots")
    fwd_gains_c = coo.get("fwd_gains")
    use_construction = (
        D == 1
        and fwd_slots_c is not None
        and fwd_gains_c is not None
        and stack.construction_fwd
    )

    def fwd_shard_construction(
        table, s_slots, s_segs, s_gains, f_slots, f_gains
    ):
        rows = fetch_rows(table, f_slots[0])
        gains_c = f_gains[0]
        Bl = stack.batch_size  # D == 1: local == global batch
        parts: list = [None] * stack.num_features
        off = 0
        # Per-feature multiply+reduce on SLICES (not one materialized
        # [N, dim] weighted array first): lets XLA fuse each feature's
        # slice -> multiply -> reduce into one pass over the gather
        # output instead of a full-array multiply plus per-feature
        # slice copies.
        for fspec in stack.features:
            n = fspec.batch_size * fspec.valence
            L = fspec.valence
            parts[fspec.feature_index] = (
                rows[off : off + n]
                .astype(jnp.float32)
                .reshape(Bl, L, dim)
                * gains_c[off : off + n].reshape(Bl, L, 1)
            ).sum(axis=1)
            off += n
        acts = jnp.stack(parts, axis=1).reshape(S_l, dim)
        # Residuals: at D == 1 the received buffers ARE the send
        # buffers (all_to_all over one device is the identity).
        return acts[None], s_slots, s_segs, s_gains

    fwd_construction_mapped = _shard_map(
        fwd_shard_construction,
        mesh,
        in_specs=(
            P(axis, None), P(axis), P(axis), P(axis),
            P(axis), P(axis),
        ),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )

    def run_fwd(table):
        if use_construction:
            return fwd_construction_mapped(
                table, send_slots, send_segs, send_gains,
                fwd_slots_c, fwd_gains_c,
            )
        return fwd_mapped(table, send_slots, send_segs, send_gains)

    def bwd_shard(table, slots, step, recv_slots, recv_segs, recv_gains,
                  u_slots, e_unique, d_acts):
        recv_slots, recv_segs, recv_gains = (
            recv_slots[0], recv_segs[0], recv_gains[0]
        )
        u_slots, e_unique, d_acts = (
            u_slots[0], e_unique[0], d_acts[0]
        )
        g_seg = d_acts  # [S_l, dim]; gains are pre-folded
        if comm_bf16:
            # Compress the cotangent exchange; upcast right after the
            # gather so the per-entry grads and segment-sum stay f32.
            g_seg = g_seg.astype(jnp.bfloat16)
        g_all = jax.lax.all_gather(g_seg, axis)  # [D, S_l, dim]
        # recv_segs are global flat indices already (see fwd).
        ge = jnp.take(
            g_all.reshape(D * S_l, dim), recv_segs.reshape(-1), axis=0,
            mode="clip",  # segs are globalized in-bounds; skip the
            #               fill-select pass over [N, dim]
        ).astype(jnp.float32) * recv_gains.reshape(-1, 1)
        # Padding and unique-capacity-overflow entries carry the drop
        # sentinel U (one past the valid range): segment_sum discards
        # out-of-range ids natively, so no [U, dim] sink-mask multiply
        # is needed here (it used to cost an elementwise pass per step).
        # Sink-slot rows (dedup padding at the top of unique_slots) thus
        # receive exactly-zero gradients and their duplicate writes all
        # emit identical bytes.
        # At D == 1 the entry order is slot-ascending (the slot-major
        # contract) so e_unique is non-decreasing: the sorted hint lets
        # XLA skip the scatter-lowering's internal sort pass. At D > 1
        # the received buffer is D sorted runs, not globally sorted — no
        # hint.
        row_grads = jax.ops.segment_sum(
            ge, e_unique, num_segments=U, indices_are_sorted=(D == 1)
        )  # [U, dim]

        # Named for profiler attribution: the unique-row fetch, the
        # optimizer and the update scatter.
        with jax.named_scope("embedding_update"):
            return update_rows(table, slots, step, u_slots, row_grads)

    def update_rows(table, slots, step, u_slots, row_grads):
        """Applies the summed row gradients to the unique rows u_slots."""
        # unique_slots is ascending by construction (sorted dedup + sink
        # padding at the top index), so the gathers pass the sorted hint.
        if packed:
            # One block gather fetches the table row AND its slot rows
            # ([U, stride, dim] groups); one unique-index scatter writes
            # them back. No reshape: the 3-D array must flow straight
            # from the gather to the scatter, or XLA inserts a full-table
            # copy instead of updating in place.
            blk = jnp.take(
                table,
                u_slots,
                axis=0,
                indices_are_sorted=True,
                mode="clip",  # u_slots are in-bounds (sink-padded)
            ).astype(jnp.float32)
            rows = blk[:, 0]
            slot_rows = {
                k: blk[:, 1 + i]
                for i, k in enumerate(optimizer.slot_names)
            }
            new_rows, new_slot_rows = optimizer.apply(
                rows, row_grads, slot_rows, step
            )
            new_blk = jnp.stack(
                [new_rows]
                + [new_slot_rows[k] for k in optimizer.slot_names],
                axis=1,
            )
            # u_slots repeats the sink slot past its unique prefix; those
            # entries carry exactly-zero gradients and read the same
            # block, so every duplicate write carries identical bytes.
            new_table = table.at[u_slots].set(
                new_blk.astype(table.dtype), unique_indices=True
            )
            return new_table, {}
        if bitpacked:
            # One uint32 pair-word gather serves BOTH the current-row
            # fetch and (reused below) the partner halves of the merge.
            rows_bf16, pair_words = bitpack.take_rows(
                table, u_slots, indices_are_sorted=True, mode="clip"
            )
            rows = rows_bf16.astype(jnp.float32)
        else:
            rows = jnp.take(
                table, u_slots, axis=0, indices_are_sorted=True,
                mode="clip",
            ).astype(jnp.float32)
        slot_rows = {
            k: jnp.take(
                v, u_slots, axis=0, indices_are_sorted=True,
                mode="clip",
            )
            for k, v in slots.items()
        }
        new_rows, new_slot_rows = optimizer.apply(
            rows, row_grads, slot_rows, step
        )
        if is_bf16:
            # Stochastic rounding: deterministic key from (step, shard).
            sr_key = jax.random.fold_in(
                jax.random.fold_in(
                    jax.random.key(0x5EED), step.astype(jnp.uint32)
                ),
                jax.lax.axis_index(axis),
            )
            new_rows = cast_rows_for_storage(
                new_rows, jnp.bfloat16, sr_key
            )
        else:
            new_rows = new_rows.astype(table.dtype)
        if bitpacked:
            # Merge each row's bits with its pair partner's half and
            # write whole 32-bit words (ops/bitpack.py). Pairs where both
            # rows updated emit identical duplicate words.
            pair_ids, words = bitpack.merge_updated_rows(
                pair_words, u_slots, new_rows
            )
            new_table = table.at[pair_ids].set(words, unique_indices=True)
        else:
            new_table = table.at[u_slots].set(
                new_rows, unique_indices=True
            )
        # Same duplicate-sink contract as the packed path above; row
        # slots are [R, dim], row-wise slots [R].
        new_slots = {
            k: v.at[u_slots].set(
                new_slot_rows[k].astype(v.dtype), unique_indices=True
            )
            for k, v in slots.items()
        }
        return new_table, new_slots

    # Per-leaf slot specs: [R, dim] row slots shard as P(axis, None),
    # [R] row-wise scalar slots as P(axis).
    slots_spec = {
        k: P(axis) if v.ndim == 1 else P(axis, None)
        for k, v in state.get("slots", {}).items()
    }
    bwd_mapped = _shard_map(
        bwd_shard,
        mesh,
        in_specs=(
            P(axis, None),  # table
            slots_spec,  # slots (dict of arrays)
            P(),  # step (replicated)
            P(axis), P(axis), P(axis),  # recv residuals
            P(axis), P(axis),  # unique, entry_unique
            P(axis),  # d_acts
        ),
        out_specs=(P(axis, None), slots_spec),
    )

    @jax.custom_vjp
    def lookup(ts):
        acts, _, _, _ = run_fwd(ts["table"])
        return acts.reshape(D * S_l, dim)

    def lookup_fwd(ts):
        acts, r_slots, r_segs, r_gains = run_fwd(ts["table"])
        return acts.reshape(D * S_l, dim), (ts, r_slots, r_segs, r_gains)

    def lookup_bwd(res, d_acts):
        ts, r_slots, r_segs, r_gains = res
        new_table, new_slots = bwd_mapped(
            ts["table"],
            ts.get("slots", {}),
            ts["step"],
            r_slots,
            r_segs,
            r_gains,
            unique_slots,
            entry_unique,
            d_acts.reshape(D, S_l, dim),
        )
        new_ts = {
            "table": new_table,
            "step": ts["step"] + 1.0,
        }
        if "slots" in ts:
            new_ts["slots"] = new_slots
        return (new_ts,)

    lookup.defvjp(lookup_fwd, lookup_bwd)
    return lookup(dict(state))


def split_activations(
    stack: TableStack, acts: jax.Array
) -> dict[str, jax.Array]:
    """Lookup activations -> per-feature [B, dim_f] arrays.

    Segment ids are SAMPLE-major ((local_sample * F + feature_index),
    produced identically by all three preprocessing backends), so the
    [D * S_l, dim] activation block is already ordered
    (device, local_sample, feature) = (global_sample, feature): this is
    a pure reshape + per-feature static slice — no transpose between the
    embedding path and the dense stack (the feature-major layout used to
    cost a materialized [B, F, dim] permutation in the downstream
    concat).
    """
    F = stack.num_features
    a = acts.reshape(stack.batch_size, F, stack.stack_dim)
    return {
        f.name: a[:, f.feature_index, : f.embedding_dim]
        for f in stack.features
    }


def combine_cotangents(
    stack: TableStack, d_feats: Mapping[str, jax.Array]
) -> jax.Array:
    """Inverse of split_activations for hand-written backward paths."""
    parts = []
    for f in stack.features:
        g = d_feats[f.name]
        if f.embedding_dim < stack.stack_dim:
            g = jnp.pad(
                g, ((0, 0), (0, stack.stack_dim - f.embedding_dim))
            )
        parts.append(g)
    a = jnp.stack(parts, axis=1)  # [B, F, dim]
    return a.reshape(
        stack.batch_size * stack.num_features, stack.stack_dim
    )


