"""bf16 tables bit-packed pairwise into 32-bit words.

The bf16 table is stored as ONE 32-bit array of shape [R/2, dim] where
word [p, i] packs element i of logical rows (2p, 2p+1) in its (low,
high) 16-bit halves. Then:

  * row GATHERS run on the packed array + a vectorized halfword extract;
  * row UPDATES merge the new row's bits with the partner row's half
    (read from the same gathered word) and write whole words with a
    unique-index scatter.

The layout exists because the first accelerator this library ran on
could not update a single bf16 row from its kernels; XLA's GPU scatter
writes bf16 rows directly, so whether this layout still earns its place
is an open question (ROADMAP D3).

The packed words are STORED as float32 (a pure bitcast): jax.grad
rejects integer pytree leaves, and the custom-vjp Overwrite contract
flows the updated table through the gradient path — as f32 the words
ride autodiff, NamedSharding, donation, and Orbax checkpoints like any
table. No arithmetic ever touches them as floats; every read/write goes
through an explicit bitcast here.

Both rows of a pair updated in one step is handled by the sorted-
adjacency merge below; such entries emit IDENTICAL words, so the
duplicate writes are benign (the same contract the dedup's sink padding
relies on). Memory cost is exactly 2 bytes/element — true bf16 capacity.

Parity context: this is the storage layer under the bf16 mode of the
SparseCore update kernel the reference delegates to jax-tpu-embedding
(keras_rs/src/layers/embedding/jax/embedding_lookup.py:225); the
reference's SparseCore hardware natively supports sub-32-bit rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _as_f32(words_u32: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(words_u32, jnp.float32)


def _as_u32(words_f32: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(words_f32, jnp.uint32)


def _to_bf16(halfwords_u32: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(
        halfwords_u32.astype(jnp.uint16), jnp.bfloat16
    )


def _bits(rows_bf16: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(rows_bf16, jnp.uint16).astype(
        jnp.uint32
    )


def pack_rows(table: jax.Array) -> jax.Array:
    """bf16 [R, dim] (R even) -> f32-typed packed words [R/2, dim]."""
    if table.dtype != jnp.bfloat16:
        raise ValueError(f"expected bfloat16, got {table.dtype}")
    if table.shape[0] % 2:
        raise ValueError(f"row count must be even, got {table.shape}")
    bits = _bits(table)
    return _as_f32(bits[0::2] | (bits[1::2] << 16))


def unpack_rows(words: jax.Array) -> jax.Array:
    """f32-typed packed words [R/2, dim] -> bf16 [R, dim]."""
    u = _as_u32(words)
    low = _to_bf16(u)
    high = _to_bf16(u >> 16)
    return jnp.stack([low, high], axis=1).reshape(-1, words.shape[-1])


def take_rows(
    words: jax.Array, ids: jax.Array, **take_kwargs
) -> tuple[jax.Array, jax.Array]:
    """Logical-row gather from the packed array.

    Returns (rows bf16 [N, dim], pair_words uint32 [N, dim]) — the raw
    words are returned too so the backward's merge reuses the fetch.
    """
    pair_words = _as_u32(jnp.take(words, ids >> 1, axis=0, **take_kwargs))
    shift = (16 * (ids & 1)).astype(jnp.uint32)
    rows = _to_bf16(pair_words >> shift[:, None])
    return rows, pair_words


def merge_updated_rows(
    pair_words: jax.Array,  # uint32 [N, dim]: current words at ids >> 1
    ids: jax.Array,  # [N] int32 SORTED row ids, unique except trailing
    #                  duplicates of a sink id whose pair has no other
    #                  updated row (dedup's padding contract)
    new_rows: jax.Array,  # bf16 [N, dim]
) -> tuple[jax.Array, jax.Array]:
    """Merges row updates into whole f32-typed packed words.

    Returns (pair_ids [N], words f32 [N, dim]); entries sharing a pair
    emit identical words. Sorted unique ids make a pair's two entries
    adjacent with positions (0, 1), so the partner's NEW bits are one
    roll away; otherwise the partner's half is preserved from
    `pair_words`. Duplicate ids (the sink) emit identical words because
    their inputs are identical and the partner half always comes from
    `pair_words` (the sink's pair holds no other updated row)."""
    ids = ids.astype(jnp.int32)
    pair = ids >> 1
    pos = ids & 1
    bits = _bits(new_rows)  # [N, dim] uint32 halfwords
    # Partner-updated detection must exclude duplicate ids: two equal
    # ids share the pair but are the SAME half, and pulling their bits
    # into the other half would corrupt the partner row.
    prev_mate = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            (pair[1:] == pair[:-1]) & (ids[1:] != ids[:-1]),
        ]
    )
    next_mate = jnp.concatenate(
        [
            (pair[1:] == pair[:-1]) & (ids[1:] != ids[:-1]),
            jnp.zeros((1,), bool),
        ]
    )
    bits_prev = jnp.roll(bits, 1, axis=0)
    bits_next = jnp.roll(bits, -1, axis=0)
    low = jnp.where(
        (pos == 0)[:, None],
        bits,
        jnp.where(prev_mate[:, None], bits_prev, pair_words & 0xFFFF),
    )
    high = jnp.where(
        (pos == 1)[:, None],
        bits,
        jnp.where(next_mate[:, None], bits_next, pair_words >> 16),
    )
    return pair, _as_f32(low | (high << 16))
