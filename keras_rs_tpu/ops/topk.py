"""Streaming exact top-k MIPS over large candidate sets.

`BruteForceRetrieval` scores queries against ALL candidates. The direct
form (parity: keras_rs/src/layers/retrieval/brute_force_retrieval.py:
126-148) materializes a [B, N] score matrix; at production candidate
counts (N in the millions) that is gigabytes of HBM per batch and OOMs.

`chunked_topk_mips` streams candidates through the matmul units in [chunk] blocks
under `lax.scan`, carrying only a running [B, k] top-k (merged with each
chunk's local top-k). Peak memory is O(B * (chunk + 2k)) instead of
O(B * N); the matmuls stay large enough to saturate the matmul units. Exactness:
top-k of a union equals top-k of (top-k of each part) union, so the
result is identical to the direct form (ties broken by lower index, same
as lax.top_k on the concatenated scores with index-offset keys).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from keras_rs_tpu.utils.shape_utils import round_up as _round_up



@functools.partial(
    jax.jit, static_argnames=("k", "chunk_size", "recall_target")
)
def chunked_topk_mips(
    queries: jax.Array,  # [B, D]
    candidates: jax.Array,  # [N, D]
    k: int,
    chunk_size: int = 65536,
    recall_target: float | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Streaming top-k dot-product search; returns (scores, idx) [B, k].

    recall_target=None (default): EXACT — identical to
    `lax.top_k(queries @ candidates.T, k)` including tie-breaking by
    lower candidate index, at O(B*chunk) peak memory.
    recall_target in (0, 1): per-chunk selection uses
    `lax.approx_max_k` instead of the exact chunk top_k; the cross-chunk merge stays exact, so overall recall
    is >= roughly recall_target.
    """
    B, D = queries.shape
    N = candidates.shape[0]
    if k > N:
        raise ValueError(f"k={k} > num candidates {N}")
    # Each chunk must hold at least k candidates for the local top_k.
    chunk = min(max(chunk_size, k), _round_up(N, 128))
    chunk = _round_up(chunk, 128)
    num_chunks = -(-N // chunk)
    pad = num_chunks * chunk - N
    if pad:
        candidates = jnp.pad(candidates, ((0, pad), (0, 0)))
    cand = candidates.reshape(num_chunks, chunk, D)

    neg_inf = jnp.asarray(jnp.finfo(jnp.float32).min, jnp.float32)

    def scan_body(carry, c):
        best_s, best_i = carry  # [B, k] running top-k
        chunk_idx, block = c
        scores = jnp.matmul(
            queries, block.T, preferred_element_type=jnp.float32
        )  # [B, chunk]
        base = chunk_idx * chunk
        col = base + jnp.arange(chunk, dtype=jnp.int32)[None, :]
        scores = jnp.where(col < N, scores, neg_inf)  # mask padding
        if recall_target is None:
            loc_s, loc_i = jax.lax.top_k(scores, k)
        else:
            loc_s, loc_i = jax.lax.approx_max_k(
                scores, k, recall_target=recall_target
            )
        loc_i = jnp.take_along_axis(
            jnp.broadcast_to(col, scores.shape), loc_i, axis=1
        )
        # Merge with the carry. Sort by (score desc, index asc) so ties
        # resolve exactly like a single global top_k.
        all_s = jnp.concatenate([best_s, loc_s], axis=1)  # [B, 2k]
        all_i = jnp.concatenate([best_i, loc_i], axis=1)
        m_s, m_pos = jax.lax.top_k(all_s, k)
        m_i = jnp.take_along_axis(all_i, m_pos, axis=1)
        # top_k is stable w.r.t. position, and carry entries (earlier
        # chunks = lower indices) come first, so ties keep lower index.
        return (m_s, m_i), None

    init = (
        jnp.full((B, k), neg_inf, jnp.float32),
        jnp.zeros((B, k), jnp.int32),
    )
    (scores, idx), _ = jax.lax.scan(
        scan_body,
        init,
        (jnp.arange(num_chunks, dtype=jnp.int32), cand),
    )
    return scores, idx
