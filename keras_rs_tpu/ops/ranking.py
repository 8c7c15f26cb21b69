"""Core ranking math: sorting-by-scores, list weights, DCG.

JAX reimplementation of the reference utilities in
keras_rs/src/metrics/ranking_metrics_utils.py and
keras_rs/src/metrics/utils.py. Everything is pure jnp (XLA fuses these into
a handful of VPU ops + one top_k), fully jit/vmap-compatible, and takes an
explicit PRNG key instead of stateful seed generators.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from keras_rs_tpu.types import Tensor


def divide_no_nan(x: Tensor, y: Tensor) -> Tensor:
    """x / y, returning 0 where y == 0 (grad-safe)."""
    zero = y == 0
    safe_y = jnp.where(zero, jnp.ones_like(y), y)
    return jnp.where(zero, jnp.zeros_like(x * safe_y), x / safe_y)


def standardize_call_inputs_ranks(
    y_true: Tensor,
    y_pred: Tensor,
    mask: Tensor | None = None,
    check_y_true_rank: bool = True,
) -> tuple[Tensor, Tensor, Tensor | None, bool]:
    """Checks ranks/shapes and upranks 1-D (unbatched) inputs to 2-D.

    Parity: keras_rs/src/metrics/utils.py:8-70.
    """
    if check_y_true_rank and y_true.ndim not in (1, 2):
        raise ValueError(
            f"`y_true` must have rank 1 or 2, got rank {y_true.ndim}."
        )
    if y_pred.ndim not in (1, 2):
        raise ValueError(
            f"`y_pred` must have rank 1 or 2, got rank {y_pred.ndim}."
        )
    if y_true.shape != y_pred.shape:
        raise ValueError(
            "`y_true` and `y_pred` must have the same shape. Received: "
            f"{y_true.shape} vs {y_pred.shape}."
        )
    if mask is not None and mask.shape != y_true.shape:
        raise ValueError(
            "`mask` must have the same shape as `y_true`. Received: "
            f"{mask.shape} vs {y_true.shape}."
        )

    batched = y_true.ndim != 1
    if not batched:
        y_true = y_true[None, :]
        y_pred = y_pred[None, :]
        if mask is not None:
            mask = mask[None, :]
    return y_true, y_pred, mask, batched


def get_shuffled_indices(
    shape: tuple[int, ...],
    *,
    mask: Tensor | None = None,
    shuffle_ties: bool = True,
    key: jax.Array | None = None,
) -> Tensor:
    """Per-row permutation: random tie-break order, masked entries last.

    Parity: keras_rs/src/metrics/ranking_metrics_utils.py:9-51.
    """
    if shuffle_ties:
        if key is None:
            raise ValueError("`key` is required when `shuffle_ties=True`.")
        shuffle_values = jax.random.uniform(key, shape, jnp.float32)
    else:
        shuffle_values = jnp.zeros(shape, jnp.float32)
    if mask is not None:
        # Values are in [0, 1); +1 pushes masked entries after all unmasked.
        shuffle_values = jnp.where(mask, shuffle_values, shuffle_values + 1.0)
    return jnp.argsort(shuffle_values, axis=-1, stable=True)


def sort_by_scores(
    tensors_to_sort: Sequence[Tensor],
    scores: Tensor,
    *,
    mask: Tensor | None = None,
    k: int | None = None,
    shuffle_ties: bool = True,
    key: jax.Array | None = None,
) -> list[Tensor]:
    """Sorts each tensor in `tensors_to_sort` by `scores`, descending.

    Masked entries sort last; ties broken randomly when `shuffle_ties` (and a
    key) are given, else stably. Returns the top-`k` columns.

    Parity: keras_rs/src/metrics/ranking_metrics_utils.py:54-129.
    """
    list_size = scores.shape[-1]
    k = list_size if k is None else min(k, list_size)

    do_shuffle = shuffle_ties and key is not None
    shuffled_indices = None
    if do_shuffle or mask is not None:
        shuffled_indices = get_shuffled_indices(
            scores.shape, mask=mask, shuffle_ties=do_shuffle, key=key
        )
        scores = jnp.take_along_axis(scores, shuffled_indices, axis=-1)

    _, indices = jax.lax.top_k(scores, k)

    if shuffled_indices is not None:
        indices = jnp.take_along_axis(shuffled_indices, indices, axis=-1)

    return [
        jnp.take_along_axis(t, indices, axis=-1) for t in tensors_to_sort
    ]


def get_list_weights(weights: Tensor, relevance: Tensor) -> Tensor:
    """Per-list weights from item weights and relevance.

    per_list_weight = sum(weights * relevance) / sum(relevance); lists with
    zero relevance but nonzero weights get the average computed weight (1.0
    if no list has relevance); lists with zero weights get 0.

    Parity: keras_rs/src/metrics/ranking_metrics_utils.py:132-224.
    """
    nonzero_weights = jnp.sum(weights, axis=1, keepdims=True) > 0.0
    per_list_relevance = jnp.sum(relevance, axis=1, keepdims=True)
    nonzero_relevance_cond = per_list_relevance > 0.0
    nonzero_relevance = jnp.logical_and(
        nonzero_weights, nonzero_relevance_cond
    ).astype(weights.dtype)
    nonzero_relevance_count = jnp.sum(nonzero_relevance, axis=0, keepdims=True)

    numerator = jnp.sum(weights * relevance, axis=1, keepdims=True)
    per_list_weights = divide_no_nan(numerator, per_list_relevance)
    sum_weights = jnp.sum(per_list_weights, axis=0, keepdims=True)

    avg_weight = jnp.where(
        nonzero_relevance_count > 0.0,
        divide_no_nan(sum_weights, nonzero_relevance_count),
        jnp.ones_like(sum_weights),
    )
    return jnp.where(
        nonzero_weights,
        jnp.where(nonzero_relevance_cond, per_list_weights, avg_weight),
        jnp.zeros_like(per_list_weights),
    )


def default_gain_fn(label: Tensor) -> Tensor:
    return jnp.power(2.0, label) - 1.0


def default_rank_discount_fn(rank: Tensor) -> Tensor:
    return 1.0 / jnp.log2(1.0 + rank)


def compute_dcg(
    y_true: Tensor,
    sample_weight: Tensor,
    gain_fn: Callable[[Tensor], Tensor] = default_gain_fn,
    rank_discount_fn: Callable[[Tensor], Tensor] = default_rank_discount_fn,
) -> Tensor:
    """Weighted discounted cumulative gain over already-sorted labels.

    Parity: keras_rs/src/metrics/ranking_metrics_utils.py:240-257.
    """
    list_size = y_true.shape[1]
    positions = jnp.arange(1, list_size + 1, dtype=y_true.dtype)
    gain = gain_fn(y_true)
    discount = rank_discount_fn(positions)
    return jnp.sum(sample_weight * gain * discount, axis=1, keepdims=True)
