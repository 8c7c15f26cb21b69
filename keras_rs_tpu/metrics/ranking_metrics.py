"""The six ranking metrics: DCG, NDCG, MAP, MRR, Precision@k, Recall@k.

JAX reimplementation of keras_rs/src/metrics/{dcg,ndcg,
mean_average_precision,mean_reciprocal_rank,precision_at_k,recall_at_k}.py.
All per-list computations are pure jnp over (batch, list) tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.metrics.ranking_metric import RankingMetric
from keras_rs_tpu.ops.ranking import (
    compute_dcg,
    default_gain_fn,
    default_rank_discount_fn,
    divide_no_nan,
    get_list_weights,
    sort_by_scores,
)
from keras_rs_tpu.types import Tensor


def _split(key: jax.Array | None) -> tuple[jax.Array | None, jax.Array | None]:
    if key is None:
        return None, None
    return tuple(jax.random.split(key))  # type: ignore[return-value]


def _binary_relevance(y: Tensor) -> Tensor:
    return (y >= 1.0).astype(y.dtype)


@export("keras_rs_tpu.metrics.DCG")
class DCG(RankingMetric):
    """Discounted cumulative gain. Parity: keras_rs/src/metrics/dcg.py."""

    def __init__(
        self,
        k: int | None = None,
        gain_fn: Callable[[Tensor], Tensor] = default_gain_fn,
        rank_discount_fn: Callable[[Tensor], Tensor] = default_rank_discount_fn,
        **kwargs: Any,
    ) -> None:
        super().__init__(k=k, **kwargs)
        self.gain_fn = gain_fn
        self.rank_discount_fn = rank_discount_fn

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        sorted_y_true, sorted_weights = sort_by_scores(
            [y_true, sample_weight],
            scores=y_pred,
            k=self.k,
            mask=mask,
            shuffle_ties=self.shuffle_ties,
            key=key,
        )
        dcg = compute_dcg(
            sorted_y_true,
            sorted_weights,
            gain_fn=self.gain_fn,
            rank_discount_fn=self.rank_discount_fn,
        )
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=self.gain_fn(y_true)
        )
        # dcg already includes item weights; divide by the per-list weight so
        # the weighted mean does not double-count it.
        return divide_no_nan(dcg, per_list_weights), per_list_weights


@export("keras_rs_tpu.metrics.NDCG")
class NDCG(RankingMetric):
    """Normalized DCG. Parity: keras_rs/src/metrics/ndcg.py:201-248."""

    def __init__(
        self,
        k: int | None = None,
        gain_fn: Callable[[Tensor], Tensor] = default_gain_fn,
        rank_discount_fn: Callable[[Tensor], Tensor] = default_rank_discount_fn,
        **kwargs: Any,
    ) -> None:
        super().__init__(k=k, **kwargs)
        self.gain_fn = gain_fn
        self.rank_discount_fn = rank_discount_fn

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        key1, key2 = _split(key)
        sorted_y_true, sorted_weights = sort_by_scores(
            [y_true, sample_weight],
            scores=y_pred,
            k=self.k,
            mask=mask,
            shuffle_ties=self.shuffle_ties,
            key=key1,
        )
        dcg = compute_dcg(
            sorted_y_true,
            sorted_weights,
            gain_fn=self.gain_fn,
            rank_discount_fn=self.rank_discount_fn,
        )
        weighted_gains = sample_weight * self.gain_fn(y_true)
        ideal_sorted_y_true, ideal_sorted_weights = sort_by_scores(
            [y_true, sample_weight],
            scores=weighted_gains,
            k=self.k,
            mask=mask,
            shuffle_ties=self.shuffle_ties,
            key=key2,
        )
        ideal_dcg = compute_dcg(
            ideal_sorted_y_true,
            ideal_sorted_weights,
            gain_fn=self.gain_fn,
            rank_discount_fn=self.rank_discount_fn,
        )
        per_list_ndcg = divide_no_nan(dcg, ideal_dcg)
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=self.gain_fn(y_true)
        )
        return per_list_ndcg, per_list_weights


@export("keras_rs_tpu.metrics.MeanAveragePrecision")
class MeanAveragePrecision(RankingMetric):
    """MAP. Parity: keras_rs/src/metrics/mean_average_precision.py:19-62."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        relevance = _binary_relevance(y_true)
        sorted_relevance, sorted_weights = sort_by_scores(
            [relevance, sample_weight],
            scores=y_pred,
            mask=mask,
            k=self.k,
            shuffle_ties=self.shuffle_ties,
            key=key,
        )
        relevant_counts = jnp.cumsum(sorted_relevance, axis=1)
        cutoffs = jnp.cumsum(jnp.ones_like(sorted_relevance), axis=1)
        precisions = divide_no_nan(relevant_counts, cutoffs)
        total_precision = jnp.sum(
            precisions * sorted_weights * sorted_relevance,
            axis=1,
            keepdims=True,
        )
        total_relevance = jnp.sum(
            sample_weight * relevance, axis=1, keepdims=True
        )
        per_list_map = divide_no_nan(total_precision, total_relevance)
        per_list_weights = get_list_weights(sample_weight, relevance)
        return per_list_map, per_list_weights


@export("keras_rs_tpu.metrics.MeanReciprocalRank")
class MeanReciprocalRank(RankingMetric):
    """MRR. Parity: keras_rs/src/metrics/mean_reciprocal_rank.py:19-70."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        (sorted_y_true,) = sort_by_scores(
            [y_true],
            scores=y_pred,
            mask=mask,
            k=self.k,
            shuffle_ties=self.shuffle_ties,
            key=key,
        )
        list_length = sorted_y_true.shape[1]
        relevance = _binary_relevance(sorted_y_true)
        reciprocal_rank = 1.0 / jnp.arange(
            1, list_length + 1, dtype=y_pred.dtype
        )
        mrr = jnp.max(relevance * reciprocal_rank, axis=1, keepdims=True)
        overall_relevance = _binary_relevance(y_true)
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=overall_relevance
        )
        return mrr, per_list_weights


@export("keras_rs_tpu.metrics.PrecisionAtK")
class PrecisionAtK(RankingMetric):
    """P@k. Parity: keras_rs/src/metrics/precision_at_k.py:19-65."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        (sorted_y_true,) = sort_by_scores(
            [y_true],
            scores=y_pred,
            mask=mask,
            k=self.k,
            shuffle_ties=self.shuffle_ties,
            key=key,
        )
        relevance = _binary_relevance(sorted_y_true)
        list_length = sorted_y_true.shape[1]
        valid_list_length = jnp.minimum(
            list_length,
            jnp.sum(mask.astype(jnp.int32), axis=1, keepdims=True),
        )
        per_list_precision = divide_no_nan(
            jnp.sum(relevance, axis=1, keepdims=True),
            valid_list_length.astype(y_pred.dtype),
        )
        overall_relevance = _binary_relevance(y_true)
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=overall_relevance
        )
        return per_list_precision, per_list_weights


@export("keras_rs_tpu.metrics.RecallAtK")
class RecallAtK(RankingMetric):
    """R@k. Parity: keras_rs/src/metrics/recall_at_k.py:19-57."""

    def compute_metric(self, y_true, y_pred, mask, sample_weight, key):
        (sorted_y_true,) = sort_by_scores(
            [y_true],
            scores=y_pred,
            mask=mask,
            k=self.k,
            shuffle_ties=self.shuffle_ties,
            key=key,
        )
        relevance = _binary_relevance(sorted_y_true)
        overall_relevance = _binary_relevance(y_true)
        per_list_recall = divide_no_nan(
            jnp.sum(relevance, axis=1, keepdims=True),
            jnp.sum(overall_relevance, axis=1, keepdims=True),
        )
        per_list_weights = get_list_weights(
            weights=sample_weight, relevance=overall_relevance
        )
        return per_list_recall, per_list_weights
