"""Ranking metric base class.

JAX redesign of keras_rs/src/metrics/ranking_metric.py:40-209. The
reference builds on `keras.metrics.Mean` with mutable variables; here metric
state is an explicit pytree (`MeanState`) so `update` is a pure function that
composes with `jax.jit` / `shard_map` train steps, plus a thin stateful
convenience API (`update_state`/`result`/`reset_state`) for host loops.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.losses.base import unpack_labels_and_mask
from keras_rs_tpu.ops.ranking import standardize_call_inputs_ranks
from keras_rs_tpu.types import Tensor

_EPSILON = 1e-7  # keras.config.epsilon() parity


class MeanState(NamedTuple):
    total: jax.Array
    count: jax.Array


class RankingMetric(Module):
    """Base for DCG/NDCG/MAP/MRR/P@k/R@k.

    Subclasses implement `compute_metric(y_true, y_pred, mask, sample_weight)`
    returning `(per_list_values, per_list_weights)`; the weighted mean over
    lists is accumulated in `MeanState`.
    """

    def __init__(
        self,
        k: int | None = None,
        shuffle_ties: bool = True,
        seed: int | None = None,
        name: str | None = None,
        dtype: Any = jnp.float32,
    ) -> None:
        if k is not None and (not isinstance(k, int) or k < 1):
            raise ValueError(
                f"`k` should be a positive integer. Received: `k` = {k}."
            )
        self.k = k
        self.shuffle_ties = shuffle_ties
        self.seed = seed
        self.name = name or type(self).__name__
        self.dtype = jnp.dtype(dtype)
        self._state: MeanState | None = None

    # -- abstract ------------------------------------------------------------
    def compute_metric(
        self,
        y_true: Tensor,
        y_pred: Tensor,
        mask: Tensor,
        sample_weight: Tensor,
        key: jax.Array | None,
    ) -> tuple[Tensor, Tensor]:
        raise NotImplementedError

    # -- functional API --------------------------------------------------
    def init_state(self) -> MeanState:
        return MeanState(
            total=jnp.zeros((), self.dtype), count=jnp.zeros((), self.dtype)
        )

    def update(
        self,
        state: MeanState,
        y_true: Any,
        y_pred: Tensor,
        sample_weight: Tensor | None = None,
        key: jax.Array | None = None,
    ) -> MeanState:
        """Pure update: returns a new MeanState. jit/vmap/shard_map safe."""
        values, weights = self.compute(
            y_true, y_pred, sample_weight=sample_weight, key=key, state=state
        )
        return MeanState(
            total=state.total + jnp.sum(values * weights),
            count=state.count + jnp.sum(weights),
        )

    def merge(self, a: MeanState, b: MeanState) -> MeanState:
        return MeanState(total=a.total + b.total, count=a.count + b.count)

    def result_from_state(self, state: MeanState) -> jax.Array:
        return jnp.where(
            state.count > 0, state.total / state.count, jnp.zeros((), self.dtype)
        )

    def compute(
        self,
        y_true: Any,
        y_pred: Tensor,
        sample_weight: Tensor | None = None,
        key: jax.Array | None = None,
        state: MeanState | None = None,
    ) -> tuple[Tensor, Tensor]:
        """Per-list metric values and weights (the pre-mean computation).

        Parity with the input standardization in
        keras_rs/src/metrics/ranking_metric.py:72-209: dict-mask protocol,
        sample-weight upranking, invalid-entry rewriting.
        """
        y_true, passed_mask = unpack_labels_and_mask(y_true)
        y_true = jnp.asarray(y_true, self.dtype)
        y_pred = jnp.asarray(y_pred, self.dtype)

        if sample_weight is None:
            sample_weight = jnp.ones((), self.dtype)
        else:
            sample_weight = jnp.asarray(sample_weight, self.dtype)

        if y_true.ndim not in (1, 2):
            raise ValueError(
                f"`y_true` must have rank 1 or 2, got {y_true.ndim}."
            )
        if sample_weight.ndim > y_true.ndim:
            raise ValueError(
                f"`sample_weight` rank ({sample_weight.ndim}) cannot exceed "
                f"`y_true` rank ({y_true.ndim})."
            )
        if y_true.ndim == 2 and sample_weight.ndim == 1:
            if sample_weight.shape[0] != y_true.shape[0]:
                raise ValueError(
                    "1-D `sample_weight` must have shape (batch_size,). "
                    f"Received {sample_weight.shape} vs {y_true.shape}."
                )
            sample_weight = sample_weight[:, None]
        sample_weight = jnp.ones_like(y_true) * sample_weight

        valid_mask = y_true >= 0.0
        if passed_mask is not None:
            valid_mask = jnp.logical_and(valid_mask, passed_mask)

        y_true, y_pred, valid_mask, batched = standardize_call_inputs_ranks(
            y_true, y_pred, valid_mask, check_y_true_rank=False
        )
        if not batched:
            sample_weight = sample_weight[None, :]

        mask = jnp.logical_and(valid_mask, sample_weight > 0.0)

        y_true = jnp.where(mask, y_true, jnp.zeros_like(y_true))
        y_pred = jnp.where(
            mask,
            y_pred,
            jnp.min(y_pred, axis=1, keepdims=True)
            - _EPSILON * jnp.ones_like(y_pred),
        )
        sample_weight = jnp.where(
            mask, sample_weight, jnp.zeros_like(sample_weight)
        )

        if key is None and self.shuffle_ties:
            # Deterministic per-update key derived from the seed and the
            # number of lists seen so far (works under jit: fold_in accepts
            # traced operands).
            key = jax.random.key(self.seed if self.seed is not None else 0)
            if state is not None:
                key = jax.random.fold_in(
                    key, jnp.asarray(state.count, jnp.uint32)
                )

        return self.compute_metric(
            y_true=y_true,
            y_pred=y_pred,
            mask=mask,
            sample_weight=sample_weight,
            key=key,
        )

    # -- stateful convenience API (host loops, not for jit) ----------------
    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(
        self,
        y_true: Any,
        y_pred: Tensor,
        sample_weight: Tensor | None = None,
    ) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(
            self._state, y_true, y_pred, sample_weight=sample_weight
        )

    def result(self) -> jax.Array:
        if self._state is None:
            return jnp.zeros((), self.dtype)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {
            "k": self.k,
            "shuffle_ties": self.shuffle_ties,
            "seed": self.seed,
            "name": self.name,
        }
