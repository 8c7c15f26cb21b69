"""ListMLE listwise ranking loss.

JAX reimplementation of keras_rs/src/losses/list_mle_loss.py:70-158:
sort logits by labels (stable, no tie shuffling), temperature-scale, then
the negative log-likelihood of the induced permutation via a
flip-cumsum-flip logsumexp-from-the-right.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.losses.base import Loss, unpack_labels_and_mask
from keras_rs_tpu.ops.ranking import (
    sort_by_scores,
    standardize_call_inputs_ranks,
)
from keras_rs_tpu.types import Tensor


@export("keras_rs_tpu.losses.ListMLELoss")
class ListMLELoss(Loss):
    """loss = -sum_i log(exp(s_i) / sum_{j >= i} exp(s_j)).

    Items are ordered by descending true label; invalid items (label < 0 or
    masked) are excluded. Returns one loss per list.
    """

    def __init__(self, temperature: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if temperature <= 0.0:
            raise ValueError(
                "`temperature` should be a positive float. Received: "
                f"`temperature` = {temperature}."
            )
        self.temperature = temperature
        self.epsilon = 1e-10

    def compute_unreduced_loss(
        self,
        labels: Tensor,
        logits: Tensor,
        mask: Tensor | None = None,
    ) -> tuple[Tensor, Tensor]:
        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = jnp.logical_and(valid_mask, mask.astype(bool))

        num_valid = jnp.sum(
            valid_mask.astype(labels.dtype), axis=1, keepdims=True
        )
        has_valid = num_valid > 0.0

        neg_inf = jnp.full_like(labels, -1e9)
        labels_for_sorting = jnp.where(valid_mask, labels, neg_inf)
        logits_masked = jnp.where(valid_mask, logits, neg_inf)

        sorted_logits, sorted_valid_mask = sort_by_scores(
            [logits_masked, valid_mask],
            scores=labels_for_sorting,
            mask=None,
            shuffle_ties=False,
            key=None,
        )
        sorted_logits = sorted_logits / jnp.asarray(
            self.temperature, sorted_logits.dtype
        )

        # Stabilize: subtract the per-list max over valid entries.
        valid_for_max = jnp.where(
            sorted_valid_mask, sorted_logits, jnp.full_like(sorted_logits, -1e9)
        )
        raw_max = jnp.max(valid_for_max, axis=1, keepdims=True)
        raw_max = jnp.where(has_valid, raw_max, jnp.zeros_like(raw_max))
        sorted_logits = sorted_logits - raw_max
        sorted_logits = jnp.where(
            sorted_valid_mask, sorted_logits, jnp.full_like(sorted_logits, -1e9)
        )

        exp_logits = jnp.exp(sorted_logits)
        cumsum_from_right = jnp.flip(
            jnp.cumsum(jnp.flip(exp_logits, axis=1), axis=1), axis=1
        )
        log_normalizers = jnp.log(cumsum_from_right + self.epsilon)
        log_probs = sorted_logits - log_normalizers
        log_probs = jnp.where(
            sorted_valid_mask, log_probs, jnp.zeros_like(log_probs)
        )

        nll = -jnp.sum(log_probs, axis=1, keepdims=True)
        nll = jnp.where(has_valid, nll, jnp.zeros_like(nll))
        return nll, jnp.ones_like(nll)

    def call(self, y_true: Any, y_pred: Tensor) -> Tensor:
        y_true, mask = unpack_labels_and_mask(y_true)
        y_pred = jnp.asarray(y_pred)
        y_true, y_pred, mask, _ = standardize_call_inputs_ranks(
            y_true, y_pred, mask
        )
        losses, weights = self.compute_unreduced_loss(
            labels=y_true, logits=y_pred, mask=mask
        )
        return jnp.squeeze(losses * weights, axis=-1)

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update({"temperature": self.temperature})
        return config
