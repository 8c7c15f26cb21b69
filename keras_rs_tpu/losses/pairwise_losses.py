"""Pairwise ranking losses: hinge, logistic, soft zero-one, pairwise MSE.

JAX reimplementation of keras_rs/src/losses/pairwise_*.py. The
(B, L, L) pairwise tensors are built with broadcasts that XLA fuses into a
single elementwise pass; the final `sum` over the j axis keeps the output at
(B, L) per-item losses, matching the reference's reduction contract.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.losses.base import Loss, unpack_labels_and_mask
from keras_rs_tpu.ops.pairwise import apply_pairwise_op, pairwise_comparison
from keras_rs_tpu.ops.ranking import standardize_call_inputs_ranks
from keras_rs_tpu.types import Tensor


class PairwiseLoss(Loss):
    """Base class for pairwise ranking losses.

    loss = sum_i sum_j I(y_i > y_j) * pairwise_loss((s_i - s_j) / temperature)

    Labels < 0 are invalid and excluded; an optional mask (via the
    `{"labels", "mask"}` dict protocol for `y_true`) is ANDed in.
    Parity: keras_rs/src/losses/pairwise_loss.py:25-116.
    """

    def __init__(self, temperature: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if temperature <= 0.0:
            raise ValueError(
                "`temperature` should be a positive float. Received: "
                f"`temperature` = {temperature}."
            )
        self.temperature = temperature

    def pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
        raise NotImplementedError

    def compute_unreduced_loss(
        self,
        labels: Tensor,
        logits: Tensor,
        mask: Tensor | None = None,
    ) -> tuple[Tensor, Tensor]:
        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = jnp.logical_and(valid_mask, mask)

        pairwise_labels, pairwise_logits = pairwise_comparison(
            labels=labels,
            logits=logits,
            mask=valid_mask,
            logits_op=jnp.subtract,
        )
        pairwise_logits = pairwise_logits / jnp.asarray(
            self.temperature, pairwise_logits.dtype
        )
        return self.pairwise_loss(pairwise_logits), pairwise_labels

    def call(self, y_true: Any, y_pred: Tensor) -> Tensor:
        y_true, mask = unpack_labels_and_mask(y_true)
        y_pred = jnp.asarray(y_pred)
        y_true, y_pred, mask, _ = standardize_call_inputs_ranks(
            y_true, y_pred, mask
        )
        losses, weights = self.compute_unreduced_loss(
            labels=y_true, logits=y_pred, mask=mask
        )
        return jnp.sum(losses * weights, axis=-1)

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update({"temperature": self.temperature})
        return config


@export("keras_rs_tpu.losses.PairwiseHingeLoss")
class PairwiseHingeLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * max(0, 1 - (s_i - s_j)).

    Parity: keras_rs/src/losses/pairwise_hinge_loss.py:11-12.
    """

    def pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
        return jnp.maximum(1.0 - pairwise_logits, 0.0)


@export("keras_rs_tpu.losses.PairwiseLogisticLoss")
class PairwiseLogisticLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * log(1 + exp(-(s_i - s_j))).

    Computed in the numerically stable form relu(-d) + log1p(exp(-|d|)).
    Parity: keras_rs/src/losses/pairwise_logistic_loss.py:101-110.
    """

    def pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
        return jnp.maximum(-pairwise_logits, 0.0) + jnp.log(
            1.0 + jnp.exp(-jnp.abs(pairwise_logits))
        )


@export("keras_rs_tpu.losses.PairwiseSoftZeroOneLoss")
class PairwiseSoftZeroOneLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * soft_zero_one(s_i - s_j).

    soft_zero_one(d) = 1 - sigmoid(d) if d > 0 else sigmoid(-d).
    Parity: keras_rs/src/losses/pairwise_soft_zero_one_loss.py:11-16.
    """

    def pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
        return jnp.where(
            pairwise_logits > 0.0,
            1.0 - jax_sigmoid(pairwise_logits),
            jax_sigmoid(-pairwise_logits),
        )


def jax_sigmoid(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + jnp.exp(-x))


@export("keras_rs_tpu.losses.PairwiseMeanSquaredError")
class PairwiseMeanSquaredError(PairwiseLoss):
    """loss = sum_i sum_j ((y_i - y_j) - (s_i - s_j))^2 over valid pairs.

    Unlike the other pairwise losses, every valid ordered pair (not just
    those with y_i > y_j) contributes, excluding self-pairs.
    Parity: keras_rs/src/losses/pairwise_mean_squared_error.py:17-55.
    """

    def pairwise_loss(self, pairwise_logits: Tensor) -> Tensor:
        raise NotImplementedError  # unused: compute_unreduced_loss overridden

    def compute_unreduced_loss(
        self,
        labels: Tensor,
        logits: Tensor,
        mask: Tensor | None = None,
    ) -> tuple[Tensor, Tensor]:
        batch_size, list_size = labels.shape

        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = jnp.logical_and(valid_mask, mask)

        pairwise_labels_diff = apply_pairwise_op(labels, jnp.subtract)
        pairwise_logits_diff = apply_pairwise_op(logits, jnp.subtract)
        valid_pair = apply_pairwise_op(valid_mask, jnp.logical_and)
        pairwise_mse = jnp.square(pairwise_labels_diff - pairwise_logits_diff)

        pairwise_weights = jnp.ones_like(pairwise_mse)
        pairwise_weights = pairwise_weights - jnp.eye(
            list_size, dtype=pairwise_weights.dtype
        )
        pairwise_weights = pairwise_weights * valid_pair.astype(
            pairwise_weights.dtype
        )
        return pairwise_mse, pairwise_weights
