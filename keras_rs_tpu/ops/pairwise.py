"""Pairwise comparison utilities for ranking losses.

Parity: keras_rs/src/losses/pairwise_loss_utils.py. Builds the
(batch, list, list) pairwise structures; XLA fuses the broadcasts into a
single fused pass so no materialization tricks are needed.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from keras_rs_tpu.types import Tensor


def apply_pairwise_op(
    x: Tensor, op: Callable[[Tensor, Tensor], Tensor]
) -> Tensor:
    """op(x_i, x_j) for all (i, j) pairs along the last axis: (..., L, L)."""
    return op(jnp.expand_dims(x, -1), jnp.expand_dims(x, -2))


def pairwise_comparison(
    labels: Tensor,
    logits: Tensor,
    mask: Tensor | None,
    logits_op: Callable[[Tensor, Tensor], Tensor],
) -> tuple[Tensor, Tensor]:
    """Pairwise label indicators and pairwise logit combinations.

    `pairwise_labels[b, i, j] = 1 if labels[b, i] > labels[b, j]` (and both
    valid under `mask`), `pairwise_logits[b, i, j] = op(s_i, s_j)`.
    """
    pairwise_labels_diff = apply_pairwise_op(labels, jnp.subtract)
    pairwise_logits = apply_pairwise_op(logits, logits_op)

    pairwise_labels = (pairwise_labels_diff > 0).astype(labels.dtype)
    if mask is not None:
        valid_pairs = apply_pairwise_op(mask, jnp.logical_and)
        pairwise_labels = pairwise_labels * valid_pairs.astype(
            pairwise_labels.dtype
        )
    return pairwise_labels, pairwise_logits
