"""Accidental-hit removal for in-batch negative sampling.

JAX reimplementation of keras_rs/src/layers/retrieval/
remove_accidental_hits.py:26-97: negatives whose candidate id equals the
row's positive candidate id get a huge negative logit penalty so softmax
ignores them.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor

SMALLEST_FLOAT = float(np.finfo(np.float32).min / 100.0)


@export("keras_rs_tpu.layers.RemoveAccidentalHits")
class RemoveAccidentalHits(Module):
    def __init__(self, name: str | None = None):
        self.name = name or "remove_accidental_hits"

    def __call__(
        self, logits: Tensor, labels: Tensor, candidate_ids: Tensor
    ) -> Tensor:
        if labels.shape != logits.shape:
            raise ValueError(
                "`labels` and `logits` should have the same shape. Received: "
                f"`labels.shape` = {labels.shape}, "
                f"`logits.shape` = {logits.shape}."
            )
        if candidate_ids.shape != labels.shape[-candidate_ids.ndim:]:
            raise ValueError(
                "`candidate_ids` should match the last dimensions of "
                f"`labels`. Received: `candidate_ids.shape` = "
                f"{candidate_ids.shape}, `labels.shape` = {labels.shape}."
            )
        # Broadcast candidate ids up to the labels rank.
        while candidate_ids.ndim < labels.ndim:
            candidate_ids = candidate_ids[None, ...]

        positive_idx = jnp.argmax(labels, axis=-1, keepdims=True)
        positive_candidate_ids = jnp.take_along_axis(
            jnp.broadcast_to(candidate_ids, labels.shape),
            positive_idx,
            axis=-1,
        )
        duplicate = (positive_candidate_ids == candidate_ids).astype(
            labels.dtype
        )
        duplicate = duplicate - labels
        return logits + duplicate * SMALLEST_FLOAT

    def get_config(self) -> dict[str, Any]:
        return {"name": self.name}
