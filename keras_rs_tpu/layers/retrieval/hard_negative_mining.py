"""Hard negative mining.

JAX reimplementation of keras_rs/src/layers/retrieval/
hard_negative_mining.py:10-94: keep the top `num_hard_negatives` negatives
plus the positive by boosting the positive's logit with a large constant,
taking an (unsorted) top-k, and gathering.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor

# Large-but-safe boost; max float32 / 100 like the reference.
MAX_FLOAT = float(np.finfo(np.float32).max / 100.0)


@export("keras_rs_tpu.layers.HardNegativeMining")
class HardNegativeMining(Module):
    def __init__(self, num_hard_negatives: int, name: str | None = None):
        self.num_hard_negatives = num_hard_negatives
        self.name = name or "hard_negative_mining"

    def __call__(
        self, logits: Tensor, labels: Tensor
    ) -> tuple[Tensor, Tensor]:
        """Returns (logits, labels) restricted to the positive + top-k
        negatives per row. Shapes: (..., N) -> (..., k + 1)."""
        num_logits = logits.shape[-1]
        num_sampled = min(self.num_hard_negatives + 1, num_logits)
        # Boost positives so they always survive the top-k, avoiding an
        # explicit mask.
        _, indices = jax.lax.top_k(
            logits + labels * MAX_FLOAT, k=num_sampled
        )
        out_logits = jnp.take_along_axis(logits, indices, axis=-1)
        out_labels = jnp.take_along_axis(labels, indices, axis=-1)
        return out_logits, out_labels

    def get_config(self) -> dict[str, Any]:
        return {
            "num_hard_negatives": self.num_hard_negatives,
            "name": self.name,
        }
