"""DLRM DotInteraction layer.

JAX reimplementation of keras_rs/src/layers/feature_interaction/
dot_interaction.py:12-222: stack features, one batched matmul, then
either a static lower-triangular gather or a tril-mask + flatten
(`skip_gather=True`, which avoids the gather at the cost of a larger
output — usually the right trade on accelerators where the downstream matmul is
cheap and gathers are not).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor


@export("keras_rs_tpu.layers.DotInteraction")
class DotInteraction(Module):
    def __init__(
        self,
        self_interaction: bool = False,
        skip_gather: bool = False,
        name: str | None = None,
    ) -> None:
        self.self_interaction = self_interaction
        self.skip_gather = skip_gather
        self.name = name or "dot_interaction"

    def _lower_triangular_indices(self, num_features: int) -> np.ndarray:
        rows, cols = np.tril_indices(
            num_features, k=0 if self.self_interaction else -1
        )
        return rows * num_features + cols

    def __call__(self, inputs: Sequence[Tensor]) -> Tensor:
        shape = inputs[0].shape
        for idx, t in enumerate(inputs):
            if t.ndim != 2:
                raise ValueError(
                    "All feature tensors inside `inputs` should have rank 2. "
                    f"Received rank {t.ndim} at index {idx}."
                )
            if t.shape != shape:
                raise ValueError(
                    "All feature tensors in `inputs` should have the same "
                    f"shape. Found {shape} at index 0 and {t.shape} at "
                    f"index {idx}."
                )

        features = jnp.stack(inputs, axis=1)  # (B, F, D)
        batch_size, num_features, _ = features.shape
        interactions = jnp.matmul(
            features,
            jnp.swapaxes(features, 1, 2),
            preferred_element_type=features.dtype,
        )  # (B, F, F)

        if self.skip_gather:
            k = 0 if self.self_interaction else -1
            tril = jnp.tril(
                jnp.ones((num_features, num_features), bool), k=k
            )
            out = interactions * tril.astype(interactions.dtype)
            return out.reshape(batch_size, num_features * num_features)

        flat = interactions.reshape(batch_size, num_features * num_features)
        idx = self._lower_triangular_indices(num_features)
        return jnp.take(flat, idx, axis=-1)

    def output_dim(self, num_features: int) -> int:
        if self.skip_gather:
            return num_features * num_features
        if self.self_interaction:
            return num_features * (num_features + 1) // 2
        return num_features * (num_features - 1) // 2

    def get_config(self) -> dict[str, Any]:
        return {
            "self_interaction": self.self_interaction,
            "skip_gather": self.skip_gather,
            "name": self.name,
        }
