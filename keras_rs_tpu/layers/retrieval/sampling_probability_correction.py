"""Sampling probability correction (logQ correction).

JAX reimplementation of keras_rs/src/layers/retrieval/
sampling_probability_correction.py:39-58:
    logits - log(clip(p, eps, 1)).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor


@export("keras_rs_tpu.layers.SamplingProbabilityCorrection")
class SamplingProbabilityCorrection(Module):
    def __init__(self, epsilon: float = 1e-6, name: str | None = None):
        self.epsilon = epsilon
        self.name = name or "sampling_probability_correction"

    def __call__(
        self, logits: Tensor, candidate_sampling_probability: Tensor
    ) -> Tensor:
        return logits - jnp.log(
            jnp.clip(candidate_sampling_probability, self.epsilon, 1.0)
        )

    def get_config(self) -> dict[str, Any]:
        return {"epsilon": self.epsilon, "name": self.name}
