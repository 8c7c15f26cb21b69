"""Streaming binary-classification metrics: AUC and BinaryAccuracy.

The reference's DLRM workload evaluates with `keras.metrics.BinaryAccuracy`
and `keras.metrics.AUC` (examples/ml_perf/main.py:206-209; MLPerf's target
is AUC ~0.8275). JAX versions with the same design as the ranking
metrics: explicit pytree state + pure `update`, so the accumulation runs
INSIDE the jitted eval step (no device->host logits transfer per batch),
plus the thin stateful convenience API.

AUC follows Keras' thresholded Riemann approximation: `num_thresholds`
evenly spaced thresholds accumulate confusion-matrix counts; the result
trapezoid-integrates ROC. 200 thresholds matches keras.metrics.AUC's
default.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor

_EPSILON = 1e-7


class ConfusionState(NamedTuple):
    """Per-threshold confusion counts [T]."""

    tp: jax.Array
    fp: jax.Array
    tn: jax.Array
    fn: jax.Array


@export("keras_rs_tpu.metrics.AUC")
class AUC(Module):
    """Streaming ROC-AUC (thresholded approximation, Keras parity)."""

    def __init__(
        self,
        num_thresholds: int = 200,
        name: str | None = None,
        dtype: Any = jnp.float32,
    ) -> None:
        if num_thresholds < 2:
            raise ValueError("num_thresholds must be >= 2")
        self.num_thresholds = num_thresholds
        self.name = name or "auc"
        self.dtype = jnp.dtype(dtype)
        # Keras-style thresholds: {-eps, linspace interior, 1+eps}.
        inner = (
            jnp.arange(1, num_thresholds - 1, dtype=jnp.float32)
            / (num_thresholds - 1)
        )
        self.thresholds = jnp.concatenate(
            [
                jnp.asarray([-_EPSILON]),
                inner,
                jnp.asarray([1.0 + _EPSILON]),
            ]
        )
        self._state: ConfusionState | None = None

    # -- functional API ----------------------------------------------------
    def init_state(self) -> ConfusionState:
        z = jnp.zeros((self.num_thresholds,), self.dtype)
        return ConfusionState(tp=z, fp=z, tn=z, fn=z)

    def update(
        self,
        state: ConfusionState,
        y_true: Tensor,
        y_pred: Tensor,
        sample_weight: Tensor | None = None,
    ) -> ConfusionState:
        y_true = jnp.asarray(y_true, self.dtype).reshape(-1)
        y_pred = jnp.asarray(y_pred, self.dtype).reshape(-1)
        w = (
            jnp.ones_like(y_true)
            if sample_weight is None
            else jnp.broadcast_to(
                jnp.asarray(sample_weight, self.dtype), y_true.shape
            )
        )
        # [T, N] strict prediction > threshold (Keras parity: predictions
        # exactly equal to an interior threshold count as negative; the
        # -eps / 1+eps endpoint thresholds make the curve endpoints
        # all-positive / all-negative regardless).
        pred_pos = y_pred[None, :] > self.thresholds[:, None]
        pos = (y_true > 0.5)[None, :]
        w_b = w[None, :]
        tp = jnp.sum(jnp.where(pred_pos & pos, w_b, 0.0), axis=1)
        fp = jnp.sum(jnp.where(pred_pos & ~pos, w_b, 0.0), axis=1)
        tn = jnp.sum(jnp.where(~pred_pos & ~pos, w_b, 0.0), axis=1)
        fn = jnp.sum(jnp.where(~pred_pos & pos, w_b, 0.0), axis=1)
        return ConfusionState(
            tp=state.tp + tp,
            fp=state.fp + fp,
            tn=state.tn + tn,
            fn=state.fn + fn,
        )

    def result_from_state(self, state: ConfusionState) -> jax.Array:
        tpr = state.tp / jnp.maximum(state.tp + state.fn, _EPSILON)
        fpr = state.fp / jnp.maximum(state.fp + state.tn, _EPSILON)
        # Thresholds ascend => rates descend; trapezoid over FPR.
        return jnp.sum(
            (fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0
        )

    # -- stateful convenience ------------------------------------------------
    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(self, y_true, y_pred, sample_weight=None) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(
            self._state, y_true, y_pred, sample_weight
        )

    def result(self) -> jax.Array:
        if self._state is None:
            return jnp.zeros((), self.dtype)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {
            "num_thresholds": self.num_thresholds,
            "name": self.name,
        }


class MeanPair(NamedTuple):
    total: jax.Array
    count: jax.Array


@export("keras_rs_tpu.metrics.BinaryAccuracy")
class BinaryAccuracy(Module):
    """Streaming accuracy at a probability threshold (default 0.5)."""

    def __init__(
        self,
        threshold: float = 0.5,
        name: str | None = None,
        dtype: Any = jnp.float32,
    ) -> None:
        self.threshold = float(threshold)
        self.name = name or "binary_accuracy"
        self.dtype = jnp.dtype(dtype)
        self._state: MeanPair | None = None

    def init_state(self) -> MeanPair:
        z = jnp.zeros((), self.dtype)
        return MeanPair(total=z, count=z)

    def update(
        self,
        state: MeanPair,
        y_true: Tensor,
        y_pred: Tensor,
        sample_weight: Tensor | None = None,
    ) -> MeanPair:
        y_true = jnp.asarray(y_true, self.dtype).reshape(-1)
        y_pred = jnp.asarray(y_pred, self.dtype).reshape(-1)
        w = (
            jnp.ones_like(y_true)
            if sample_weight is None
            else jnp.broadcast_to(
                jnp.asarray(sample_weight, self.dtype), y_true.shape
            )
        )
        # Strict > like keras.metrics.binary_accuracy.
        correct = (y_pred > self.threshold) == (y_true > 0.5)
        return MeanPair(
            total=state.total + jnp.sum(jnp.where(correct, w, 0.0)),
            count=state.count + jnp.sum(w),
        )

    def result_from_state(self, state: MeanPair) -> jax.Array:
        return state.total / jnp.maximum(state.count, _EPSILON)

    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(self, y_true, y_pred, sample_weight=None) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(
            self._state, y_true, y_pred, sample_weight
        )

    def result(self) -> jax.Array:
        if self._state is None:
            return jnp.zeros((), self.dtype)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {"threshold": self.threshold, "name": self.name}
