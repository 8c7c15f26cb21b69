"""Fused row-wise embedding optimizers.

The reference delegates these to the SparseCore engine
(`tpu_sparse_dense_matmul_grad` applies the optimizer inside the kernel;
keras_rs/src/layers/embedding/jax/embedding_lookup.py:174-273, optimizer
specs converted in jax/config_conversion.py:211-336). Here they are pure
row-wise jnp functions applied to the gathered unique rows inside the
backward pass of the sharded lookup — fused with the scatter, never
materializing a dense gradient.

Semantics follow the Keras optimizers the reference converts from:
  * SGD:      w -= lr * g
  * Adagrad:  acc += g^2;  w -= lr * g / (sqrt(acc) + eps)
              (accumulator initialized to 0.1 like Keras/TPUEmbedding)
  * Adam:     bias-corrected moments, eps outside the sqrt
  * FTRL:     standard McMahan et al. update with lr_power=-0.5

Learning rates may be floats or callables step -> float (parity with
config_conversion.py:136-208).
"""

from __future__ import annotations

from typing import Any, Callable, Union

import jax.numpy as jnp

from keras_rs_tpu.types import Tensor

LearningRate = Union[float, Callable[[Tensor], Tensor]]


def _lr(learning_rate: LearningRate, step: Tensor) -> Tensor:
    if callable(learning_rate):
        return jnp.asarray(learning_rate(step), jnp.float32)
    return jnp.asarray(learning_rate, jnp.float32)


class EmbeddingOptimizer:
    """Base: stateless spec; slots are carried by the table store."""

    name = "base"
    slot_names: tuple[str, ...] = ()
    #: Slots listed here hold ONE f32 scalar per row ([rows] 1-D arrays)
    #: instead of a full [rows, dim] buffer — 4 bytes/row vs dim*4. Their
    #: `apply` inputs/outputs are [U] vectors. Used by RowWiseAdagrad so
    #: a bf16 capacity-mode table is not dominated by f32 slot HBM.
    rowwise_slots: tuple[str, ...] = ()

    def __init__(self, learning_rate: LearningRate = 0.001):
        self.learning_rate = learning_rate

    def init_slot(self, slot_name: str, shape, dtype=jnp.float32):
        raise NotImplementedError

    def apply(
        self,
        rows: Tensor,  # [U, dim] gathered table rows
        grads: Tensor,  # [U, dim] row gradients
        slots: dict[str, Tensor],  # each [U, dim]
        step: Tensor,  # scalar float step count (0-based)
    ) -> tuple[Tensor, dict[str, Tensor]]:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        lr = self.learning_rate
        if callable(lr):
            raise ValueError(
                "Callable learning rates cannot be serialized; pass a float."
            )
        return {"learning_rate": lr}

    @classmethod
    def from_config(cls, config: dict[str, Any]):
        return cls(**config)


class SGD(EmbeddingOptimizer):
    name = "sgd"
    slot_names = ()

    def __init__(self, learning_rate: LearningRate = 0.01):
        super().__init__(learning_rate)

    def apply(self, rows, grads, slots, step):
        return rows - _lr(self.learning_rate, step) * grads, {}


class Adagrad(EmbeddingOptimizer):
    name = "adagrad"
    slot_names = ("accumulator",)

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        initial_accumulator_value: float = 0.1,
        epsilon: float = 1e-7,
    ):
        super().__init__(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.epsilon = epsilon

    def init_slot(self, slot_name, shape, dtype=jnp.float32):
        return jnp.full(shape, self.initial_accumulator_value, dtype)

    def apply(self, rows, grads, slots, step):
        acc = slots["accumulator"] + jnp.square(grads)
        update = grads / (jnp.sqrt(acc) + self.epsilon)
        return rows - _lr(self.learning_rate, step) * update, {
            "accumulator": acc
        }

    def get_config(self):
        return {
            **super().get_config(),
            "initial_accumulator_value": self.initial_accumulator_value,
            "epsilon": self.epsilon,
        }


class RowWiseAdagrad(Adagrad):
    """Adagrad with ONE accumulator scalar per row (not per element).

    The accumulator integrates the row's squared-gradient NORM, the
    standard recsys memory/precision tradeoff (cf. TPUEmbedding's
    row-wise accumulation / torchrec ROWWISE_ADAGRAD):
      acc += sum(g^2);  w -= lr * g / (sqrt(acc) + eps)
    Sum (not mean) over the dim axis: stacked rows are zero-padded to
    the stack's dim, and a mean would be diluted by the padding columns
    (padded grads are exactly zero, so the sum is layout-invariant).
    Slot HBM is 4 bytes/row instead of 4*dim (512 at dim 128) — with a
    bfloat16 table the total state is ~260 B/row vs 1536 B split-f32,
    so capacity mode actually buys capacity. Beyond
    the reference's SparseCore optimizer set (its converter handles
    SGD/Adagrad/Adam/FTRL only — jax/config_conversion.py:211-336)."""

    name = "rowwise_adagrad"
    rowwise_slots = ("accumulator",)

    def apply(self, rows, grads, slots, step):
        acc = slots["accumulator"] + jnp.sum(
            jnp.square(grads), axis=-1
        )  # [U]
        update = grads / (jnp.sqrt(acc)[:, None] + self.epsilon)
        return rows - _lr(self.learning_rate, step) * update, {
            "accumulator": acc
        }


class Adam(EmbeddingOptimizer):
    name = "adam"
    slot_names = ("momentum", "velocity")

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-7,
    ):
        super().__init__(learning_rate)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon

    def init_slot(self, slot_name, shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    def apply(self, rows, grads, slots, step):
        t = step + 1.0
        m = self.beta_1 * slots["momentum"] + (1.0 - self.beta_1) * grads
        v = self.beta_2 * slots["velocity"] + (1.0 - self.beta_2) * jnp.square(
            grads
        )
        m_hat = m / (1.0 - jnp.power(self.beta_1, t))
        v_hat = v / (1.0 - jnp.power(self.beta_2, t))
        update = m_hat / (jnp.sqrt(v_hat) + self.epsilon)
        return rows - _lr(self.learning_rate, step) * update, {
            "momentum": m,
            "velocity": v,
        }

    def get_config(self):
        return {
            **super().get_config(),
            "beta_1": self.beta_1,
            "beta_2": self.beta_2,
            "epsilon": self.epsilon,
        }


class FTRL(EmbeddingOptimizer):
    name = "ftrl"
    slot_names = ("accumulator", "linear")

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        learning_rate_power: float = -0.5,
        initial_accumulator_value: float = 0.1,
        l1_regularization_strength: float = 0.0,
        l2_regularization_strength: float = 0.0,
        l2_shrinkage_regularization_strength: float = 0.0,
        beta: float = 0.0,
    ):
        super().__init__(learning_rate)
        self.learning_rate_power = learning_rate_power
        self.initial_accumulator_value = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength
        self.beta = beta

    def init_slot(self, slot_name, shape, dtype=jnp.float32):
        if slot_name == "accumulator":
            return jnp.full(shape, self.initial_accumulator_value, dtype)
        return jnp.zeros(shape, dtype)

    def apply(self, rows, grads, slots, step):
        # Full keras.optimizers.Ftrl semantics (keras/src/optimizers/
        # ftrl.py): the accumulator uses the RAW gradient; the linear
        # term uses the shrinkage-adjusted gradient g + 2*l2_shrinkage*w;
        # beta folds into the quadratic as beta/lr (i.e. l2 +=
        # beta/(2*lr)). The reference's converter passes beta through and
        # REJECTS l2_shrinkage (jax/config_conversion.py:266-283); here
        # both are supported in-kernel.
        lr = _lr(self.learning_rate, step)
        p = -self.learning_rate_power
        acc, linear = slots["accumulator"], slots["linear"]
        new_acc = acc + jnp.square(grads)
        sigma = (jnp.power(new_acc, p) - jnp.power(acc, p)) / lr
        grads_lin = (
            grads + 2.0 * self.l2_shrinkage * rows
            if self.l2_shrinkage
            else grads
        )
        new_linear = linear + grads_lin - sigma * rows
        quadratic = (
            jnp.power(new_acc, p) / lr + 2.0 * self.l2 + self.beta / lr
        )
        pruned = jnp.where(
            jnp.abs(new_linear) > self.l1,
            self.l1 * jnp.sign(new_linear) - new_linear,
            jnp.zeros_like(new_linear),
        )
        new_rows = pruned / quadratic
        return new_rows, {"accumulator": new_acc, "linear": new_linear}

    def get_config(self):
        return {
            **super().get_config(),
            "learning_rate_power": self.learning_rate_power,
            "initial_accumulator_value": self.initial_accumulator_value,
            "l1_regularization_strength": self.l1,
            "l2_regularization_strength": self.l2,
            "l2_shrinkage_regularization_strength": self.l2_shrinkage,
            "beta": self.beta,
        }


_BY_NAME = {
    "sgd": SGD,
    "adagrad": Adagrad,
    "rowwise_adagrad": RowWiseAdagrad,
    "adam": Adam,
    "ftrl": FTRL,
}


def get(identifier: Any) -> EmbeddingOptimizer:
    if isinstance(identifier, EmbeddingOptimizer):
        return identifier
    if isinstance(identifier, str):
        name = identifier.lower()
        if name not in _BY_NAME:
            raise ValueError(
                f"Unknown embedding optimizer {identifier!r}. Only "
                f"{sorted(_BY_NAME)} are supported (parity with the "
                "reference's SparseCore optimizer set)."
            )
        return _BY_NAME[name]()
    raise ValueError(f"Cannot interpret optimizer: {identifier!r}")


def serialize(optimizer: EmbeddingOptimizer) -> dict[str, Any]:
    return {"class_name": optimizer.name, "config": optimizer.get_config()}


def deserialize(spec: Any) -> EmbeddingOptimizer:
    if isinstance(spec, str):
        return get(spec)
    return _BY_NAME[spec["class_name"]].from_config(spec["config"])
