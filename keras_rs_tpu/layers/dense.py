"""Dense / MLP building blocks.

The reference leans on `keras.layers.Dense`; these are the pytree-native
equivalents with explicit input dims (no lazy build — shapes are static by
construction, which is what XLA wants).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

from keras_rs_tpu.core import initializers
from keras_rs_tpu.core import regularizers as reg_lib
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.types import Tensor


class Dense(Module):
    """y = activation(x @ W + b)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        key: jax.Array,
        use_bias: bool = True,
        activation: Callable[[Tensor], Tensor] | None = None,
        kernel_initializer: Any = "glorot_uniform",
        bias_initializer: Any = "zeros",
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        dtype: Any = jnp.float32,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        name: str | None = None,
    ) -> None:
        k_kernel, k_bias = jax.random.split(key)
        self.kernel = initializers.get(kernel_initializer)(
            k_kernel, (in_features, out_features), dtype
        )
        self.bias = (
            initializers.get(bias_initializer)(
                k_bias, (out_features,), dtype
            )
            if use_bias
            else None
        )
        self.activation = activation
        # Weight penalties, summed by core.regularizers
        # .regularization_loss (keras Dense regularizer parity).
        kreg = reg_lib.get(kernel_regularizer)
        breg = reg_lib.get(bias_regularizer)
        regs: dict[str, Any] = {}
        if kreg is not None:
            regs["kernel"] = kreg
        if breg is not None and use_bias:
            regs["bias"] = breg
        self._regularizers = regs
        # Mixed precision: cast operands (typically to bfloat16 for the
        # tensor cores) while keeping parameters and accumulation in `dtype`.
        self.compute_dtype = (
            None if compute_dtype is None else jnp.dtype(compute_dtype)
        )
        # bf16-resident mode: keep the layer OUTPUT in `output_dtype`
        # (typically bfloat16) instead of round-tripping activations
        # through f32 between matmul fusions — halves the inter-layer
        # activation bytes XLA materializes while accumulation stays
        # f32 via preferred_element_type.
        self.output_dtype = (
            None if output_dtype is None else jnp.dtype(output_dtype)
        )
        self.name = name or "dense"

    def __call__(self, x: Tensor) -> Tensor:
        if self.compute_dtype is not None:
            y = jnp.matmul(
                x.astype(self.compute_dtype),
                self.kernel.astype(self.compute_dtype),
                preferred_element_type=jnp.float32,
            ).astype(self.kernel.dtype)
        else:
            y = jnp.matmul(x, self.kernel, preferred_element_type=x.dtype)
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        if self.output_dtype is not None:
            y = y.astype(self.output_dtype)
        return y


class MLP(Module):
    """Stack of Dense layers, e.g. DLRM bottom/top towers."""

    def __init__(
        self,
        in_features: int,
        units: Sequence[int],
        *,
        key: jax.Array,
        activation: Callable[[Tensor], Tensor] = jax.nn.relu,
        final_activation: Callable[[Tensor], Tensor] | None = None,
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        dtype: Any = jnp.float32,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        name: str | None = None,
    ) -> None:
        keys = jax.random.split(key, len(units))
        layers = []
        prev = in_features
        for i, (u, k) in enumerate(zip(units, keys)):
            act = activation if i < len(units) - 1 else final_activation
            layers.append(
                Dense(
                    prev, u, key=k, activation=act,
                    kernel_regularizer=kernel_regularizer,
                    bias_regularizer=bias_regularizer,
                    dtype=dtype,
                    compute_dtype=compute_dtype,
                    # Hidden activations may live in bf16; the stack's
                    # final output stays in param dtype (loss / concat
                    # callers decide their own precision).
                    output_dtype=(
                        output_dtype if i < len(units) - 1 else None
                    ),
                )
            )
            prev = u
        self.layers = layers
        self.name = name or "mlp"

    def __call__(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
