"""DCNv2 FeatureCross layer.

JAX reimplementation of keras_rs/src/layers/feature_interaction/
feature_cross.py:12-194:
    x_{i+1} = x0 .* (pre_act(W x + b) + diag_scale * x) + x
with optional low-rank factorization W = U @ V via `projection_dim`.
XLA fuses everything else around the two matmuls.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from keras_rs_tpu.core import initializers
from keras_rs_tpu.core import regularizers as reg_lib
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor


@export("keras_rs_tpu.layers.FeatureCross")
class FeatureCross(Module):
    def __init__(
        self,
        dim: int,
        *,
        key: jax.Array,
        projection_dim: int | None = None,
        diag_scale: float | None = 0.0,
        use_bias: bool = True,
        pre_activation: Callable[[Tensor], Tensor] | None = None,
        kernel_initializer: Any = "glorot_uniform",
        bias_initializer: Any = "zeros",
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        dtype: Any = jnp.float32,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        name: str | None = None,
    ) -> None:
        if diag_scale is not None and diag_scale < 0.0:
            raise ValueError(
                "`diag_scale` should be non-negative. Received: "
                f"`diag_scale={diag_scale}`"
            )
        k_down, k_main, k_bias = jax.random.split(key, 3)
        kinit = initializers.get(kernel_initializer)
        if projection_dim is not None:
            self.down_proj_kernel = kinit(k_down, (dim, projection_dim), dtype)
            self.kernel = kinit(k_main, (projection_dim, dim), dtype)
        else:
            self.down_proj_kernel = None
            self.kernel = kinit(k_main, (dim, dim), dtype)
        self.bias = (
            initializers.get(bias_initializer)(k_bias, (dim,), dtype)
            if use_bias
            else None
        )
        self.dim = dim
        self.projection_dim = projection_dim
        self.diag_scale = diag_scale
        self.pre_activation = pre_activation
        # Weight penalties (parity: feature_cross.py:103-149 forwards
        # these to the Dense sublayers); collected by
        # core.regularizers.regularization_loss over the module tree.
        self.kernel_regularizer = reg_lib.get(kernel_regularizer)
        self.bias_regularizer = reg_lib.get(bias_regularizer)
        regs: dict[str, Any] = {}
        if self.kernel_regularizer is not None:
            regs["kernel"] = self.kernel_regularizer
            if projection_dim is not None:
                regs["down_proj_kernel"] = self.kernel_regularizer
        if self.bias_regularizer is not None and use_bias:
            regs["bias"] = self.bias_regularizer
        self._regularizers = regs
        self.compute_dtype = (
            None if compute_dtype is None else jnp.dtype(compute_dtype)
        )
        # bf16-resident mode: cast the projected `out` to `output_dtype`
        # before the x0*out+x combine so a bf16 residual stream stays
        # bf16 (an f32 `out` would promote the whole combine to f32).
        self.output_dtype = (
            None if output_dtype is None else jnp.dtype(output_dtype)
        )
        self.name = name or "feature_cross"

    def _matmul(self, x: Tensor, w: Tensor) -> Tensor:
        if self.compute_dtype is not None:
            return jnp.matmul(
                x.astype(self.compute_dtype),
                w.astype(self.compute_dtype),
                preferred_element_type=jnp.float32,
            ).astype(w.dtype)
        return jnp.matmul(x, w, preferred_element_type=x.dtype)

    def __call__(self, x0: Tensor, x: Tensor | None = None) -> Tensor:
        if x is None:
            x = x0
        if x0.shape != x.shape:
            raise ValueError(
                "`x0` and `x` should have the same shape. Received: "
                f"`x.shape` = {x.shape}, `x0.shape` = {x0.shape}"
            )
        out = x
        if self.down_proj_kernel is not None:
            out = self._matmul(out, self.down_proj_kernel)
        out = self._matmul(out, self.kernel)
        if self.bias is not None:
            out = out + self.bias
        if self.pre_activation is not None:
            out = self.pre_activation(out)
        if self.diag_scale:
            out = out + self.diag_scale * x
        if self.output_dtype is not None:
            out = out.astype(self.output_dtype)
        return x0 * out + x

    def get_config(self) -> dict[str, Any]:
        return {
            "dim": self.dim,
            "projection_dim": self.projection_dim,
            "diag_scale": self.diag_scale,
            "kernel_regularizer": reg_lib.serialize(self.kernel_regularizer),
            "bias_regularizer": reg_lib.serialize(self.bias_regularizer),
            "name": self.name,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "FeatureCross":
        config = dict(config)
        config["kernel_regularizer"] = reg_lib.deserialize(
            config.get("kernel_regularizer")
        )
        config["bias_regularizer"] = reg_lib.deserialize(
            config.get("bias_regularizer")
        )
        config.setdefault("key", jax.random.key(0))
        return cls(**config)
