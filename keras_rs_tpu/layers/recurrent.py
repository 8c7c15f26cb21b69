"""GRU layer for sequential retrieval (GRU4Rec).

The reference's sequential_retrieval example uses `keras.layers.GRU`
(examples/sequential_retrieval.py:300-306). JAX formulation: the
input projections for ALL timesteps are computed as one batched matmul
(one large matmul), and only the small recurrent matmul runs inside
`lax.scan`. Padded steps (mask == 0) carry the previous state through.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from keras_rs_tpu.core import initializers
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.types import Tensor


class GRU(Module):
    """Gated recurrent unit returning the final hidden state.

    Gate math matches Keras (`reset_after=True` CuDNN-compatible variant):
        z = sigmoid(x Wz + h Uz + bz)
        r = sigmoid(x Wr + h Ur + br)
        h~ = tanh(x Wh + r * (h Uh + bh))
        h' = z * h + (1 - z) * h~
    """

    def __init__(
        self,
        input_dim: int,
        units: int,
        *,
        key: jax.Array,
        dtype: Any = jnp.float32,
        name: str | None = None,
    ) -> None:
        k_kernel, k_rec = jax.random.split(key)
        self.kernel = initializers.GlorotUniform()(
            k_kernel, (input_dim, 3 * units), dtype
        )
        # Keras initializes recurrent kernels orthogonally; a scaled
        # normal is a close, cheap stand-in with the same spectral scale.
        self.recurrent_kernel = initializers.VarianceScaling(
            1.0, "fan_in", "normal"
        )(k_rec, (units, 3 * units), dtype)
        self.bias = jnp.zeros((3 * units,), dtype)
        self.recurrent_bias = jnp.zeros((3 * units,), dtype)
        self.units = units
        self.input_dim = input_dim
        self.name = name or "gru"

    def __call__(
        self, x: Tensor, mask: Tensor | None = None
    ) -> Tensor:
        """x: [B, T, input_dim]; mask: [B, T] (1 = real step).

        Returns the last hidden state [B, units].
        """
        B, T, _ = x.shape
        H = self.units
        # One big matmul for all timesteps.
        xz = (
            jnp.matmul(x, self.kernel, preferred_element_type=x.dtype)
            + self.bias
        )  # [B, T, 3H]
        xz = jnp.moveaxis(xz, 1, 0)  # [T, B, 3H] for scan
        if mask is None:
            mask_t = jnp.ones((T, B, 1), x.dtype)
        else:
            mask_t = jnp.moveaxis(
                mask.astype(x.dtype)[..., None], 1, 0
            )

        def step(h, inp):
            x3, m = inp
            rec = (
                jnp.matmul(
                    h,
                    self.recurrent_kernel,
                    preferred_element_type=h.dtype,
                )
                + self.recurrent_bias
            )
            xz_, xr_, xh_ = jnp.split(x3, 3, axis=-1)
            rz_, rr_, rh_ = jnp.split(rec, 3, axis=-1)
            z = jax.nn.sigmoid(xz_ + rz_)
            r = jax.nn.sigmoid(xr_ + rr_)
            h_tilde = jnp.tanh(xh_ + r * rh_)
            new_h = z * h + (1.0 - z) * h_tilde
            h = m * new_h + (1.0 - m) * h
            return h, None

        h0 = jnp.zeros((B, H), x.dtype)
        h_final, _ = jax.lax.scan(step, h0, (xz, mask_t))
        return h_final
