"""Transformer building blocks for SASRec-style sequence encoders.

The reference's sas_rec example composes keras-hub's ReversibleEmbedding,
PositionEmbedding and TransformerDecoder (examples/sas_rec.py:393-430).
Equivalents here: pre-norm residual blocks, learned position
embeddings, and causal multi-head self-attention as an XLA einsum pair
(QK^T / softmax / PV). The [B, H, T, T] probabilities are materialized;
the reference's SASRec caps context at 200 (examples/sas_rec.py:44).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from keras_rs_tpu.core import initializers
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.layers.dense import Dense
from keras_rs_tpu.types import Tensor


class Embedding(Module):
    """Plain [vocab, dim] lookup with optional reverse (tied) projection.

    `attend(x)` computes logits against the table — the ReversibleEmbedding
    behavior used by SASRec.
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        key: jax.Array,
        embeddings_initializer: Any = "random_normal",
        dtype: Any = jnp.float32,
        name: str | None = None,
    ) -> None:
        self.embeddings = initializers.get(embeddings_initializer)(
            key, (input_dim, output_dim), dtype
        )
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.name = name or "embedding"

    def __call__(self, ids: Tensor) -> Tensor:
        return jnp.take(self.embeddings, ids, axis=0)

    def attend(self, x: Tensor) -> Tensor:
        return jnp.matmul(
            x, self.embeddings.T, preferred_element_type=x.dtype
        )


class PositionEmbedding(Module):
    """Learned position embeddings added to the sequence."""

    def __init__(
        self,
        max_length: int,
        dim: int,
        *,
        key: jax.Array,
        dtype: Any = jnp.float32,
    ) -> None:
        self.embeddings = initializers.GlorotUniform()(
            key, (max_length, dim), dtype
        )
        self.max_length = max_length

    def __call__(self, x: Tensor) -> Tensor:
        T = x.shape[-2]
        return self.embeddings[:T]


class LayerNorm(Module):
    def __init__(self, dim: int, *, epsilon: float = 1e-6,
                 dtype: Any = jnp.float32):
        self.scale = jnp.ones((dim,), dtype)
        self.offset = jnp.zeros((dim,), dtype)
        self.epsilon = epsilon

    def __call__(self, x: Tensor) -> Tensor:
        mean = jnp.mean(x, axis=-1, keepdims=True)
        var = jnp.var(x, axis=-1, keepdims=True)
        inv = jax.lax.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.scale + self.offset


class MultiHeadSelfAttention(Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        *,
        key: jax.Array,
        dtype: Any = jnp.float32,
    ) -> None:
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        kq, kk, kv, ko = jax.random.split(key, 4)
        init = initializers.GlorotUniform()
        self.wq = init(kq, (dim, dim), dtype)
        self.wk = init(kk, (dim, dim), dtype)
        self.wv = init(kv, (dim, dim), dtype)
        self.wo = init(ko, (dim, dim), dtype)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads

    def __call__(
        self,
        x: Tensor,
        padding_mask: Tensor | None = None,
        causal: bool = True,
    ) -> Tensor:
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim

        def proj(w):
            return jnp.matmul(
                x, w, preferred_element_type=x.dtype
            ).reshape(B, T, H, hd)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        logits = jnp.einsum(
            "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
        ) / jnp.sqrt(jnp.asarray(hd, jnp.float32))

        neg = jnp.asarray(-1e9, logits.dtype)
        if causal:
            causal_mask = jnp.tril(jnp.ones((T, T), bool))
            logits = jnp.where(causal_mask[None, None], logits, neg)
        if padding_mask is not None:
            # padding_mask: [B, T] keys that are real.
            logits = jnp.where(
                padding_mask[:, None, None, :].astype(bool), logits, neg
            )
        probs = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
        out = jnp.einsum(
            "bhqk,bkhd->bqhd", probs, v, preferred_element_type=x.dtype
        ).reshape(B, T, D)
        return jnp.matmul(out, self.wo, preferred_element_type=x.dtype)


class TransformerBlock(Module):
    """Pre-norm causal decoder block: MHA + MLP with residuals."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_dim: int,
        *,
        key: jax.Array,
        dtype: Any = jnp.float32,
    ) -> None:
        k_attn, k_mlp1, k_mlp2 = jax.random.split(key, 3)
        self.attention = MultiHeadSelfAttention(
            dim, num_heads, key=k_attn, dtype=dtype
        )
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp_in = Dense(
            dim, mlp_dim, key=k_mlp1, activation=jax.nn.relu, dtype=dtype
        )
        self.mlp_out = Dense(mlp_dim, dim, key=k_mlp2, dtype=dtype)

    def __call__(
        self, x: Tensor, padding_mask: Tensor | None = None
    ) -> Tensor:
        x = x + self.attention(
            self.norm1(x), padding_mask=padding_mask, causal=True
        )
        x = x + self.mlp_out(self.mlp_in(self.norm2(x)))
        return x
