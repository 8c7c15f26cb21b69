"""EmbedReduce: embedding lookup followed by a weighted combiner reduce.

JAX reimplementation of keras_rs/src/layers/embedding/
embed_reduce.py:91-274. Ragged/sparse inputs are standardized to the
jit-friendly padded-dense-plus-weights form: a (B, L) int id matrix plus a
(B, L) float weight matrix whose zeros mark padding. XLA lowers the lookup
to a gather and the combine to a fused multiply/segment reduction.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core import initializers
from keras_rs_tpu.core import regularizers as reg_lib
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.ops.ranking import divide_no_nan
from keras_rs_tpu.types import Tensor

SUPPORTED_COMBINERS = ("mean", "sum", "sqrtn")


@export("keras_rs_tpu.layers.EmbedReduce")
class EmbedReduce(Module):
    """Embeds 1-D or 2-D integer inputs; reduces the list axis if present.

    Combiner semantics (parity with the reference):
      * 1-D inputs: no reduction; "sum" still scales by weights, while
        "mean"/"sqrtn" ignore weights entirely.
      * 2-D inputs: weighted sum over axis -2, divided by sum(weights) for
        "mean" or sqrt(sum(weights^2)) for "sqrtn".
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        key: jax.Array | None = None,
        embeddings_initializer: Any = "random_uniform",
        embeddings_regularizer: Any = None,
        combiner: str = "mean",
        table: Tensor | None = None,
        dtype: Any = jnp.float32,
        name: str | None = None,
    ) -> None:
        if combiner not in SUPPORTED_COMBINERS:
            raise ValueError(
                f"Invalid `combiner`: '{combiner}', use one of "
                f"{', '.join(SUPPORTED_COMBINERS)}."
            )
        if table is not None:
            if tuple(table.shape) != (input_dim, output_dim):
                raise ValueError(
                    f"`table` shape {table.shape} does not match "
                    f"({input_dim}, {output_dim})."
                )
            self.embeddings = jnp.asarray(table, dtype)
        else:
            if key is None:
                raise ValueError("Provide `key` to initialize embeddings.")
            self.embeddings = initializers.get(embeddings_initializer)(
                key, (input_dim, output_dim), dtype
            )
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        # keras.layers.Embedding embeddings_regularizer parity; summed
        # by core.regularizers.regularization_loss.
        self.embeddings_regularizer = reg_lib.get(embeddings_regularizer)
        self._regularizers = (
            {"embeddings": self.embeddings_regularizer}
            if self.embeddings_regularizer is not None
            else {}
        )
        self.name = name or "embed_reduce"

    def __call__(
        self, inputs: Any, weights: Tensor | None = None
    ) -> Tensor:
        from keras_rs_tpu.data.ragged import Ragged
        from keras_rs_tpu.data.sparse_utils import bcoo_densify, is_bcoo

        if is_bcoo(inputs):
            # Sparse ids (reference embed_reduce.py:36-87): densify with
            # a 0/1 mask so masked positions (which read row 0) are
            # zeroed and excluded from combiner divisors.
            ids, mask = bcoo_densify(inputs)
            if is_bcoo(weights):
                weights = weights.todense()
            if weights is not None:
                mask = mask * np.asarray(weights, np.float32)
            inputs, weights = ids, mask
        elif is_bcoo(weights):
            raise ValueError("Sparse weights require sparse ids.")
        if isinstance(inputs, Ragged):
            # Densify with synthesized 0/1 weights (parity with the
            # reference's ragged handling, base_distributed_embedding
            # .py:31-92); explicit weights multiply into the mask.
            ids, mask = inputs.to_padded()
            if isinstance(weights, Ragged):
                if not np.array_equal(
                    np.asarray(weights.row_lengths),
                    np.asarray(inputs.row_lengths),
                ):
                    raise ValueError(
                        "Ragged weights row_lengths must equal the ids "
                        "row_lengths."
                    )
                wv, _ = weights.to_padded(max_length=ids.shape[1])
                mask = mask * np.asarray(wv, np.float32)
            elif weights is not None:
                mask = mask * np.asarray(weights, np.float32)
            inputs, weights = ids, mask
        elif isinstance(weights, Ragged):
            raise ValueError(
                "Ragged weights require Ragged ids (shapes must align)."
            )
        inputs = jnp.asarray(inputs)
        if inputs.ndim < 1:
            raise ValueError("`inputs` must have rank >= 1.")
        x = self._lookup(inputs)

        if inputs.ndim == 1:
            # No reduction; "sum" scales by weights, others ignore them.
            if weights is not None and self.combiner == "sum":
                weights = jnp.asarray(weights, x.dtype)
                x = x * weights[:, None]
            return x

        if weights is None:
            weights = jnp.ones(inputs.shape, x.dtype)
        else:
            weights = jnp.asarray(weights, x.dtype)
            if weights.shape != inputs.shape:
                raise ValueError(
                    f"`weights` shape {weights.shape} must match `inputs` "
                    f"shape {inputs.shape}."
                )

        x = x * weights[..., None]
        x = jnp.sum(x, axis=-2)
        if self.combiner == "mean":
            return divide_no_nan(x, jnp.sum(weights, axis=-1)[..., None])
        if self.combiner == "sqrtn":
            return divide_no_nan(
                x, jnp.sqrt(jnp.sum(jnp.square(weights), axis=-1))[..., None]
            )
        return x

    def _lookup(self, ids: Tensor) -> Tensor:
        """Row fetch hook; subclasses override the storage format."""
        return jnp.take(self.embeddings, ids, axis=0)

    def quantize_int8(self, layout: str = "rows") -> "QuantizedEmbedReduce":
        """Int8 per-row-quantized inference copy (4x less HBM)."""
        return QuantizedEmbedReduce.from_table(
            self.embeddings,
            combiner=self.combiner,
            name=self.name,
            layout=layout,
        )

    def get_config(self) -> dict[str, Any]:
        return {
            "input_dim": self.input_dim,
            "output_dim": self.output_dim,
            "combiner": self.combiner,
            "name": self.name,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "EmbedReduce":
        # Keras convention: the config round-trips the ARCHITECTURE;
        # weights are restored separately (checkpoint pytree leaves).
        config = dict(config)
        config.setdefault("key", jax.random.key(0))
        return cls(**config)


@export("keras_rs_tpu.layers.QuantizedEmbedReduce")
class QuantizedEmbedReduce(EmbedReduce):
    """`EmbedReduce` over an int8 per-row-quantized table (inference).

    Beyond the reference's surface (which has no quantized serving
    path): stores rows as int8 with a per-row f32 scale
    (ops/quant.py `quantize_rows_int8`) — 4x less serving HBM than
    f32 tables at <=absmax/254 per-element error, the same scheme the
    int8 asymmetric-hashing retrieval index uses. Build with
    `QuantizedEmbedReduce.from_table(...)`,
    `EmbedReduce.quantize_int8()`, or
    `DistributedEmbedding.freeze(quantize="int8")`.

    Combiner semantics are inherited unchanged; only the row fetch
    differs by `layout`:

      * "rows" (default): int8 [R, dim] gather + [R, 1] scale gather +
        dequant multiply.
      * "packed": 4 consecutive rows bitcast into one int32 [R/4, dim]
        group row (ops/quant.py pack_rows_int8_groups) — ONE 32-bit
        gather + an integer in-register select + a 1-D scale gather.
        Bit-identical outputs to "rows" (tools/probe_int8_serving.py
        times both).
      * "fused" (dim-128 only): 8 rows AND their 8 scales per int32
        [R/8, 384] group row (ops/quant.py pack_rows_int8_fused) — the
        scale rides the SAME gathered row as the data, so the separate
        [R]-scale gather goes, for 1.5 B/element (2.67x smaller than
        f32). Bit-identical outputs.
    """

    non_trainable_fields = ("q", "scale", "qp")

    def __init__(
        self,
        q: Tensor,
        scale: Tensor,
        *,
        combiner: str = "mean",
        name: str | None = None,
        layout: str = "rows",
    ) -> None:
        if combiner not in SUPPORTED_COMBINERS:
            raise ValueError(
                f"Invalid `combiner`: '{combiner}', use one of "
                f"{', '.join(SUPPORTED_COMBINERS)}."
            )
        if layout not in ("rows", "packed", "fused"):
            raise ValueError(
                f"Invalid `layout`: {layout!r} (use 'rows', 'packed' "
                "or 'fused')."
            )
        if layout == "fused" and jnp.asarray(q).shape[1] != 128:
            raise ValueError(
                "layout='fused' requires dim == 128 (one lane tile per "
                f"byte plane); got dim {jnp.asarray(q).shape[1]}."
            )
        q = jnp.asarray(q)
        scale = jnp.asarray(scale, jnp.float32)
        if q.dtype != jnp.int8 or q.ndim != 2:
            raise ValueError(
                f"`q` must be int8 [vocab, dim], got {q.dtype} {q.shape}."
            )
        if scale.shape != (q.shape[0], 1):
            raise ValueError(
                f"`scale` must be [vocab, 1], got {scale.shape}."
            )
        self.layout = layout
        if layout == "fused":
            from keras_rs_tpu.ops.quant import pack_rows_int8_fused

            self.qp = pack_rows_int8_fused(q, scale.reshape(-1))
            self.scale = jnp.zeros((0,), jnp.float32)  # lives in qp
        elif layout == "packed":
            from keras_rs_tpu.ops.quant import pack_rows_int8_groups

            self.qp = pack_rows_int8_groups(q)
            self.scale = scale.reshape(-1)  # 1-D [R]
        else:
            self.q = q
            self.scale = scale
        self.input_dim = int(q.shape[0])
        self.output_dim = int(q.shape[1])
        self.combiner = combiner
        self.embeddings_regularizer = None
        self._regularizers = {}
        self.name = name or "quantized_embed_reduce"

    @classmethod
    def _from_packed(
        cls,
        qp: Tensor,
        scale1d: Tensor,
        rows: int,
        *,
        combiner: str = "mean",
        name: str | None = None,
    ) -> "QuantizedEmbedReduce":
        """Wraps an ALREADY group-packed table (no repacking): shared-
        table features must reference the same qp/scale jax.Arrays or
        each feature would carry its own copy in HBM."""
        self = cls.__new__(cls)
        self.layout = "packed"
        self.qp = qp
        self.scale = scale1d
        self.input_dim = int(rows)
        self.output_dim = int(qp.shape[1])
        self.combiner = combiner
        self.embeddings_regularizer = None
        self._regularizers = {}
        self.name = name or "quantized_embed_reduce"
        return self

    @classmethod
    def _from_fused(
        cls,
        qp: Tensor,
        rows: int,
        *,
        combiner: str = "mean",
        name: str | None = None,
    ) -> "QuantizedEmbedReduce":
        """Wraps an ALREADY fused-packed table (no repacking): shared-
        table features must reference the same qp jax.Array."""
        import jax.numpy as _jnp

        self = cls.__new__(cls)
        self.layout = "fused"
        self.qp = qp
        self.scale = _jnp.zeros((0,), _jnp.float32)
        self.input_dim = int(rows)
        self.output_dim = 128
        self.combiner = combiner
        self.embeddings_regularizer = None
        self._regularizers = {}
        self.name = name or "quantized_embed_reduce"
        return self

    @classmethod
    def from_table(
        cls,
        table: Tensor,
        *,
        combiner: str = "mean",
        name: str | None = None,
        layout: str = "rows",
    ) -> "QuantizedEmbedReduce":
        from keras_rs_tpu.ops.quant import quantize_rows_int8

        q, scale = quantize_rows_int8(table)
        return cls(q, scale, combiner=combiner, name=name, layout=layout)

    @property
    def embeddings(self) -> Tensor:
        """Dequantized [vocab, dim] f32 view (export/debug only —
        materializes the full table; the hot path never calls it)."""
        from keras_rs_tpu.ops.quant import (
            dequantize_rows,
            unpack_rows_int8_groups,
        )

        if self.layout == "fused":
            from keras_rs_tpu.ops.quant import unpack_rows_int8_fused

            q, scale = unpack_rows_int8_fused(self.qp, self.input_dim)
            return dequantize_rows(q, scale[:, None])
        if self.layout == "packed":
            q = unpack_rows_int8_groups(self.qp, self.input_dim)
            return dequantize_rows(q, self.scale[:, None])
        return dequantize_rows(self.q, self.scale)

    def _lookup(self, ids: Tensor) -> Tensor:
        if self.layout == "fused":
            from keras_rs_tpu.ops.quant import take_rows_int8_fused

            return take_rows_int8_fused(self.qp, ids)
        if self.layout == "packed":
            from keras_rs_tpu.ops.quant import take_rows_int8_packed

            return take_rows_int8_packed(self.qp, self.scale, ids)
        rows = jnp.take(self.q, ids, axis=0).astype(jnp.float32)
        scales = jnp.take(self.scale, ids, axis=0)
        return rows * scales

    def get_config(self) -> dict[str, Any]:
        return {
            "input_dim": self.input_dim,
            "output_dim": self.output_dim,
            "combiner": self.combiner,
            "name": self.name,
            "layout": self.layout,
        }

    @classmethod
    def from_config(
        cls, config: dict[str, Any]
    ) -> "QuantizedEmbedReduce":
        # Architecture-only round-trip (Keras convention): q/scale are
        # placeholder-shaped here and restored from a checkpoint's
        # pytree leaves, like any other weight.
        config = dict(config)
        vocab = config.pop("input_dim")
        dim = config.pop("output_dim")
        return cls(
            jnp.zeros((vocab, dim), jnp.int8),
            jnp.ones((vocab, 1), jnp.float32),
            **config,
        )
