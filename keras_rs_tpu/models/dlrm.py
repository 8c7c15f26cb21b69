"""DLRM-DCNv2: the flagship MLPerf workload model.

Capability parity with examples/ml_perf/model.py:42-336 (the reference's
`DLRMDCNV2`): bottom MLP over dense features -> concat with large
(sharded DistributedEmbedding) and small (in-model EmbedReduce) embedding
activations -> DCN block of low-rank FeatureCross layers -> top MLP ->
sigmoid. The small/large split by vocabulary threshold mirrors
examples/ml_perf/main.py:129-143.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.layers.dense import MLP
from keras_rs_tpu.layers.embedding import optimizers as opt_lib
from keras_rs_tpu.layers.embedding.config import FeatureConfig, TableConfig
from keras_rs_tpu.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu.layers.feature_interaction.feature_cross import FeatureCross
from keras_rs_tpu.types import Tensor


class DLRMConfig:
    """Criteo-shaped configuration (defaults mirror configs/v6e_8.py)."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        multi_hot_sizes: Sequence[int] | None = None,
        num_dense_features: int = 13,
        embedding_dim: int = 128,
        bottom_mlp: Sequence[int] = (512, 256, 128),
        top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1),
        num_dcn_layers: int = 3,
        dcn_projection_dim: int = 512,
        embedding_threshold: int = 21000,
        max_ids_per_partition: int = 8192,
        max_unique_ids_per_partition: int = 4096,
        learning_rate: float = 0.0034,
        global_batch_size: int = 256,
        table_placement: str = "auto",
        table_dtype: str = "float32",
        compute_dtype: str | None = "bfloat16",
        embedding_optimizer: str = "adagrad",
        dense_output_dtype: str | None = "bfloat16",
        embedding_comm_dtype: str | None = None,
    ):
        self.vocab_sizes = list(vocab_sizes)
        self.multi_hot_sizes = list(
            multi_hot_sizes
            if multi_hot_sizes is not None
            else [1] * len(vocab_sizes)
        )
        self.num_dense_features = num_dense_features
        self.embedding_dim = embedding_dim
        self.bottom_mlp = list(bottom_mlp)
        self.top_mlp = list(top_mlp)
        self.num_dcn_layers = num_dcn_layers
        self.dcn_projection_dim = dcn_projection_dim
        self.embedding_threshold = embedding_threshold
        self.max_ids_per_partition = max_ids_per_partition
        self.max_unique_ids_per_partition = max_unique_ids_per_partition
        self.learning_rate = learning_rate
        self.global_batch_size = global_batch_size
        self.table_placement = table_placement
        self.table_dtype = table_dtype
        self.compute_dtype = compute_dtype
        #: "adagrad" (reference parity, configs/v6e_8.py:195) or
        #: "rowwise_adagrad" (scalar-per-row accumulator — pairs with
        #: table_dtype="bfloat16" for the HBM-capacity mode).
        self.embedding_optimizer = embedding_optimizer
        #: "bfloat16" (default) keeps the dense stack's ACTIVATIONS
        #: resident in bf16 between matmul fusions (params and
        #: accumulation stay f32) — halves inter-fusion activation
        #: bytes (tools/probe_dense_mfu.py times the variants).
        #: None/"float32" = f32 activations (reference-parity
        #: numerics).
        self.dense_output_dtype = (
            None if dense_output_dtype == "float32"
            else dense_output_dtype
        )
        #: "bfloat16" sends the embedding exchange (fwd reduce-scatter,
        #: bwd all-gather) in bf16 — half the exchange bytes per step
        #: on multi-device meshes (lookup.stack_lookup).
        self.embedding_comm_dtype = embedding_comm_dtype


class DLRMDCNv2(Module):
    def __init__(
        self,
        config: DLRMConfig,
        *,
        key: jax.Array,
        mesh=None,
        axis_name: Any = "data",
        dtype: Any = jnp.float32,
    ) -> None:
        cfg = config
        k_bot, k_emb, k_small, k_dcn, k_top = jax.random.split(key, 5)

        # Split categorical features: large vocab -> sharded embedding,
        # small vocab -> in-model dense lookup (main.py:129-143 parity).
        self.large_idx = [
            i
            for i, v in enumerate(cfg.vocab_sizes)
            if v >= cfg.embedding_threshold
        ]
        self.small_idx = [
            i
            for i, v in enumerate(cfg.vocab_sizes)
            if v < cfg.embedding_threshold
        ]

        feature_configs = {}
        for i in self.large_idx:
            table = TableConfig(
                name=f"table_{i}",
                vocabulary_size=cfg.vocab_sizes[i],
                embedding_dim=cfg.embedding_dim,
                optimizer=opt_lib.deserialize(
                    {
                        "class_name": cfg.embedding_optimizer,
                        "config": {
                            "learning_rate": cfg.learning_rate
                        },
                    }
                ),
                combiner="sum",
                placement=cfg.table_placement,
                dtype=cfg.table_dtype,
                max_ids_per_partition=cfg.max_ids_per_partition,
                max_unique_ids_per_partition=(
                    cfg.max_unique_ids_per_partition
                ),
            )
            feature_configs[f"cat_{i}"] = FeatureConfig(
                name=f"cat_{i}",
                table=table,
                input_shape=(
                    cfg.global_batch_size,
                    cfg.multi_hot_sizes[i],
                ),
                output_shape=(
                    cfg.global_batch_size,
                    cfg.embedding_dim,
                ),
            )
        self.embedding_layer = (
            DistributedEmbedding(
                feature_configs, key=k_emb, mesh=mesh,
                axis_name=axis_name, dtype=dtype,
                comm_dtype=cfg.embedding_comm_dtype,
            )
            if feature_configs
            else None
        )

        small_keys = jax.random.split(k_small, max(1, len(self.small_idx)))
        self.small_embeddings = {
            f"cat_{i}": EmbedReduce(
                cfg.vocab_sizes[i],
                cfg.embedding_dim,
                key=kk,
                combiner="sum",
                dtype=dtype,
                name=f"small_{i}",
            )
            for i, kk in zip(self.small_idx, small_keys)
        }

        self.bottom_mlp = MLP(
            cfg.num_dense_features, cfg.bottom_mlp, key=k_bot, dtype=dtype,
            compute_dtype=cfg.compute_dtype,
            output_dtype=cfg.dense_output_dtype,
        )
        num_feats = 1 + len(cfg.vocab_sizes)  # dense block + categoricals
        concat_dim = cfg.bottom_mlp[-1] + cfg.embedding_dim * len(
            cfg.vocab_sizes
        )
        del num_feats
        dcn_keys = jax.random.split(k_dcn, cfg.num_dcn_layers)
        self.dcn_layers = [
            FeatureCross(
                concat_dim,
                key=kk,
                projection_dim=cfg.dcn_projection_dim,
                dtype=dtype,
                compute_dtype=cfg.compute_dtype,
                output_dtype=cfg.dense_output_dtype,
            )
            for kk in dcn_keys
        ]
        self.top_mlp = MLP(
            concat_dim, cfg.top_mlp, key=k_top, dtype=dtype,
            compute_dtype=cfg.compute_dtype,
            output_dtype=cfg.dense_output_dtype,
        )
        self.config = cfg

    def preprocess(self, batch: dict, training: bool = False) -> dict:
        """Host-side step: run the embedding preprocessing on the batch."""
        out = dict(batch)
        if self.embedding_layer is not None:
            large = {
                f"cat_{i}": batch[f"cat_{i}"] for i in self.large_idx
            }
            out["large_pre"] = self.embedding_layer.preprocess(
                large, training=training
            )
            for i in self.large_idx:
                del out[f"cat_{i}"]
        return out

    def preprocess_on_device(self, batch: dict) -> dict:
        """Jittable preprocessing: raw ids -> COO, entirely on-device.

        Compiles into the train step (call inside jit / the loss fn), so
        the host never touches the per-batch COO transform.
        """
        out = dict(batch)
        if self.embedding_layer is not None:
            large = {
                f"cat_{i}": batch[f"cat_{i}"] for i in self.large_idx
            }
            out["large_pre"] = self.embedding_layer.preprocess_on_device(
                large
            )
            for i in self.large_idx:
                del out[f"cat_{i}"]
        return out

    def __call__(self, batch: dict) -> Tensor:
        """Returns logits (pre-sigmoid) for the batch."""
        dense_out = self.bottom_mlp(batch["dense"])

        parts = [dense_out]
        if "large_acts" in batch:
            # Precomputed embedding activations (used by bench.py's
            # dense-only roofline measurement): the embedding engine is
            # bypassed entirely.
            acts = batch["large_acts"]
        elif self.embedding_layer is not None:
            acts = self.embedding_layer(batch["large_pre"])
        else:
            acts = {}
        for i in range(len(self.config.vocab_sizes)):
            name = f"cat_{i}"
            if i in self.large_idx:
                parts.append(acts[name])
            else:
                ids = batch[name]
                parts.append(self.small_embeddings[name](ids))
        x0 = jnp.concatenate(parts, axis=-1)
        if self.config.dense_output_dtype is not None:
            # bf16-resident DCN/top-MLP stream: one cast at the concat
            # (embedding activations arrive f32) instead of a f32
            # round-trip per cross layer.
            x0 = x0.astype(self.config.dense_output_dtype)

        x = x0
        for layer in self.dcn_layers:
            x = layer(x0, x)
        return self.top_mlp(x)[..., 0]


def bce_loss(model: DLRMDCNv2, batch: dict) -> Tensor:
    """Sigmoid binary cross-entropy (examples/ml_perf/main.py:201-210)."""
    logits = model(batch)
    labels = batch["label"]
    return jnp.mean(
        jnp.maximum(logits, 0.0)
        - logits * labels
        + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    )
