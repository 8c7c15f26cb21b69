"""Serving deployment walkthrough: freeze, quantize, export, shard.

The reference leaves serving to Keras (`model.predict`; retrieval layers
are attached at inference time, reference examples/basic_retrieval.py:
260-269). In production, serving wants more than predict(): fixed
shapes with no retrace risk, artifacts a model-code-free server can
load, and an HBM story for big tables. This example walks the four
deployment shapes this framework provides, on a trained
DistributedEmbedding + dense scorer:

  1. `freeze()`              — slot-free single-device tables + AOT
                               compile (serving.aot_compile): the hot
                               path is device execution only.
  2. `freeze(quantize="int8")` — int8 per-row tables: ~4x less serving
                               HBM / artifact payload at <= absmax/254
                               per-element error (ops/quant.py).
  3. `export_fn / import_fn` — portable StableHLO artifact served
                               WITHOUT the model code (jax.export).
  4. `serving_copy()`        — tables that only exist SHARDED: same
                               mesh, optimizer slots dropped
                               shard-locally, no host gather.

Run: python examples/serving_deployment.py
"""

import numpy as np

import jax
import jax.numpy as jnp
import optax

from keras_rs_tpu import serving, training
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.layers.dense import MLP
from keras_rs_tpu.layers.embedding.config import FeatureConfig, TableConfig
from keras_rs_tpu.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)

B = 64


class Scorer(Module):
    """Embedding layer + MLP head over the concatenated activations."""

    def __init__(self, key: jax.Array) -> None:
        k_emb, k_mlp = jax.random.split(key)
        user_t = TableConfig(
            "users", 2048, 32, optimizer="adagrad", combiner="mean",
            placement="sharded", max_ids_per_partition=256,
            max_unique_ids_per_partition=256,
        )
        item_t = TableConfig(
            "items", 4096, 32, optimizer="adagrad", combiner="mean",
            placement="sharded", max_ids_per_partition=1024,
            max_unique_ids_per_partition=512,
        )
        self.embedding = DistributedEmbedding(
            {
                "user_id": FeatureConfig(
                    "user_id", user_t, (B, 1), (B, 32)
                ),
                "item_history": FeatureConfig(
                    "item_history", item_t, (B, 8), (B, 32)
                ),
                "item_id": FeatureConfig(
                    "item_id", item_t, (B, 1), (B, 32)
                ),
            },
            key=k_emb,
        )
        self.head = MLP(96, [64, 1], key=k_mlp)

    def __call__(self, pre: dict) -> jax.Array:
        acts = self.embedding(pre)
        x = jnp.concatenate(
            [acts["user_id"], acts["item_history"], acts["item_id"]],
            axis=-1,
        )
        return self.head(x)[:, 0]


def make_batch(rng):
    return {
        "user_id": rng.integers(0, 2048, (B, 1)),
        "item_history": rng.integers(0, 4096, (B, 8)),
        "item_id": rng.integers(0, 4096, (B, 1)),
    }


def main():
    rng = np.random.default_rng(0)
    model = Scorer(jax.random.key(0))

    # Brief training so the tables hold learned (non-init) rows.
    def loss_fn(m, batch):
        logits = m(batch["pre"])
        return optax.sigmoid_binary_cross_entropy(
            logits, batch["label"]
        ).mean()

    step = training.make_train_step(
        loss_fn, optax.adagrad(0.1), donate=False
    )
    state = training.create_train_state(model, optax.adagrad(0.1))
    for i in range(5):
        raw = make_batch(rng)
        batch = {
            "pre": model.embedding.preprocess(raw, training=True),
            "label": (rng.random(B) > 0.5).astype(np.float32),
        }
        state, loss = step(state, batch)
    model = state.model
    print(f"trained 5 steps, loss {float(loss):.4f}")

    raw = make_batch(rng)
    want = np.asarray(
        jax.jit(lambda m, pre: m(pre))(
            model, model.embedding.preprocess(raw)
        )
    )

    # --- 1. freeze + AOT ---------------------------------------------------
    frozen = model.embedding.freeze()

    def serve_frozen(frozen_emb, head, raw):
        acts = frozen_emb(raw)
        x = jnp.concatenate(
            [acts["user_id"], acts["item_history"], acts["item_id"]],
            axis=-1,
        )
        return head(x)[:, 0]

    compiled = serving.aot_compile(serve_frozen, frozen, model.head, raw)
    got = np.asarray(compiled(frozen, model.head, raw))
    err = np.abs(got - want).max()
    print(f"frozen+AOT max |score delta| vs training layer: {err:.2e}")
    assert err < 1e-4

    # --- 2. int8 quantized tables ------------------------------------------
    frozen_q = model.embedding.freeze(quantize="int8")
    got_q = np.asarray(serve_frozen(frozen_q, model.head, raw))
    # Unique buffers only: shared-table features alias the SAME
    # jax.Array inside FrozenEmbedding, so naive tree_leaves would
    # count the shared `items` table once per feature.
    def unique_bytes(tree):
        return sum(
            x.nbytes
            for x in {
                id(x): x for x in jax.tree_util.tree_leaves(tree)
            }.values()
        )

    f32_b = unique_bytes(frozen)
    q_b = unique_bytes(frozen_q)
    print(
        f"int8 tables: {q_b / 1e3:.0f} kB vs f32 {f32_b / 1e3:.0f} kB "
        f"({f32_b / q_b:.1f}x smaller), "
        f"max |score delta| {np.abs(got_q - want).max():.2e}"
    )

    # --- 3. portable export ------------------------------------------------
    blob = serving.export_fn(
        lambda r: serve_frozen(frozen_q, model.head, r), raw
    )
    served = serving.import_fn(blob)
    np.testing.assert_allclose(
        np.asarray(served(raw)), got_q, rtol=1e-5, atol=1e-6
    )
    print(f"exported artifact: {len(blob) / 1e3:.0f} kB, "
          "round-trips without model code")

    # --- 4. sharded slot-free serving --------------------------------------
    sharded = model.embedding.serving_copy()

    def serve_sharded(emb, head, pre):
        # `pre` from emb.preprocess(raw) on the host (or compile the
        # id->COO transform into the step via preprocess_on_device).
        acts = emb(pre)
        x = jnp.concatenate(
            [acts["user_id"], acts["item_history"], acts["item_id"]],
            axis=-1,
        )
        return head(x)[:, 0]

    got_s = np.asarray(
        jax.jit(serve_sharded)(
            sharded, model.head, sharded.preprocess(raw)
        )
    )
    train_b = sum(
        x.nbytes
        for x in jax.tree_util.tree_leaves(model.embedding.state)
        if hasattr(x, "nbytes")
    )
    serve_b = sum(
        x.nbytes
        for x in jax.tree_util.tree_leaves(sharded.state)
        if hasattr(x, "nbytes")
    )
    print(
        f"serving_copy: sharded state {serve_b / 1e3:.0f} kB vs training "
        f"{train_b / 1e3:.0f} kB, max |score delta| "
        f"{np.abs(got_s - want).max():.2e}"
    )
    assert np.abs(got_s - want).max() < 1e-4
    print("serving deployment walkthrough OK")


if __name__ == "__main__":
    main()
