"""Data-parallel retrieval over a device mesh.

Parity with examples/data_parallel_retrieval.py in the reference
(basic_retrieval under keras.distribution.DataParallel): here the batch is
sharded over a 1-D mesh via NamedSharding and jit handles replication of
the parameters — the JAX data-parallel recipe.

Run (8 virtual devices):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/data_parallel_retrieval.py
"""

import jax
import numpy as np
import optax

from keras_rs_tpu import models, training
from keras_rs_tpu.data import synthetic
from keras_rs_tpu.parallel import mesh as mesh_lib


def main():
    mesh = mesh_lib.create_mesh()
    print(f"mesh: {mesh.devices.size} devices")
    num_users, num_items = 512, 512
    fb = synthetic.implicit_feedback(
        num_users=num_users, num_items=num_items, num_events=40_960,
        seed=0,
    )
    user_ids, item_ids = fb["user_id"], fb["item_id"]

    model = models.TwoTower(
        num_users, num_items, embedding_dim=32, key=jax.random.key(0)
    )
    # Replicate the model once; batches are sharded on the data axis.
    model = mesh_lib.replicate(mesh, model)

    def loss_fn(model, batch):
        return models.in_batch_softmax_loss(
            model, batch["user_id"], batch["item_id"]
        )

    trainer = training.Trainer(model, optax.adagrad(0.5), loss_fn)

    def data():
        for b in synthetic.batches(
            {"user_id": user_ids, "item_id": item_ids}, 512, seed=1
        ):
            yield mesh_lib.put_batch(mesh, b)

    hist = trainer.fit(data, epochs=10, log_every=0)
    # Held-out recall@10 (stochastic preferences: sub-1.0 ceiling).
    retrieval = trainer.model.make_retrieval(k=10)
    import jax.numpy as jnp

    q = trainer.model.query_tower(jnp.asarray(fb["eval_user_id"]))
    _, top = retrieval(q)
    top = np.asarray(top)
    recall = float(
        np.mean(
            [
                fb["eval_item_id"][j] in top[j]
                for j in range(len(fb["eval_user_id"]))
            ]
        )
    )
    print(f"final loss: {hist['loss'][-1]:.4f}  recall@10: {recall:.3f}")
    return recall


if __name__ == "__main__":
    main()
