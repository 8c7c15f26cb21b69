"""SparseCore-style pipelined embedding execution (one-step-stale lookups).

Capability parity with the reference TF backend's
`pipeline_execution_with_tensor_core` knob
(keras_rs/src/layers/embedding/tensorflow/distributed_embedding.py:49-50,
158-165): embedding lookups overlap with the dense (TensorCore) compute at
the cost of the lookups being one gradient update old. On real TPU
SparseCore hardware the overlap is physical (two compute units); in this
JAX design the same semantics make the embedding *dataflow*
independent of the dense stack inside one step, so XLA's async scheduler
can overlap the gather + its all_to_all exchange with the dense
matmuls on multi-chip meshes.

Mechanics per step t (scan-friendly, all static shapes):

  1. dense fwd/bwd on batch t with the CARRIED activations `prefetched`
     (gathered at step t-1 from tables lacking update t-1 → "one step
     old"), taking gradients w.r.t. the dense params AND the injected
     activations.
  2. stale prefetch: activations for batch t+1 are gathered from the
     pre-update tables — this op depends only on (tables, next batch's
     COO), not on anything the dense stack computes, which is the whole
     point.
  3. fused table update: `jax.vjp` of the embedding forward on batch t's
     COO, seeded with the activation cotangents from (1). Because the
     lookup's custom_vjp returns the UPDATED table state as its cotangent
     (the `Overwrite` contract, training/train_state.py:30), the vjp call
     IS the fused-optimizer scatter — no second code path to maintain.

Step 0 consumes fresh activations (`prime`), so the first pipelined step
is bit-identical to the unpipelined one; staleness starts at step 1.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from keras_rs_tpu.training.train_state import (
    TrainState,
    _flat_masks,
    _merge,
)


class PipelinedTrainState(NamedTuple):
    model: Any
    opt_state: Any
    step: jax.Array
    #: Activations for the NEXT batch to be consumed, gathered one update
    #: ago (fresh at step 0 via `prime`).
    prefetched: Any


def dlrm_pipeline_fns() -> tuple[Callable, Callable, Callable]:
    """(embed_fn, get_pre, inject) wiring for models.dlrm.DLRMDCNv2.

    The model's `__call__` already prefers precomputed `large_acts` over
    running the embedding layer (models/dlrm.py:239-247), so injection is
    one dict entry.
    """

    def embed_fn(model, pre):
        return model.embedding_layer(pre)

    def get_pre(batch):
        return batch["large_pre"]

    def inject(batch, acts):
        return {**batch, "large_acts": acts}

    return embed_fn, get_pre, inject


def prime(
    model: Any, pre: Any, embed_fn: Callable[[Any, Any], Any]
) -> Any:
    """Fresh activations for the first batch (jit outside if desired)."""
    return embed_fn(model, pre)


def create_pipelined_train_state(
    model: Any,
    optimizer: optax.GradientTransformation,
    first_pre: Any,
    embed_fn: Callable[[Any, Any], Any],
) -> PipelinedTrainState:
    from keras_rs_tpu.training.train_state import create_train_state

    base: TrainState = create_train_state(model, optimizer)
    prefetched = jax.jit(prime, static_argnums=(2,))(
        model, first_pre, embed_fn
    )
    return PipelinedTrainState(
        model=base.model,
        opt_state=base.opt_state,
        step=base.step,
        prefetched=prefetched,
    )


def make_pipelined_train_step(
    loss_fn: Callable[..., Any],
    optimizer: optax.GradientTransformation,
    embed_fn: Callable[[Any, Any], Any],
    get_pre: Callable[[Any], Any],
    inject: Callable[[Any, Any], Any],
    has_aux: bool = False,
    donate: bool = True,
    jit: bool = True,
) -> Callable[..., tuple[PipelinedTrainState, Any]]:
    """Builds the pipelined step:

        step(state, batch, next_pre) -> (new_state, loss_or_(loss, aux))

    `batch` must contain its own preprocessed embedding inputs
    (`get_pre(batch)`); `next_pre` is the NEXT batch's preprocessed
    embedding inputs (feed the current batch's again for the final step —
    its prefetch is discarded). Dense-placement tables inside the
    embedding layer keep training: any non-Overwrite trainable leaf the
    embedding forward touches gets its vjp cotangent accumulated into the
    dense gradients.
    """

    def step(state: PipelinedTrainState, batch: Any, next_pre: Any):
        model = state.model
        grad_mask, overwrite = _flat_masks(model)
        leaves, treedef = jax.tree_util.tree_flatten(model)
        dense_mask = [g and not o for g, o in zip(grad_mask, overwrite)]
        dense_params = [v for v, m in zip(leaves, dense_mask) if m]
        ow_params = [v for v, o in zip(leaves, overwrite) if o]
        rest = [
            v
            for v, (m, o) in zip(leaves, zip(dense_mask, overwrite))
            if not (m or o)
        ]

        def rebuild(dense_p, ow):
            nonow = _merge(dense_p, rest, [m for m, o in
                                           zip(dense_mask, overwrite)
                                           if not o])
            return jax.tree_util.tree_unflatten(
                treedef, _merge(ow, nonow, overwrite)
            )

        # (1) dense fwd/bwd with injected (possibly stale) activations.
        acts = state.prefetched

        def scoped_loss(dense_p, acts_in):
            m = rebuild(dense_p, ow_params)
            return loss_fn(m, inject(batch, acts_in))

        if has_aux:
            (loss, aux), (dense_grads, d_acts) = jax.value_and_grad(
                scoped_loss, argnums=(0, 1), has_aux=True
            )(dense_params, acts)
            out = (loss, aux)
        else:
            loss, (dense_grads, d_acts) = jax.value_and_grad(
                scoped_loss, argnums=(0, 1)
            )(dense_params, acts)
            out = loss

        # (2) stale prefetch for batch t+1 from the PRE-update tables —
        # independent of the dense stack, overlappable by XLA.
        acts_next = embed_fn(rebuild(dense_params, ow_params), next_pre)

        # (3) fused-optimizer table update for batch t: the lookup's
        # custom_vjp cotangent IS the updated state (Overwrite contract).
        def emb_fwd(dense_p, ow):
            return embed_fn(rebuild(dense_p, ow), get_pre(batch))

        _, emb_vjp = jax.vjp(emb_fwd, dense_params, ow_params)
        extra_dense_grads, new_ow = emb_vjp(d_acts)
        dense_grads = [
            g + e for g, e in zip(dense_grads, extra_dense_grads)
        ]

        updates, new_opt_state = optimizer.update(
            dense_grads, state.opt_state, dense_params
        )
        new_dense = optax.apply_updates(dense_params, updates)
        new_nonow = _merge(
            new_dense,
            rest,
            [m for m, o in zip(dense_mask, overwrite) if not o],
        )
        new_model = jax.tree_util.tree_unflatten(
            treedef, _merge(new_ow, new_nonow, overwrite)
        )
        return (
            PipelinedTrainState(
                model=new_model,
                opt_state=new_opt_state,
                step=state.step + 1,
                prefetched=acts_next,
            ),
            out,
        )

    if not jit:
        return step
    return jax.jit(step, donate_argnums=(0,) if donate else ())
