"""Train state and jitted train-step construction.

The reference delegates its training loop to Keras' `model.fit`; the
replacement here is an explicit, functional, jit-compiled train step
over a (model, opt_state, step) pytree.

Design:
  * Gradients are taken only w.r.t. trainable leaves (inexact arrays not
    under `Module.non_trainable_fields`), selected by flat leaf masks, so
    integer buffers (candidate ids, counters) never hit `jax.grad`.
  * Embedding tables with fused in-kernel optimizers follow the
    "updated-table-as-gradient" contract (parity with the reference's
    `overwrite_with_gradient=True` variables,
    keras_rs/src/layers/embedding/jax/distributed_embedding.py:313): their
    cotangent IS the next table value, so the step assigns it directly
    instead of applying an optax update. Wrap such subtrees in `Overwrite`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from keras_rs_tpu.core.module import Module, trainable_mask


class Overwrite(Module):
    """Marker wrapper: the gradient of the wrapped subtree is its next value."""

    def __init__(self, value: Any):
        self.value = value


def _overwrite_tree(tree: Any) -> Any:
    """Same-structure tree of bools: True under an Overwrite wrapper."""

    def rec(node: Any, inside: bool) -> Any:
        inside = inside or isinstance(node, Overwrite)
        if isinstance(node, Module):
            children, aux = node._tree_flatten()
            return type(node)._tree_unflatten(
                aux, tuple(rec(c, inside) for c in children)
            )
        if isinstance(node, (list, tuple)) and not isinstance(
            node, jax.Array
        ):
            if hasattr(node, "_fields"):  # NamedTuple
                return type(node)(*(rec(v, inside) for v in node))
            return type(node)(rec(v, inside) for v in node)
        if isinstance(node, dict):
            return {k: rec(v, inside) for k, v in node.items()}
        return inside

    return rec(tree, False)


def _flat_masks(model: Any) -> tuple[list[bool], list[bool]]:
    """(grad_mask, overwrite_mask) aligned with tree_flatten(model) leaves.

    grad_mask: leaves to differentiate (trainable params + overwrite leaves).
    overwrite_mask: leaves whose cotangent is assigned, not optax-updated.
    """
    trainable = jax.tree_util.tree_leaves(trainable_mask(model))
    overwrite = jax.tree_util.tree_leaves(_overwrite_tree(model))
    n = len(jax.tree_util.tree_leaves(model))
    assert len(trainable) == n and len(overwrite) == n
    grad_mask = [t or o for t, o in zip(trainable, overwrite)]
    return grad_mask, overwrite


def _split(leaves: list[Any], mask: list[bool]):
    sel = [v for v, m in zip(leaves, mask) if m]
    rest = [v for v, m in zip(leaves, mask) if not m]
    return sel, rest


def _merge(sel: list[Any], rest: list[Any], mask: list[bool]) -> list[Any]:
    it_s, it_r = iter(sel), iter(rest)
    return [next(it_s) if m else next(it_r) for m in mask]


class TrainState(NamedTuple):
    model: Any
    opt_state: Any
    step: jax.Array


def create_train_state(
    model: Any, optimizer: optax.GradientTransformation
) -> TrainState:
    grad_mask, overwrite = _flat_masks(model)
    leaves = jax.tree_util.tree_leaves(model)
    opt_params = [
        v for v, g, o in zip(leaves, grad_mask, overwrite) if g and not o
    ]
    return TrainState(
        model=model,
        opt_state=optimizer.init(opt_params),
        step=jnp.zeros((), jnp.int32),
    )


def make_train_step(
    loss_fn: Callable[..., Any],
    optimizer: optax.GradientTransformation,
    has_aux: bool = False,
    donate: bool = True,
) -> Callable[..., tuple[TrainState, Any]]:
    """Builds a jitted train step.

    `loss_fn(model, *batch)` returns a scalar loss (or `(loss, aux)` when
    `has_aux`). The returned step is
        step(state, *batch) -> (new_state, loss_or_(loss, aux)).
    The input state is donated so parameters are updated in place in HBM.
    """

    def step(state: TrainState, *batch: Any):
        model = state.model
        grad_mask, overwrite = _flat_masks(model)
        leaves, treedef = jax.tree_util.tree_flatten(model)
        params, rest = _split(leaves, grad_mask)

        def scoped_loss(params):
            m = jax.tree_util.tree_unflatten(
                treedef, _merge(params, rest, grad_mask)
            )
            return loss_fn(m, *batch)

        if has_aux:
            (loss, aux), grads = jax.value_and_grad(
                scoped_loss, has_aux=True
            )(params)
            out = (loss, aux)
        else:
            loss, grads = jax.value_and_grad(scoped_loss)(params)
            out = loss

        # Partition gradients: optax-updated vs overwrite-assigned.
        ow_in_grads = [o for g, o in zip(grad_mask, overwrite) if g]
        opt_grads, ow_values = (
            [v for v, o in zip(grads, ow_in_grads) if not o],
            [v for v, o in zip(grads, ow_in_grads) if o],
        )
        opt_params = [v for v, o in zip(params, ow_in_grads) if not o]
        updates, new_opt_state = optimizer.update(
            opt_grads, state.opt_state, opt_params
        )
        new_opt_params = optax.apply_updates(opt_params, updates)

        new_params = _merge(new_opt_params, ow_values, [not o for o in ow_in_grads])
        new_leaves = _merge(new_params, rest, grad_mask)
        new_model = jax.tree_util.tree_unflatten(treedef, new_leaves)
        return (
            TrainState(
                model=new_model,
                opt_state=new_opt_state,
                step=state.step + 1,
            ),
            out,
        )

    return jax.jit(step, donate_argnums=(0,) if donate else ())
