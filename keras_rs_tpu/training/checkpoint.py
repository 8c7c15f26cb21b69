"""Sharded checkpointing via Orbax.

The reference delegates checkpointing to Keras saving (SURVEY.md §5);
the equivalent here is Orbax: sharded array checkpoints that
save/restore directly to/from each device's shard (no host gather).
`save_checkpoint` is a simple BLOCKING save (it waits for durability
before returning — what you want for epoch-end best/last snapshots);
`CheckpointManager` is the async, step-rotating path for saving inside
the training loop without stalling the device.

Orbax is an optional dependency (the `checkpoint` extra): it is imported
on first use, so training without checkpoints runs without it.
"""

from __future__ import annotations

from typing import Any

import jax


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "Checkpointing needs orbax-checkpoint; install it with "
            "`pip install 'keras-rs-tpu[checkpoint]'` (or "
            "`pip install orbax-checkpoint`)."
        ) from e
    return ocp


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Blocking save of an arbitrary pytree (TrainState, model, ...)."""
    ckpt = _ocp().StandardCheckpointer()
    ckpt.save(path, state, force=force)
    ckpt.wait_until_finished()


def _abstract_like(template: Any) -> Any:
    """ShapeDtypeStruct pytree matching `template`'s shapes/shardings.

    Leaves without a mesh sharding (e.g. optax scalar counters) restore
    REPLICATED over the same mesh as the sharded leaves — a
    mixed-device-set state would be rejected by jit.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    # Find the mesh used by any NamedSharding leaf in the template.
    mesh = None
    for leaf in jax.tree_util.tree_leaves(template):
        s = getattr(leaf, "sharding", None)
        if isinstance(s, NamedSharding):
            mesh = s.mesh
            break
    replicated = (
        NamedSharding(mesh, PartitionSpec()) if mesh is not None else None
    )

    def to_abstract(x):
        if not hasattr(x, "shape"):
            return x
        s = getattr(x, "sharding", None)
        if not isinstance(s, NamedSharding):
            s = replicated
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=s)

    return jax.tree_util.tree_map(to_abstract, template)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restores into the structure/shardings of `template`.

    `template` can be a concrete pytree (its arrays define shape, dtype
    and sharding) or a pytree of jax.ShapeDtypeStruct.
    """
    ckpt = _ocp().StandardCheckpointer()
    return ckpt.restore(path, _abstract_like(template))


class CheckpointManager:
    """Step-rotating async checkpoint manager."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        ocp = _ocp()
        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(
            directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, enable_async_checkpointing=True
            ),
        )

    def save(self, step: int, state: Any) -> None:
        self._mgr.save(step, args=self._ocp.args.StandardSave(state))

    def restore(self, step: int | None, template: Any) -> Any:
        if step is None:
            step = self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError("No checkpoint found.")
        return self._mgr.restore(
            step,
            args=self._ocp.args.StandardRestore(_abstract_like(template)),
        )

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def wait_until_finished(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.close()
