"""Pytree-native module system.

This is the substrate that replaces the reference's dependency on
`keras.layers.Layer` (keras_rs delegates all module mechanics to Keras 3;
see SURVEY.md L1). Here modules ARE pytrees: every `Module` subclass is
automatically registered with `jax.tree_util`, its array-valued attributes
(and sub-modules) are pytree leaves/subtrees, and everything else is static
auxiliary data. This gives us `jax.jit`, `jax.grad`, `jax.vmap`, `shard_map`
etc. over whole models for free — the idiomatic JAX design, instead of a
stateful layer graph.

Conventions:
  * Modules are immutable by convention. Use `replace(module, **updates)` to
    produce modified copies (this is what optimizers do under the hood).
  * Attributes holding `jax.Array` / `np.ndarray` values, `Module` instances,
    or containers of those are dynamic (traced). Everything else (ints,
    strings, callables, dtypes, ...) is static and participates in the jit
    cache key.
  * Non-trainable arrays (e.g. retrieval candidate stores) are declared via
    the class attribute `non_trainable_fields: tuple[str, ...]`;
    `trainable_mask` produces a boolean pytree for optimizers to mask on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import jax
import numpy as np

M = TypeVar("M", bound="Module")

_ARRAY_TYPES = (jax.Array, np.ndarray)


def _is_dynamic(value: Any) -> bool:
    """True if `value` should be part of the traced pytree."""
    if isinstance(value, _ARRAY_TYPES) or isinstance(value, Module):
        return True
    if isinstance(value, (list, tuple)):
        return any(_is_dynamic(v) for v in value)
    if isinstance(value, dict):
        return any(_is_dynamic(v) for v in value.values())
    return False


def _hashable(value: Any) -> Any:
    """Convert static values into hashable equivalents for pytree aux data."""
    if isinstance(value, list):
        return ("__list__",) + tuple(_hashable(v) for v in value)
    if isinstance(value, tuple):
        return ("__tuple__",) + tuple(_hashable(v) for v in value)
    if isinstance(value, dict):
        return ("__dict__",) + tuple(
            (k, _hashable(v)) for k, v in sorted(value.items())
        )
    if isinstance(value, set):
        return ("__set__",) + tuple(sorted(map(_hashable, value)))
    return value


def _unhashable(value: Any) -> Any:
    if isinstance(value, tuple) and value and value[0] in (
        "__list__",
        "__tuple__",
        "__dict__",
        "__set__",
    ):
        tag, rest = value[0], value[1:]
        if tag == "__list__":
            return [_unhashable(v) for v in rest]
        if tag == "__tuple__":
            return tuple(_unhashable(v) for v in rest)
        if tag == "__dict__":
            return {k: _unhashable(v) for k, v in rest}
        if tag == "__set__":
            return set(_unhashable(v) for v in rest)
    return value


class Module:
    """Base class: subclasses are automatically registered as pytrees."""

    non_trainable_fields: tuple[str, ...] = ()

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # Aggregate non-trainable fields over the MRO so subclasses extend
        # rather than replace their parents' declarations.
        merged: list[str] = []
        for klass in cls.__mro__:
            for name in getattr(klass, "non_trainable_fields", ()):
                if name not in merged:
                    merged.append(name)
        cls.non_trainable_fields = tuple(merged)
        jax.tree_util.register_pytree_with_keys(
            cls,
            flatten_with_keys=cls._tree_flatten_with_keys,
            flatten_func=cls._tree_flatten,
            unflatten_func=cls._tree_unflatten,
        )

    # -- pytree protocol ---------------------------------------------------
    def _tree_split(self):
        dynamic: list[tuple[str, Any]] = []
        static: list[tuple[str, Any]] = []
        # Instances produced by unflatten remember which keys were dynamic,
        # so tree_map results whose leaves are non-arrays (bool masks, None
        # grads, ...) keep the same treedef instead of reclassifying.
        fixed_keys = self.__dict__.get("_treedef_keys")
        for name in sorted(vars(self)):
            if name == "_treedef_keys":
                continue
            value = vars(self)[name]
            if (
                fixed_keys is not None and name in fixed_keys
            ) or (fixed_keys is None and _is_dynamic(value)):
                dynamic.append((name, value))
            else:
                static.append((name, _hashable(value)))
        return dynamic, static

    def _tree_flatten(self):
        dynamic, static = self._tree_split()
        keys = tuple(k for k, _ in dynamic)
        children = tuple(v for _, v in dynamic)
        return children, (keys, tuple(static))

    def _tree_flatten_with_keys(self):
        dynamic, static = self._tree_split()
        keys = tuple(k for k, _ in dynamic)
        children = tuple(
            (jax.tree_util.GetAttrKey(k), v) for k, v in dynamic
        )
        return children, (keys, tuple(static))

    @classmethod
    def _tree_unflatten(cls, aux: Any, children: Any) -> "Module":
        keys, static = aux
        obj = object.__new__(cls)
        for name, value in zip(keys, children):
            object.__setattr__(obj, name, value)
        for name, value in static:
            object.__setattr__(obj, name, _unhashable(value))
        object.__setattr__(obj, "_treedef_keys", frozenset(keys))
        return obj

    def __setattr__(self, name: str, value: Any) -> None:
        # Direct mutation (e.g. update_candidates) may change which attrs
        # are dynamic; drop any fixed treedef so the split is recomputed.
        self.__dict__.pop("_treedef_keys", None)
        object.__setattr__(self, name, value)

    # -- conveniences --------------------------------------------------------
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement __call__."
        )

    def replace(self: M, **updates: Any) -> M:
        """Functional attribute update returning a new module."""
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        for name, value in updates.items():
            if name not in self.__dict__:
                raise AttributeError(
                    f"{type(self).__name__} has no attribute {name!r}"
                )
            object.__setattr__(obj, name, value)
        return obj

    def get_config(self) -> dict[str, Any]:
        """Serialization hook; subclasses should override."""
        return {}

    @classmethod
    def from_config(cls: type[M], config: dict[str, Any]) -> M:
        return cls(**config)

    def __repr__(self) -> str:
        dynamic, static = self._tree_split()
        parts = []
        for name, value in dynamic:
            if isinstance(value, _ARRAY_TYPES):
                parts.append(f"{name}={value.dtype}{list(value.shape)}")
            else:
                parts.append(f"{name}={type(value).__name__}")
        for name, value in static:
            parts.append(f"{name}={_unhashable(value)!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def replace(module: M, **updates: Any) -> M:
    return module.replace(**updates)


def is_param(leaf: Any) -> bool:
    """True for inexact (floating/complex) array leaves: trainable params."""
    return isinstance(leaf, _ARRAY_TYPES) and jax.numpy.issubdtype(
        leaf.dtype, jax.numpy.inexact
    )


def trainable_mask(tree: Any) -> Any:
    """Boolean pytree: True where a leaf is a trainable parameter.

    A leaf is trainable iff it is an inexact-dtype array AND it is not
    reachable through an attribute listed in its owning module's
    `non_trainable_fields`.
    """

    def rec(node: Any, frozen: bool) -> Any:
        if isinstance(node, Module):
            children, aux = node._tree_flatten()
            keys = aux[0]
            new_children = tuple(
                rec(c, frozen or (k in type(node).non_trainable_fields))
                for k, c in zip(keys, children)
            )
            return type(node)._tree_unflatten(aux, new_children)
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, frozen) for v in node)
        if isinstance(node, dict):
            return {k: rec(v, frozen) for k, v in node.items()}
        return (not frozen) and is_param(node)

    return rec(tree, False)


@dataclasses.dataclass
class _FilterSpec:
    predicate: Callable[[Any], bool]


def tree_paths(tree: Any) -> list[str]:
    """Human-readable dotted paths of all leaves (for debugging/checkpoints)."""
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(jax.tree_util.keystr(path))
    return out
