"""Common type aliases used across the framework.

Parity: keras_rs/src/types.py (Tensor/Shape/Nested aliases), rebuilt for a
JAX-only stack: `Tensor` is a `jax.Array` (or anything
`jnp.asarray`-able at the boundary), and `Nested` is an arbitrary pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeVar, Union

import jax
import numpy as np

T = TypeVar("T")

Tensor = Union[jax.Array, np.ndarray]
Shape = Sequence[int]
DType = Any

# A nested structure (pytree) of T: either T itself, or (arbitrarily nested)
# lists / tuples / dicts of T.
Nested = Union[
    T,
    Sequence["Nested[T]"],
    dict[str, "Nested[T]"],
]

# An initializer maps (key, shape, dtype) -> Tensor.
Initializer = Callable[[jax.Array, Shape, DType], jax.Array]
