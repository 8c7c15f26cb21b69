"""Sparse (BCOO) input adapters.

The reference accepts sparse id tensors in `EmbedReduce` and the
distributed embedding preprocessing (keras_rs/src/layers/embedding/
embed_reduce.py:36-87, base_distributed_embedding.py:31-92): the ids are
densified (missing positions read row 0 of the table — bogus values),
and a sparse `ones_like` mask zeroes those bogus embeddings and feeds
the combiner divisors. The jit-friendly equivalent of that contract is
exactly our padded-dense-ids + 0/1-weights form, so the adapter below is
lossless: `bcoo_densify` returns (dense ids with 0 fill, float mask with
1 at stored positions).

Indices are assumed unique per position (duplicate BCOO indices would
sum during densification — not a meaningful id encoding).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np


def is_bcoo(x: Any) -> bool:
    try:
        from jax.experimental import sparse as jsparse
    except ImportError:  # pragma: no cover
        return False
    return isinstance(x, jsparse.BCOO)


def bcoo_densify(sp: Any) -> tuple[np.ndarray, np.ndarray]:
    """BCOO ids -> (dense ids, 0/1 float mask), reference semantics."""
    from jax.experimental import sparse as jsparse

    ids = np.asarray(sp.todense())
    ones = jsparse.BCOO(
        (jnp.ones_like(sp.data, dtype=jnp.float32), sp.indices),
        shape=sp.shape,
        indices_sorted=sp.indices_sorted,
        unique_indices=sp.unique_indices,
    )
    mask = np.asarray(ones.todense())
    return ids, mask
