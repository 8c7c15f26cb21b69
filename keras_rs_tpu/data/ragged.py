"""Ragged integer inputs without tf.RaggedTensor.

The reference accepts tf.RaggedTensor feature inputs and densifies them
with synthesized 0/1 weights before embedding
(keras_rs/src/layers/embedding/base_distributed_embedding.py:31-92). The
JAX equivalent standardizes on the (values, row_lengths) pair and
converts to the padded-ids + weights form every kernel here consumes
(SURVEY.md §7 hard part (e)): static shapes, no host-side raggedness past
the input boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Ragged(NamedTuple):
    """A batch of variable-length id lists.

    values: 1-D int array, all rows concatenated.
    row_lengths: 1-D int array [B], row i owns the next row_lengths[i]
        values.
    """

    values: np.ndarray
    row_lengths: np.ndarray

    @property
    def batch_size(self) -> int:
        return len(self.row_lengths)

    @classmethod
    def from_lists(cls, rows) -> "Ragged":
        """Builds from a list of per-row lists (int ids or float weights).

        Integer inputs become int64; float inputs keep float32 (so
        per-id WEIGHTS built this way are not truncated to integers).
        """
        row_lengths = np.asarray([len(r) for r in rows], np.int32)
        if len(rows) and row_lengths.sum():
            values = np.concatenate([np.asarray(r) for r in rows])
            values = values.astype(
                np.int64
                if np.issubdtype(values.dtype, np.integer)
                else np.float32
            )
        else:
            values = np.zeros((0,), np.int64)
        return cls(values=values, row_lengths=row_lengths)

    def to_padded(
        self, max_length: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids [B, L], weights [B, L]) with 0/1 padding weights.

        With `max_length`, L == max_length exactly: longer rows truncate
        (keep-first, like the reference's densification) and shorter
        batches pad up — a STATIC shape, so jitted consumers do not
        recompile when the batch's longest row changes. Without it,
        L = this batch's max row length (convenient, but expect a
        recompile per distinct L).
        """
        lengths = np.asarray(self.row_lengths, np.int64)
        B = len(lengths)
        if max_length is not None:
            L = int(max_length)
        else:
            L = int(lengths.max()) if B and lengths.size else 0
        L = max(L, 1)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        values = np.asarray(self.values)
        col = np.arange(L, dtype=np.int64)[None, :]
        mask = col < np.minimum(lengths, L)[:, None]
        src = np.minimum(
            starts[:, None] + col, max(len(values) - 1, 0)
        )
        dtype = values.dtype if len(values) else np.int64
        gathered = (
            values[src] if len(values) else np.zeros((B, L), dtype)
        )
        ids = np.where(mask, gathered, 0).astype(dtype)
        weights = mask.astype(np.float32)
        return ids, weights
