"""Retrieval base + exact brute-force top-k MIPS.

JAX reimplementation of keras_rs/src/layers/retrieval/retrieval.py
and brute_force_retrieval.py. Scoring is a single (B, D) x (D, N) matmul
(matmul-bound) followed by `lax.top_k`; this is already the optimal single-chip
layout for exact MIPS. The mesh-sharded variant (candidates row-sharded,
local top-k per shard + gathered merge) is
keras_rs_tpu.parallel.sharded_retrieval.ShardedBruteForceRetrieval.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from keras_rs_tpu.core.module import Module
from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.types import Tensor


class Retrieval(Module):
    """Base class for candidate retrieval layers.

    Parity: keras_rs/src/layers/retrieval/retrieval.py:35-117.
    """

    non_trainable_fields = ("candidate_embeddings", "candidate_ids")

    def __init__(
        self,
        k: int = 10,
        return_scores: bool = True,
        name: str | None = None,
    ) -> None:
        if k < 1:
            raise ValueError(f"`k` must be a positive integer, got {k}.")
        self.k = k
        self.return_scores = return_scores
        self.name = name or type(self).__name__

    @staticmethod
    def _validate_candidates(
        candidate_embeddings: Tensor, candidate_ids: Tensor | None
    ) -> None:
        if candidate_embeddings.ndim != 2:
            raise ValueError(
                "`candidate_embeddings` must have rank 2, got rank "
                f"{candidate_embeddings.ndim}."
            )
        if candidate_ids is not None:
            if candidate_ids.ndim != 1 or (
                candidate_ids.shape[0] != candidate_embeddings.shape[0]
            ):
                raise ValueError(
                    "`candidate_ids` must be 1-D with one id per candidate. "
                    f"Received {candidate_ids.shape} vs "
                    f"{candidate_embeddings.shape}."
                )

    def compute_score(
        self, query_embedding: Tensor, candidate_embedding: Tensor
    ) -> Tensor:
        """Dense dot-product scores: (B, D) @ (D, N)."""
        return jnp.matmul(
            query_embedding,
            candidate_embedding.T,
            preferred_element_type=query_embedding.dtype,
        )

    def update_candidates(
        self,
        candidate_embeddings: Tensor,
        candidate_ids: Tensor | None = None,
    ) -> None:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        return {
            "k": self.k,
            "return_scores": self.return_scores,
            "name": self.name,
        }


@export("keras_rs_tpu.layers.BruteForceRetrieval")
class BruteForceRetrieval(Retrieval):
    """Exact top-k retrieval by scoring all candidates.

    Candidates are non-trainable state and (per the reference's contract,
    brute_force_retrieval.py:26-28) are NOT serialized; call
    `update_candidates` after deserialization.
    """

    #: Above this candidate count, `__call__` switches to the streaming
    #: chunked top-k (ops/topk.py) so the [B, N] score matrix never
    #: materializes in HBM. Exactness is unaffected.
    DIRECT_MAX_CANDIDATES = 131072

    def __init__(
        self,
        candidate_embeddings: Tensor | None = None,
        candidate_ids: Tensor | None = None,
        k: int = 10,
        return_scores: bool = True,
        chunk_size: int | str | None = "auto",
        recall_target: float | None = None,
        name: str | None = None,
    ) -> None:
        super().__init__(k=k, return_scores=return_scores, name=name)
        self.chunk_size = chunk_size
        #: None = exact; (0, 1) = approx_max_k per chunk (4.5x faster
        #: chunk selection; see ops/topk.py). Only used on the chunked
        #: path.
        self.recall_target = recall_target
        self.candidate_embeddings = None
        self.candidate_ids = None
        if candidate_embeddings is None:
            if candidate_ids is not None:
                raise ValueError(
                    "You cannot provide `candidate_ids` without providing "
                    "`candidate_embeddings`."
                )
        else:
            self.update_candidates(candidate_embeddings, candidate_ids)

    def update_candidates(
        self,
        candidate_embeddings: Tensor,
        candidate_ids: Tensor | None = None,
    ) -> None:
        candidate_embeddings = jnp.asarray(candidate_embeddings)
        if candidate_ids is not None:
            candidate_ids = jnp.asarray(candidate_ids, jnp.int32)
        self._validate_candidates(candidate_embeddings, candidate_ids)
        if self.candidate_embeddings is not None:
            if (self.candidate_ids is None) != (candidate_ids is None):
                raise ValueError(
                    "Presence of `candidate_ids` must be consistent across "
                    "`update_candidates` calls."
                )
        self.candidate_embeddings = candidate_embeddings
        self.candidate_ids = candidate_ids

    def __call__(self, inputs: Tensor) -> Tensor | tuple[Tensor, Tensor]:
        if self.candidate_embeddings is None:
            raise ValueError(
                "No candidates. Call `update_candidates` first."
            )
        n = self.candidate_embeddings.shape[0]
        # The streaming chunked kernel hardcodes dot-product scoring, so a
        # subclass overriding compute_score must not be silently routed
        # through it ("auto" falls back to the direct path; an explicit
        # chunk_size with a custom compute_score is an error).
        custom_score = (
            type(self).compute_score is not Retrieval.compute_score
        )
        use_chunked = (
            self.chunk_size is not None
            and self.chunk_size != 0
            and (
                (n > self.DIRECT_MAX_CANDIDATES and not custom_score)
                if self.chunk_size == "auto"
                else True
            )
        )
        if use_chunked and custom_score:
            raise ValueError(
                "Chunked retrieval assumes dot-product scoring; "
                f"{type(self).__name__} overrides compute_score. Pass "
                "chunk_size=None (or 'auto') to use the direct path."
            )
        if use_chunked:
            from keras_rs_tpu.ops.topk import chunked_topk_mips

            chunk = (
                65536 if self.chunk_size == "auto" else int(self.chunk_size)
            )
            top_scores, top_idx = chunked_topk_mips(
                inputs, self.candidate_embeddings, self.k, chunk,
                recall_target=self.recall_target,
            )
        else:
            scores = self.compute_score(inputs, self.candidate_embeddings)
            top_scores, top_idx = jax.lax.top_k(scores, self.k)
        if self.candidate_ids is not None:
            top_idx = jnp.take(self.candidate_ids, top_idx, axis=0)
        if self.return_scores:
            return top_scores, top_idx
        return top_idx
