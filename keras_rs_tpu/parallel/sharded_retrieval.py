"""Mesh-sharded exact brute-force retrieval.

The reference's `BruteForceRetrieval` scores all candidates on one device
(keras_rs/src/layers/retrieval/brute_force_retrieval.py:126-148); its only
scale-out story is replicating candidates under DataParallel
(examples/data_parallel_retrieval.py:43-59). This module shards the
candidate table by rows over a mesh axis instead: each device scores its
own candidate block with one matmul, takes a local top-k, and the
per-shard winners (k per shard, not N) are all-gathered and merged — so
both device memory and FLOPs scale with the number of devices and the
interconnect traffic is O(shards * B * k), independent of N.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from keras_rs_tpu.layers.retrieval.retrieval import Retrieval
from keras_rs_tpu.parallel import mesh as mesh_lib
from keras_rs_tpu.types import Tensor

_NEG_INF = float("-inf")


@partial(jax.jit, static_argnames=("k", "axis_name", "mesh", "num_valid"))
def _sharded_topk(
    query: Tensor,
    candidates: Tensor,
    *,
    k: int,
    axis_name: str,
    mesh: Mesh,
    num_valid: int,
) -> tuple[Tensor, Tensor]:
    """Exact global top-k over row-sharded candidates.

    `candidates` is [N_padded, D] sharded P(axis_name, None); block s of
    the row dimension lives on shard s, so a local row r on shard s is
    global row `s * rows_per_shard + r`. Rows >= num_valid are padding
    and are masked to -inf before the local top-k.
    """
    rows_per_shard = candidates.shape[0] // mesh_lib.axis_size(
        mesh, axis_name
    )

    def local(query, cand_block):
        s = jax.lax.axis_index(axis_name)
        scores = jnp.matmul(
            query, cand_block.T, preferred_element_type=jnp.float32
        )  # [B, rows_per_shard]
        global_rows = s * rows_per_shard + jnp.arange(rows_per_shard)
        scores = jnp.where(global_rows[None, :] < num_valid, scores, _NEG_INF)
        top_s, top_i = jax.lax.top_k(scores, min(k, rows_per_shard))
        top_g = jnp.take(global_rows, top_i, axis=0)
        # [D_shards, B, k] on every shard after the gather.
        all_s = jax.lax.all_gather(top_s, axis_name)
        all_g = jax.lax.all_gather(top_g, axis_name)
        return all_s, all_g

    all_s, all_g = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis_name, None)),
        out_specs=P(),
        check_vma=False,
    )(query, candidates)
    # Merge the per-shard winners: [B, shards * k] -> global top-k.
    b = query.shape[0]
    flat_s = jnp.transpose(all_s, (1, 0, 2)).reshape(b, -1)
    flat_g = jnp.transpose(all_g, (1, 0, 2)).reshape(b, -1)
    top_s, top_i = jax.lax.top_k(flat_s, k)
    top_g = jnp.take_along_axis(flat_g, top_i, axis=1)
    return top_s, top_g


class ShardedBruteForceRetrieval(Retrieval):
    """Exact top-k MIPS with candidates row-sharded over a mesh axis.

    Scoring stays a dense (B, D) x (D, N/shard) matmul per device;
    only k winners per shard cross the interconnect. Results are
    identical to single-device `BruteForceRetrieval` (up to top-k tie
    order). Candidates are non-trainable and NOT serialized (contract of
    the reference, brute_force_retrieval.py:26-28).
    """

    def __init__(
        self,
        candidate_embeddings: Tensor | None = None,
        candidate_ids: Tensor | None = None,
        k: int = 10,
        return_scores: bool = True,
        *,
        mesh: Mesh | None = None,
        axis_name: str = mesh_lib.DATA_AXIS,
        name: str | None = None,
    ) -> None:
        super().__init__(k=k, return_scores=return_scores, name=name)
        self.mesh = mesh if mesh is not None else mesh_lib.create_mesh()
        self.axis_name = axis_name
        self.num_candidates = 0
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
        n, d = candidate_embeddings.shape
        shards = mesh_lib.axis_size(self.mesh, self.axis_name)
        padded = -(-n // shards) * shards
        if padded != n:
            candidate_embeddings = jnp.pad(
                candidate_embeddings, ((0, padded - n), (0, 0))
            )
        self.num_candidates = n
        self.candidate_embeddings = jax.device_put(
            candidate_embeddings,
            NamedSharding(self.mesh, P(self.axis_name, None)),
        )
        self.candidate_ids = candidate_ids

    def __call__(self, inputs: Tensor) -> Tensor | tuple[Tensor, Tensor]:
        if self.candidate_embeddings is None:
            raise ValueError("No candidates. Call `update_candidates` first.")
        top_scores, top_idx = _sharded_topk(
            inputs,
            self.candidate_embeddings,
            k=self.k,
            axis_name=self.axis_name,
            mesh=self.mesh,
            num_valid=self.num_candidates,
        )
        if self.candidate_ids is not None:
            top_idx = jnp.take(self.candidate_ids, top_idx, axis=0)
        if self.return_scores:
            return top_scores, top_idx
        return top_idx

    def get_config(self) -> dict[str, Any]:
        return {**super().get_config(), "axis_name": self.axis_name}
