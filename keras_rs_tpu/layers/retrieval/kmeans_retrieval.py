"""Approximate MIPS retrieval: k-means inverted file (IVF).

The reference's ScaNN usage is example-level (examples/scann.py:219-238,
tree + asymmetric hashing + reorder, C++). The JAX equivalent keeps
everything as dense matmul work: candidates are partitioned by k-means
(trained with a few jitted Lloyd iterations), stored as a padded
[num_clusters, cluster_capacity, dim] tensor; a query scores the
centroids, picks `num_probes` clusters, gathers only those candidates and
scores them exactly. Complexity drops from O(N) to
O(num_clusters + num_probes * cluster_capacity) per query while staying
batched and compiler-friendly (no host-side trees).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.core.serialization import export
from keras_rs_tpu.layers.retrieval.retrieval import Retrieval
from keras_rs_tpu.types import Tensor

NEG_INF = float(np.finfo(np.float32).min / 2)


_KMEANS_CHUNK = 65536


def _pad_chunks(x: Tensor) -> tuple[Tensor, int]:
    n = x.shape[0]
    chunk = min(_KMEANS_CHUNK, n)
    pad = (-n) % chunk
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.reshape(-1, chunk, x.shape[1]), n


def assign_clusters(x: Tensor, centroids: Tensor) -> Tensor:
    """Nearest-centroid assignment, chunked so the [N, K] score matrix
    never materializes (index-build scalability to millions of rows)."""
    xc, n = _pad_chunks(x)

    @jax.jit
    def run(xc, centroids):
        c_norm = jnp.sum(centroids**2, axis=1)[None, :]

        def body(_, xb):
            scores = (
                -2.0
                * jnp.matmul(
                    xb, centroids.T, preferred_element_type=jnp.float32
                )
                + c_norm
            )
            return None, jnp.argmin(scores, axis=1).astype(jnp.int32)

        _, out = jax.lax.scan(body, None, xc)
        return out.reshape(-1)

    return run(xc, centroids)[:n]


def kmeans(
    x: Tensor, num_clusters: int, *, key: jax.Array, iterations: int = 10
) -> Tensor:
    """Lloyd's k-means returning [num_clusters, dim] centroids.

    Chunked segment-sum accumulation: memory is O(chunk * K), not
    O(N * K), so million-row candidate sets index without a blowup."""
    n = x.shape[0]
    init_idx = jax.random.choice(
        key, n, shape=(num_clusters,), replace=num_clusters > n
    )
    centroids = x[init_idx]
    xc, _ = _pad_chunks(x)
    n_pad = xc.shape[0] * xc.shape[1]

    row_valid = (
        jnp.arange(n_pad, dtype=jnp.int32) < n
    ).reshape(xc.shape[0], xc.shape[1])

    # NOTE: data is passed as jit ARGUMENTS — closure-captured arrays
    # would be baked into the program as constants (and shipped whole to
    # the compiler; see CLAUDE.md).
    @jax.jit
    def step(centroids, xc, row_valid):
        c_norm = jnp.sum(centroids**2, axis=1)[None, :]

        def body(carry, inp):
            sums, counts = carry
            xb, vb = inp
            scores = (
                -2.0
                * jnp.matmul(
                    xb, centroids.T, preferred_element_type=jnp.float32
                )
                + c_norm
            )
            a = jnp.where(
                vb, jnp.argmin(scores, axis=1), num_clusters
            ).astype(jnp.int32)
            sums = sums + jax.ops.segment_sum(
                jnp.where(vb[:, None], xb, 0.0), a,
                num_segments=num_clusters + 1,
            )[:num_clusters]
            counts = counts + jax.ops.segment_sum(
                vb.astype(jnp.float32), a, num_segments=num_clusters + 1
            )[:num_clusters]
            return (sums, counts), None

        init = (
            jnp.zeros((num_clusters, xc.shape[2]), jnp.float32),
            jnp.zeros((num_clusters,), jnp.float32),
        )
        (sums, counts), _ = jax.lax.scan(body, init, (xc, row_valid))
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        # Keep empty clusters where they were.
        return jnp.where(counts[:, None] > 0, new, centroids)

    for _ in range(iterations):
        centroids = step(centroids, xc, row_valid)
    return centroids


@export("keras_rs_tpu.layers.KMeansRetrieval")
class KMeansRetrieval(Retrieval):
    """IVF approximate top-k retrieval.

    Args:
        num_clusters: k-means partitions (default ~sqrt(N) at index time).
        num_probes: clusters searched per query; recall/latency knob.
    """

    non_trainable_fields = (
        "centroids",
        "cluster_candidates",
        "cluster_ids",
        "cluster_valid",
        "cluster_scales",
        "cluster_pos",
        "flat_candidates",
    )

    def __init__(
        self,
        candidate_embeddings: Tensor | None = None,
        candidate_ids: Tensor | None = None,
        k: int = 10,
        return_scores: bool = True,
        num_clusters: int | None = None,
        num_probes: int = 4,
        kmeans_iterations: int = 10,
        quantize: str | None = None,
        reorder_k: int | None = None,
        seed: int = 0,
        name: str | None = None,
    ) -> None:
        """IVF retrieval, optionally with int8 scoring + exact reorder.

        quantize: None (exact f32 in-cluster scoring) or "int8"
            (per-candidate symmetric int8 quantization — the ScaNN
            product-quantization analogue: 4x smaller index and 4x less
            HBM read per probe; parity target: the reference's ScaNN
            example, examples/scann.py:219-238).
        reorder_k: with quantize, re-score this many int8-stage winners
            EXACTLY against the original f32 vectors before taking the
            final top-k (ScaNN's reorder stage). Defaults to 4 * k.
        """
        super().__init__(k=k, return_scores=return_scores, name=name)
        if quantize not in (None, "int8"):
            raise ValueError(f"Unsupported quantize mode: {quantize!r}")
        self.num_clusters = num_clusters
        self.num_probes = num_probes
        self.kmeans_iterations = kmeans_iterations
        self.quantize = quantize
        self.reorder_k = reorder_k
        self.seed = seed
        self.centroids = None
        self.cluster_candidates = None
        self.cluster_ids = None
        self.cluster_valid = None
        self.cluster_scales = None
        self.cluster_pos = None
        self.flat_candidates = None
        if candidate_embeddings is not None:
            self.update_candidates(candidate_embeddings, candidate_ids)

    def update_candidates(
        self,
        candidate_embeddings: Tensor,
        candidate_ids: Tensor | None = None,
    ) -> None:
        candidate_embeddings = jnp.asarray(
            candidate_embeddings, jnp.float32
        )
        self._validate_candidates(candidate_embeddings, candidate_ids)
        n, dim = candidate_embeddings.shape
        num_clusters = self.num_clusters or max(
            1, int(np.sqrt(n))
        )
        centroids = kmeans(
            candidate_embeddings,
            num_clusters,
            key=jax.random.key(self.seed),
            iterations=self.kmeans_iterations,
        )
        # Index build: nearest-centroid assignment on device (chunked),
        # then host-side grouping into the padded cluster tensor.
        assign = np.asarray(
            assign_clusters(candidate_embeddings, centroids)
        )
        counts = np.bincount(assign, minlength=num_clusters)
        capacity = int(counts.max())
        grouped = np.zeros((num_clusters, capacity, dim), np.float32)
        ids = (
            np.asarray(candidate_ids)
            if candidate_ids is not None
            else np.arange(n)
        ).astype(np.int32)
        grouped_ids = np.zeros((num_clusters, capacity), np.int32)
        valid = np.zeros((num_clusters, capacity), bool)
        order = np.argsort(assign, kind="stable")
        offsets = np.zeros(num_clusters, np.int64)
        sorted_assign = assign[order]
        within = np.arange(n) - np.searchsorted(
            sorted_assign, sorted_assign
        )
        grouped[sorted_assign, within] = np.asarray(
            candidate_embeddings
        )[order]
        grouped_ids[sorted_assign, within] = ids[order]
        valid[sorted_assign, within] = True
        del offsets

        self.centroids = centroids
        self.cluster_ids = jnp.asarray(grouped_ids)
        self.cluster_valid = jnp.asarray(valid)
        if self.quantize == "int8":
            # Per-candidate symmetric int8: v ~= q * scale. The index
            # shrinks 4x (HBM capacity + read bandwidth); the original
            # f32 vectors stay around for the exact reorder stage.
            absmax = np.abs(grouped).max(axis=2, keepdims=True)
            scales = (absmax / 127.0).astype(np.float32)
            q = np.where(
                scales > 0, np.round(grouped / np.maximum(scales, 1e-30)),
                0.0,
            ).astype(np.int8)
            grouped_pos = np.zeros((num_clusters, capacity), np.int32)
            grouped_pos[sorted_assign, within] = order.astype(np.int32)
            self.cluster_candidates = jnp.asarray(q)
            self.cluster_scales = jnp.asarray(scales[..., 0])
            self.cluster_pos = jnp.asarray(grouped_pos)
            self.flat_candidates = candidate_embeddings
        else:
            self.cluster_candidates = jnp.asarray(grouped)
            self.cluster_scales = None
            self.cluster_pos = None
            self.flat_candidates = None

    def __call__(self, inputs: Tensor) -> Any:
        if self.centroids is None:
            raise ValueError(
                "No candidates. Call `update_candidates` first."
            )
        num_probes = min(self.num_probes, self.centroids.shape[0])
        # Stage 1: route to clusters by centroid dot product.
        centroid_scores = self.compute_score(inputs, self.centroids)
        _, probe = jax.lax.top_k(centroid_scores, num_probes)  # [B, P]

        # Stage 2: scores within probed clusters (f32 exact, or int8).
        cands = self.cluster_candidates[probe]  # [B, P, cap, D]
        ids = self.cluster_ids[probe]  # [B, P, cap]
        valid = self.cluster_valid[probe]
        B = inputs.shape[0]
        if self.quantize == "int8":
            scores = jnp.einsum(
                "bd,bpcd->bpc",
                inputs.astype(jnp.float32),
                cands.astype(jnp.float32),
                preferred_element_type=jnp.float32,
            ) * self.cluster_scales[probe]
        else:
            scores = jnp.einsum(
                "bd,bpcd->bpc", inputs, cands,
                preferred_element_type=inputs.dtype,
            )
        scores = jnp.where(valid, scores, NEG_INF)
        flat_scores = scores.reshape(B, -1)
        flat_ids = ids.reshape(B, -1)

        if self.quantize == "int8":
            # Stage 3 (ScaNN reorder): exact f32 re-scoring of the
            # quantized stage's best reorder_k candidates.
            flat_pos = self.cluster_pos[probe].reshape(B, -1)
            rk = min(
                self.reorder_k or 4 * self.k, flat_scores.shape[1]
            )
            _, r_idx = jax.lax.top_k(flat_scores, rk)
            r_pos = jnp.take_along_axis(flat_pos, r_idx, axis=1)
            r_ids = jnp.take_along_axis(flat_ids, r_idx, axis=1)
            r_valid = jnp.take_along_axis(
                valid.reshape(B, -1), r_idx, axis=1
            )
            exact = jnp.einsum(
                "bd,brd->br",
                inputs,
                self.flat_candidates[r_pos],
                preferred_element_type=jnp.float32,
            )
            exact = jnp.where(r_valid, exact, NEG_INF)
            k = min(self.k, rk)
            top_scores, top_idx = jax.lax.top_k(exact, k)
            top_ids = jnp.take_along_axis(r_ids, top_idx, axis=1)
        else:
            k = min(self.k, flat_scores.shape[1])
            top_scores, top_idx = jax.lax.top_k(flat_scores, k)
            top_ids = jnp.take_along_axis(flat_ids, top_idx, axis=1)
        if self.return_scores:
            return top_scores, top_ids
        return top_ids

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update(
            {
                "num_clusters": self.num_clusters,
                "num_probes": self.num_probes,
                "kmeans_iterations": self.kmeans_iterations,
                "quantize": self.quantize,
                "reorder_k": self.reorder_k,
                "seed": self.seed,
            }
        )
        return config
