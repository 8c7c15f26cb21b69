"""Retrieval engine shoot-out: exact, streaming, approximate, sharded.

Counterpart of the reference's examples/scann.py (259 lines), which
trains a tower and then compares BruteForceRetrieval against ScaNN
(tree + asymmetric hashing + reorder) on latency and recall (:209-258).
This walkthrough compares the whole retrieval inventory on one
candidate set:

  brute force        — one [B, N] matmul + top_k (exact; the HBM cost
                       of the score matrix caps N)
  chunked exact      — streaming top-k (ops/topk.py): exact at
                       O(B * chunk) memory, the auto default above 131k
                       candidates (10M candidates fit one chip)
  chunked approx     — per-chunk approx_max_k at recall_target=0.95,
                       exact cross-chunk merge
  kmeans-IVF         — ScaNN's tree stage: route each query to
                       num_probes of ~sqrt(N) clusters, score only those
  IVF int8 + reorder — ScaNN's AH + reorder stages: int8-quantized
                       cluster scan (4x smaller index), exact rescoring
                       of the top reorder_k
  sharded exact      — candidates row-sharded over the device mesh,
                       k winners per shard merged (parallel/
                       sharded_retrieval.py; the scale-OUT story)

Each row reports wall-clock latency for a 256-query batch, recall@10
against the exact result, and index bytes. Numbers depend on the
device this runs on (the reference's printed comparison is a CPU
anecdote too).

Run: python examples/ann_retrieval.py
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from keras_rs_tpu.layers.retrieval.kmeans_retrieval import KMeansRetrieval
from keras_rs_tpu.layers.retrieval.retrieval import BruteForceRetrieval
from keras_rs_tpu.parallel.sharded_retrieval import (
    ShardedBruteForceRetrieval,
)


def timed(call, q, reps=3):
    out = jax.block_until_ready(call(q))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call(q)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main(num_candidates=100_000, dim=64, num_queries=256, k=10):
    rng = np.random.default_rng(0)
    cj = jnp.asarray(
        rng.normal(size=(num_candidates, dim)).astype(np.float32)
    )
    qj = jnp.asarray(
        rng.normal(size=(num_queries, dim)).astype(np.float32)
    )
    f32_bytes = num_candidates * dim * 4

    engines = {}
    bf = BruteForceRetrieval(cj, k=k, chunk_size=None)
    engines["brute force"] = (jax.jit(lambda q: bf(q)[1]), f32_bytes)
    ch = BruteForceRetrieval(cj, k=k, chunk_size=16384)
    engines["chunked exact"] = (jax.jit(lambda q: ch(q)[1]), f32_bytes)
    ca = BruteForceRetrieval(
        cj, k=k, chunk_size=16384, recall_target=0.95
    )
    engines["chunked approx"] = (jax.jit(lambda q: ca(q)[1]), f32_bytes)
    # Uniform gaussian candidates have NO cluster structure — the
    # hardest case for an IVF index (real embedding spaces cluster, so
    # fewer probes suffice). 32/316 probes ~ scanning 10% of the index.
    ann = KMeansRetrieval(
        cj, k=k, num_clusters=316, num_probes=32, kmeans_iterations=5
    )
    engines["kmeans-IVF"] = (
        jax.jit(lambda q: ann(q)[1]),
        ann.cluster_candidates.nbytes,
    )
    ann8 = KMeansRetrieval(
        cj, k=k, num_clusters=316, num_probes=32, kmeans_iterations=5,
        quantize="int8", reorder_k=4 * k,
    )
    engines["IVF int8+reorder"] = (
        jax.jit(lambda q: ann8(q)[1]),
        ann8.cluster_candidates.nbytes,
    )
    sh = ShardedBruteForceRetrieval(cj, k=k)
    n_dev = sh.mesh.devices.size
    engines[f"sharded exact x{n_dev}"] = (
        jax.jit(lambda q: sh(q)[1]),
        f32_bytes,  # global bytes; 1/n_dev per device
    )

    exact_ids = None
    header = f"{'engine':18s}  latency    recall@{k}  index"
    print(header)
    print("-" * len(header))
    for name, (call, nbytes) in engines.items():
        ms, ids = timed(call, qj)
        ids = np.asarray(ids)
        if exact_ids is None:
            exact_ids = ids  # brute force runs first = ground truth
        recall = float(
            np.mean(
                [
                    len(set(a) & set(e)) / k
                    for a, e in zip(ids, exact_ids)
                ]
            )
        )
        print(
            f"{name:18s}  {ms * 1e3:7.2f} ms   {recall:.3f}   "
            f"{nbytes / 1e6:5.0f} MB"
        )
    return True


if __name__ == "__main__":
    main()
