"""Serving: ahead-of-time compiled / serialized inference functions.

The reference leaves serving to Keras (`model.predict`; the retrieval
layer is attached at inference time, examples/basic_retrieval.py:260-269).
For production serving this module provides the two standard shapes:

  * `aot_compile(fn, *example_args)` — lower + compile once, get a
    fixed-shape callable with no tracing on the hot path (first-token
    latency = device execution only).
  * `export_fn` / `import_fn` — serialize the computation as a portable
    StableHLO artifact (jax.export) that a separate serving process can
    load WITHOUT the model code, and run on any matching topology.

Typical retrieval deployment: fuse the query tower + top-k into one
function and export it:

    service = make_retrieval_service(query_tower, retrieval_layer)
    blob = export_fn(service, example_queries)    # ship this
    serve = import_fn(blob)                       # in the server
    scores, ids = serve(queries)
"""

from __future__ import annotations

from typing import Any, Callable

import jax
from jax import export as jax_export


def aot_compile(fn: Callable, *example_args: Any) -> Callable:
    """jit + lower + compile for the example shapes; returns the compiled
    callable (raises on shape mismatch instead of retracing)."""
    jitted = jax.jit(fn)
    compiled = jitted.lower(*example_args).compile()
    return compiled


def export_fn(fn: Callable, *example_args: Any) -> bytes:
    """Serializes `fn` at the example shapes to a portable artifact."""
    exported = jax_export.export(jax.jit(fn))(*example_args)
    return bytes(exported.serialize())


def import_fn(blob: bytes) -> Callable:
    """Loads an artifact produced by `export_fn`; returns a callable."""
    exported = jax_export.deserialize(blob)
    return lambda *args: exported.call(*args)


def make_retrieval_service(
    query_fn: Callable, retrieval_layer: Any
) -> Callable:
    """One function: raw query features -> (scores, ids).

    `query_fn` maps input features to [B, D] query embeddings;
    `retrieval_layer` is a built BruteForce/KMeans retrieval layer whose
    candidates are baked into the artifact at export time.
    """

    def service(inputs):
        return retrieval_layer(query_fn(inputs))

    return service
