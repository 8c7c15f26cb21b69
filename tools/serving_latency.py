"""AOT-compiled serving latency on one device.

Two production serving shapes, both AOT-compiled (serving.aot_compile —
no tracing on the hot path) and timed as `iters` calls chained in one
jitted scan (keras_rs_tpu.utils.timing.chained_call_ms):

  1. DLRM CTR inference: FrozenEmbedding (slot-free tables) + dense
     stack at serving batches 256/1024/8192.
  2. Retrieval service: query MLP + streaming exact top-10 over 1M x 128
     candidates at batches 1/32/256 (reference anecdote anchor:
     examples/scann.py:254-258 reports ~3 ms ScaNN / ~150 ms brute
     force on CPU for the same task class).

The scan body feeds a data-dependent perturbation of the ids/queries
(carry folded into the inputs) and derives the next carry from the
output, so XLA cannot hoist or DCE the measured op. Tables and
candidates are passed as ARGUMENTS (closure-captured arrays become jit
constants).

Run:  python tools/serving_latency.py            (on the accelerator)
      python tools/serving_latency.py --small    (CPU smoke of the paths)
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from keras_rs_tpu.utils.timing import chained_call_ms  # noqa: E402


def _unique_bytes(tree) -> int:
    """Sum of nbytes over UNIQUE buffers (shared-table features alias
    the same jax.Array; naive tree_leaves would double-count it)."""
    return sum(
        x.nbytes
        for x in {
            id(x): x for x in jax.tree_util.tree_leaves(tree)
        }.values()
    )


def bench_dlrm_inference(small=False):
    from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2

    if small:
        vocabs = [50_000, 30_000, 100, 50]
        mh = [3, 2, 1, 1]
    else:
        # 4 x 1M large tables (1M rows keeps frozen + training state
        # comfortably inside one device) + small in-model tables.
        vocabs = [1_000_000] * 4 + [40_000] * 4 + [100] * 5
        mh = [3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
    from keras_rs_tpu.data import synthetic

    for B in ((256,) if small else (256, 1024, 8192)):
        # FeatureConfig input shapes are static per build: one model per
        # serving batch size (standard AOT serving practice).
        cfg = DLRMConfig(
            vocab_sizes=vocabs,
            multi_hot_sizes=mh,
            global_batch_size=B,
            table_placement="default_device",
        )
        model = DLRMDCNv2(cfg, key=jax.random.key(0), mesh=None)
        frozen = model.embedding_layer.freeze()
        large_idx = list(model.large_idx)

        def forward(model, frozen, batch):
            # Inference: slot-free frozen tables feed the dense stack
            # via the model's precomputed-activations entry — no COO
            # preprocessing, no optimizer state.
            large = {f"cat_{i}": batch[f"cat_{i}"] for i in large_idx}
            b = dict(batch)
            b["large_acts"] = frozen(large)
            return jax.nn.sigmoid(model(b))

        raw = synthetic.criteo_like_batch(
            B, vocab_sizes=vocabs, multi_hot_sizes=mh, seed=0
        )
        batch = {k: jnp.asarray(v) for k, v in raw.items()}

        def perturb(args, tick):
            m, f, b = args
            # The tick must reach EVERY measured op's inputs — dense
            # features AND the categorical ids — or XLA hoists the
            # loop-invariant table gathers out of the scan. tick_i is 0
            # at runtime
            # (derive scales by 1e-6) so the ids actually gathered are
            # unchanged, but its data dependency defeats hoisting.
            tick_i = tick.astype(jnp.int32)
            b2 = dict(b)
            b2["dense"] = b["dense"] + tick.astype(b["dense"].dtype) * 1e-6
            for i, v in enumerate(vocabs):
                k = f"cat_{i}"
                b2[k] = (b[k] + tick_i) % v
            return (m, f, b2)

        def derive(out):
            return jnp.mean(out).astype(jnp.float32) * 1e-6

        ms = chained_call_ms(
            forward, (model, frozen, batch), perturb, derive, iters=30
        )
        f32_bytes = _unique_bytes(frozen)
        print(f"[dlrm-infer] B={B}: {ms:.3f} ms/batch "
              f"({B / ms * 1e3:,.0f} ex/s, tables {f32_bytes/1e6:.0f} MB)")

        # Int8 per-row-quantized frozen tables: 4x less serving memory.
        frozen_q = model.embedding_layer.freeze(quantize="int8")
        ms_q = chained_call_ms(
            forward, (model, frozen_q, batch), perturb, derive, iters=30
        )
        q_bytes = _unique_bytes(frozen_q)
        print(f"[dlrm-infer-int8] B={B}: {ms_q:.3f} ms/batch "
              f"({B / ms_q * 1e3:,.0f} ex/s, tables {q_bytes/1e6:.0f} MB)")
        del frozen_q

        # Group-packed int8: word-typed gather layout, same bytes as
        # int8 (tools/probe_int8_serving.py times the lookup alone).
        frozen_p = model.embedding_layer.freeze(quantize="int8_packed")
        ms_p = chained_call_ms(
            forward, (model, frozen_p, batch), perturb, derive, iters=30
        )
        p_bytes = _unique_bytes(frozen_p)
        print(f"[dlrm-infer-int8-packed] B={B}: {ms_p:.3f} ms/batch "
              f"({B / ms_p * 1e3:,.0f} ex/s, tables {p_bytes/1e6:.0f} MB)")
        del frozen_p

        # FUSED int8+scale: 8 rows + their 8 scales per gathered group
        # (1.5 B/element).
        frozen_f = model.embedding_layer.freeze(quantize="int8_fused")
        ms_f = chained_call_ms(
            forward, (model, frozen_f, batch), perturb, derive, iters=30
        )
        f_bytes = _unique_bytes(frozen_f)
        print(f"[dlrm-infer-int8-fused] B={B}: {ms_f:.3f} ms/batch "
              f"({B / ms_f * 1e3:,.0f} ex/s, tables {f_bytes/1e6:.0f} MB)")
        del model, frozen, frozen_f


def bench_retrieval_service(small=False):
    from keras_rs_tpu.layers.retrieval.retrieval import BruteForceRetrieval

    N, D, k = (20_000, 32, 10) if small else (1_000_000, 128, 10)
    rng = np.random.default_rng(0)
    cands = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    ids = jnp.arange(N, dtype=jnp.int32)
    w1 = jnp.asarray(rng.normal(size=(64, D)).astype(np.float32) * 0.1)

    layer = BruteForceRetrieval(k=k, return_scores=True)
    layer.update_candidates(cands, ids)

    def service(layer, q_raw, w1):
        # The layer is a pytree argument: its 1M x 128 candidate table
        # enters as a buffer, not a jit constant.
        q = jnp.tanh(q_raw @ w1)  # query tower
        return layer(q)

    for B in (1, 32, 256):
        q_raw = jnp.asarray(
            rng.normal(size=(B, 64)).astype(np.float32)
        )

        def perturb(args, tick):
            lyr, q, w = args
            return (lyr, q + tick.astype(q.dtype) * 1e-6, w)

        def derive(out):
            scores = out[0] if isinstance(out, tuple) else out
            return jnp.mean(scores).astype(jnp.float32) * 1e-6

        ms = chained_call_ms(
            service, (layer, q_raw, w1), perturb, derive, iters=30
        )
        print(f"[retrieval] B={B}, N={N}, top-{k}: {ms:.3f} ms/batch")


def main():
    import sys

    small = "--small" in sys.argv
    if small:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        jax.config.update("jax_platforms", "cpu")
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x1")
    bench_retrieval_service(small)
    bench_dlrm_inference(small)


if __name__ == "__main__":
    main()
