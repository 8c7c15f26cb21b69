"""Benchmark: DLRM-DCNv2 END-TO-END train pipeline throughput.

Both pipelines start from raw on-device id batches and are fully jitted:

  ours : in-step device COO preprocessing (device_preprocessing.py) +
         sharded lookup with the fused row-wise optimizer (O(unique)
         updates).
  naive: dense EmbedReduce lookups + dense autodiff embedding gradients +
         full-table optax update — what you get without a sharded
         embedding engine. (It needs no COO preprocessing, so this is a
         fair end-to-end comparison.)

Runs on the first `--num_devices` devices (default 1) and needs a device
listed in `DEVICE_PEAKS`; any other device is an error.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {"platform", "kind", "count"}, ...}
vs_baseline = our examples/s over the naive baseline's examples/s on the
same device and model shape.
"""

from __future__ import annotations

import json
import os

import numpy as np


def build(
    placement: str,
    mesh,
    batch_size: int,
    vocab: int,
    dim: int,
    vocab_sizes=None,
    multi_hot_sizes=None,
    max_unique=None,
):
    import jax
    import optax

    num_shards = mesh.devices.size

    from keras_rs_tpu import training
    from keras_rs_tpu.data import synthetic
    from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib

    if vocab_sizes is None:
        vocab_sizes = [vocab, vocab // 2, 2000, 500]
        multi_hot_sizes = [3, 2, 1, 1]
    # Worst-case per-bucket capacity so NO ids are dropped:
    # sum_f (B / D) * multi_hot_f for the large-table stack.
    large_ids = sum(
        m
        for v, m in zip(vocab_sizes, multi_hot_sizes)
        if v >= 21_000
    )
    cfg = DLRMConfig(
        vocab_sizes=vocab_sizes,
        multi_hot_sizes=multi_hot_sizes,
        num_dense_features=13,
        embedding_dim=dim,
        bottom_mlp=(512, 256, dim),
        top_mlp=(1024, 512, 256, 1),
        num_dcn_layers=3,
        dcn_projection_dim=256,
        embedding_threshold=21_000,
        max_ids_per_partition=(batch_size // num_shards) * large_ids,
        max_unique_ids_per_partition=max_unique
        if max_unique is not None
        else (batch_size // num_shards)
        * large_ids
        // max(1, num_shards),
        learning_rate=0.0034,
        global_batch_size=batch_size,
        table_placement=placement,
        # BENCH_TABLE_DTYPE=bfloat16 measures the half-memory table mode
        # (split state layout + stochastic-rounded updates; the packed
        # layout requires f32).
        table_dtype=os.environ.get("BENCH_TABLE_DTYPE", "float32"),
        # BENCH_EMB_OPTIMIZER=rowwise_adagrad measures the scalar-slot
        # capacity mode (pairs with bfloat16 tables: ~260 B/row total
        # state vs 1536 B split-f32).
        embedding_optimizer=os.environ.get(
            "BENCH_EMB_OPTIMIZER", "adagrad"
        ),
        # bf16-resident dense activations are the DLRMConfig default;
        # BENCH_DENSE_OUTPUT_DTYPE=float32 restores the f32-resident
        # stack for A/Bs.
        dense_output_dtype=os.environ.get(
            "BENCH_DENSE_OUTPUT_DTYPE", "bfloat16"
        ),
        # BENCH_COMM_DTYPE=bfloat16 compresses the embedding exchange
        # collectives (halves their bytes; single-device effect is nil —
        # this knob exists for multi-device runs).
        embedding_comm_dtype=os.environ.get("BENCH_COMM_DTYPE") or None,
    )
    model = DLRMDCNv2(cfg, key=jax.random.key(0), mesh=mesh)
    raw = synthetic.criteo_like_batch(
        batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        seed=0,
    )
    # Raw batch on device (sharded over the batch axis) — both pipelines
    # do everything else inside one jitted step.
    batch = {
        k: mesh_lib.put_batch(mesh, np.asarray(v)) for k, v in raw.items()
    }

    optimizer = optax.adagrad(cfg.learning_rate)
    state = training.create_train_state(model, optimizer)

    def loss_fn(m, b):
        return bce_loss(m, m.preprocess_on_device(b))

    step = training.make_train_step(loss_fn, optimizer)
    return state, step, batch, cfg, model


#: Published dense peaks by `device_kind` (NVIDIA H100 SXM data sheet:
#: bf16 tensor-core FLOP/s without sparsity, HBM3 bytes/s). These are the
#: denominators of every roofline share; a device missing here is an
#: error, never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device) -> dict:
    """Peak rates of `device`; raises for a device the table lacks."""
    try:
        return DEVICE_PEAKS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device.device_kind!r} "
            f"(platform {device.platform!r}); add it to DEVICE_PEAKS"
        ) from None


def dense_flops_per_step(cfg, batch_size: int) -> float:
    """Analytic fwd+bwd matmul FLOPs of the dense stack (MLPs + DCN).

    bwd ~= 2x fwd for matmuls, so total = 3 * fwd. Element-wise ops are
    excluded (they fuse into the matmuls and are not matrix-unit work).
    """
    concat = cfg.bottom_mlp[-1] + cfg.embedding_dim * len(cfg.vocab_sizes)
    macs = 0
    prev = cfg.num_dense_features
    for u in cfg.bottom_mlp:
        macs += prev * u
        prev = u
    for _ in range(cfg.num_dcn_layers):
        macs += concat * cfg.dcn_projection_dim * 2  # down + up proj
    prev = concat
    for u in cfg.top_mlp:
        macs += prev * u
        prev = u
    return 3.0 * 2.0 * macs * batch_size


from keras_rs_tpu.utils.timing import (  # noqa: E402
    make_scan_runner,
    time_block,
)


def main(argv=None) -> None:
    import argparse

    import jax

    from keras_rs_tpu.parallel import mesh as mesh_lib
    from keras_rs_tpu.utils.compile_cache import enable_compile_cache

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--num_devices", type=int, default=1,
        help="run on the first N devices (default 1)",
    )
    args = parser.parse_args(argv)
    enable_compile_cache()
    devices = jax.devices()[: args.num_devices]
    peaks = device_peaks(devices[0])

    batch_size = int(os.environ.get("BENCH_BATCH", 8192))
    vocab = int(os.environ.get("BENCH_VOCAB", 4_000_000))
    dim = int(os.environ.get("BENCH_DIM", 128))
    iters = int(os.environ.get("BENCH_ITERS", 20))
    blocks = int(os.environ.get("BENCH_BLOCKS", 5))

    mesh = mesh_lib.create_mesh(devices)

    # Measure each pipeline serially: each carries its own copy of the
    # tables+slots.
    def timed_blocks(step, state, pre):
        run = make_scan_runner(step, iters)
        _, state = time_block(run, state, pre)  # warm/compile
        ts = []
        for _ in range(blocks):
            el, state = time_block(run, state, pre)
            ts.append(el)
        del state
        return float(np.median(ts)) / iters  # s/step

    def measure(placement):
        state, step, pre, cfg, model = build(
            placement, mesh, batch_size, vocab, dim
        )
        s_per_step = timed_blocks(step, state, pre)
        return batch_size / s_per_step, s_per_step, cfg

    ours, step_s, cfg = measure("sharded")

    # --- roofline accounting ---------------------------------------------
    # Dense-only step: the SAME model with the embedding layer stripped
    # and its activations fed as constant batch data — isolates the dense
    # stack's time for an MFU figure; the difference to the full step is
    # the embedding path's time. (Stripping the layer matters: an
    # Overwrite-wrapped state
    # whose lookup never runs would be assigned a zero cotangent — a
    # multi-GB memset per step that would pollute the measurement.)
    def measure_dense_only():
        import jax
        import optax

        from keras_rs_tpu import training
        from keras_rs_tpu.models.dlrm import bce_loss

        _, _, pre, cfg, model = build(
            "sharded", mesh, batch_size, vocab, dim
        )
        # `pre` is the RAW id batch (preprocessing runs in-step on
        # device); run preprocess+lookup once to get the activations.
        acts = jax.jit(
            lambda m, b: m.embedding_layer(
                m.preprocess_on_device(b)["large_pre"]
            )
        )(model, pre)
        model_d = model.replace(embedding_layer=None)
        state_d = training.create_train_state(
            model_d, optax.adagrad(cfg.learning_rate)
        )
        batch = {k: v for k, v in pre.items() if k != "large_pre"}
        batch["large_acts"] = acts
        step_dense = training.make_train_step(
            lambda m, b: bce_loss(m, b),
            optax.adagrad(cfg.learning_rate),
        )
        return timed_blocks(step_dense, state_d, batch)

    # BENCH_DENSE_REPEATS>1: repeat the dense-only scan in THIS process
    # and report mean±std.
    dense_repeats = int(os.environ.get("BENCH_DENSE_REPEATS", 1))
    dense_samples = [measure_dense_only() for _ in range(dense_repeats)]
    dense_s = float(np.median(dense_samples))

    flops = dense_flops_per_step(cfg, batch_size)
    mfu_dense = flops / dense_s / (
        peaks["bf16_flops_per_s"] * mesh.devices.size
    )

    # BENCH_SKIP_NAIVE=1 skips the naive-baseline build (it needs only
    # the dense samples).
    if os.environ.get("BENCH_SKIP_NAIVE", "0") == "1":
        naive = None
    else:
        naive, _, _ = measure("default_device")

    out = {
        "metric": "dlrm_dcnv2_train_examples_per_sec",
        "value": round(ours, 1),
        "unit": "examples/s",
        "vs_baseline": round(ours / naive, 3) if naive else None,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
        "step_ms": round(step_s * 1e3, 3),
        "dense_ms": round(dense_s * 1e3, 3),
    }
    if dense_repeats > 1:
        out.update(
            dense_ms_samples=[
                round(s * 1e3, 3) for s in dense_samples
            ],
            dense_ms_mean=round(float(np.mean(dense_samples)) * 1e3, 3),
            dense_ms_std=round(float(np.std(dense_samples)) * 1e3, 3),
        )
    # A measurement that can fail must SAY so: a dense-only scan slower
    # than the full step, or an mfu above 1.0, means the sub-measurement
    # was corrupted (e.g. another process on the device) — emit an
    # error field and null the derived numbers instead of clamping them
    # into plausible-looking values.
    if dense_s >= step_s or mfu_dense > 1.0:
        out.update(
            mfu_dense=None,
            embedding_ms=None,
            dense_error=(
                f"dense-only sub-measurement implausible (dense_ms="
                f"{dense_s * 1e3:.3f} vs step_ms={step_s * 1e3:.3f}, "
                f"raw mfu={mfu_dense:.3f}); derived roofline fields "
                f"withheld"
            ),
        )
    else:
        out.update(
            mfu_dense=round(mfu_dense, 3),
            embedding_ms=round((step_s - dense_s) * 1e3, 3),
        )

    # --- pipelined-embedding variant (BENCH_PIPELINE=1) ------------------
    # One-step-stale execution
    # (training/pipelined.py): the prefetch gather for batch t+1 carries
    # no data dependency on the dense stack, so XLA may overlap it (and
    # its exchange collectives on multi-chip) with the dense matmuls.
    # Same end-to-end dataflow as the main line: ONE in-step device COO
    # preprocess per batch, shared by the prefetch and the scatter.
    if os.environ.get("BENCH_PIPELINE", "0") == "1":
        try:
            import gc

            import jax
            import optax

            from keras_rs_tpu import training
            from keras_rs_tpu.models.dlrm import bce_loss

            gc.collect()
            _, _, raw_p, cfg_p, model_p = build(
                "sharded", mesh, batch_size, vocab, dim
            )
            optimizer_p = optax.adagrad(cfg_p.learning_rate)
            embed_fn, get_pre, inject = training.dlrm_pipeline_fns()
            body = training.make_pipelined_train_step(
                bce_loss,
                optimizer_p,
                embed_fn,
                get_pre,
                inject,
                jit=False,
            )

            def step_p(state, raw):
                # One device-COO preprocess per batch; its result feeds
                # both this batch's scatter and (as the bench's stand-in
                # for the next batch) the stale prefetch.
                b = state.model.preprocess_on_device(raw)
                return body(state, b, b["large_pre"])

            first_pre = jax.jit(
                lambda m, r: m.preprocess_on_device(r)["large_pre"]
            )(model_p, raw_p)
            state_p = training.create_pipelined_train_state(
                model_p, optimizer_p, first_pre, embed_fn
            )
            del first_pre
            run_p = make_scan_runner(step_p, iters)
            _, state_p = time_block(run_p, state_p, raw_p)
            ts_p = []
            for _ in range(blocks):
                el, state_p = time_block(run_p, state_p, raw_p)
                ts_p.append(el)
            del state_p
            p_s = float(np.median(ts_p)) / iters
            out.update(
                pipelined_examples_per_sec=round(batch_size / p_s, 1),
                pipelined_step_ms=round(p_s * 1e3, 3),
            )
        except Exception as e:  # noqa: BLE001 — report, don't die
            out.update(pipelined_error=f"{type(e).__name__}: {e}"[:200])

    # --- flagship-valence variant --------------------------------------
    # The reference's MLPerf workload carries ~172 large-table ids per
    # example (26-table Criteo mix, feature_list_length up to 100 —
    # reference configs/v6e_8.py:15-172); the default bench shape above
    # carries 5. This variant keeps the reference's exact multi-hot mix
    # and caps per-table vocabs (BENCH_VOCAB_CAP) — valence (entries/
    # batch ≈ 1.4M) is what's under test, not capacity. Measured
    # end-to-end like the main pipeline (in-step device COO
    # preprocessing + sharded lookup).
    if os.environ.get("BENCH_FLAGSHIP", "1") == "1":
        # Fail-safe: an OOM (or any other failure) here must not take
        # down the main bench line.
        try:
            from examples.ml_perf.configs import (
                CRITEO_MULTI_HOT_SIZES,
                CRITEO_VOCAB_SIZES,
            )

            import gc

            gc.collect()  # drop any lingering prior-variant device state
            cap = int(os.environ.get("BENCH_VOCAB_CAP", 1_000_000))
            fv = [min(v, cap) for v in CRITEO_VOCAB_SIZES]
            fb = int(os.environ.get("BENCH_FLAGSHIP_BATCH", batch_size))
            # Unique-row CAPACITY sized to the workload, reference
            # practice (its v6e configs set max_unique_ids_per_partition
            # to HALF of max_ids_per_partition): the bwd block
            # gather/optimizer math/update scatter all scale with the
            # static U, so a capacity that assumes zero dedup pays for
            # rows that never occur. Count the batch's actual uniques
            # host-side (the scan feeds the same ids every iteration)
            # and add 7% headroom — uniq < U always holds, so no id is
            # ever dropped. BENCH_FLAGSHIP_UNIQUE_HEADROOM=inf restores
            # the old no-dedup capacity.
            from keras_rs_tpu.data import synthetic as _synth

            raw_f = _synth.criteo_like_batch(
                fb, vocab_sizes=fv,
                multi_hot_sizes=CRITEO_MULTI_HOT_SIZES, seed=0,
            )
            uniq = sum(
                len(np.unique(np.asarray(raw_f[f"cat_{i}"])))
                for i, v in enumerate(fv)
                if v >= 21_000
            )
            del raw_f
            headroom = float(
                os.environ.get("BENCH_FLAGSHIP_UNIQUE_HEADROOM", "1.07")
            )
            max_u = (
                None
                if headroom == float("inf")
                else int(-(-uniq * headroom // 8) * 8)
            )
            state_f, step_f, pre_f, cfg_f, _ = build(
                "sharded", mesh, fb, vocab, dim,
                vocab_sizes=fv, multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
                max_unique=max_u,
            )
            run_f = make_scan_runner(step_f, iters)
            _, state_f = time_block(run_f, state_f, pre_f)
            ts_f = []
            for _ in range(max(3, blocks - 2)):
                el, state_f = time_block(run_f, state_f, pre_f)
                ts_f.append(el)
            del state_f
            f_s = float(np.median(ts_f)) / iters
            large_ids = sum(
                m
                for v, m in zip(fv, CRITEO_MULTI_HOT_SIZES)
                if v >= cfg_f.embedding_threshold
            )
            out.update(
                flagship_examples_per_sec=round(fb / f_s, 1),
                flagship_step_ms=round(f_s * 1e3, 3),
                flagship_entries_per_batch=large_ids * fb,
                flagship_unique_rows=uniq,
            )
        except Exception as e:  # noqa: BLE001 — report, don't die
            out.update(flagship_error=f"{type(e).__name__}: {e}"[:200])

    print(json.dumps(out))


if __name__ == "__main__":
    main()
