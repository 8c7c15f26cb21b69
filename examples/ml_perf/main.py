"""MLPerf DLRM-DCNv2 training entry point.

Parity with examples/ml_perf/main.py in the reference: mesh setup,
small/large feature split inside DLRMDCNv2, threaded host preprocessing
(ThreadedDataLoader), BCE + AUC/accuracy eval, optional profiler trace,
checkpointing. Multi-host: each process feeds its shard of the global
batch (CriteoDataset process_index/process_count + identical shuffle).

Run:
  python -m examples.ml_perf.main --config smoke_test
  python -m examples.ml_perf.main --config smoke_test --num_devices 1
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m examples.ml_perf.main --config smoke_test
"""

from __future__ import annotations

import argparse
import logging
import os as _os
import sys as _sys
import time

# Direct-file invocation (`python examples/ml_perf/main.py`) puts
# examples/ml_perf/ at sys.path[0], not the repo root — bootstrap so
# `examples.ml_perf.configs` and `keras_rs_tpu` resolve either way.
_sys.path.insert(
    0,
    _os.path.dirname(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    ),
)

import jax
import numpy as np
import optax

from examples.ml_perf.configs import CONFIGS
from keras_rs_tpu import training
from keras_rs_tpu.data.criteo import CriteoDataset
from keras_rs_tpu.data.loader import ThreadedDataLoader
from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
from keras_rs_tpu.parallel import mesh as mesh_lib
from keras_rs_tpu.parallel import multihost
from keras_rs_tpu.utils.compile_cache import enable_compile_cache

logging.basicConfig(level=logging.INFO, force=True)
logger = logging.getLogger("ml_perf")


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (equivalent to the Wilcoxon statistic)."""
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def build_model(cfg, mesh) -> DLRMDCNv2:
    """The DLRM-DCNv2 model of experiment config `cfg` on `mesh`."""
    # The jitted step has static COO shapes: size the per-bucket
    # capacity for the worst case (every large id of a shard's batch
    # slice landing in one bucket), like bench.py does, on both paths.
    # The in-jit path cannot grow at all, and a capacity the host path
    # grew would no longer match the compiled step. Device cost is
    # modest (int32/f32 COO buffers).
    D = mesh.devices.size
    large_mh = sum(
        m
        for v, m in zip(cfg.vocab_sizes, cfg.multi_hot_sizes)
        if v >= cfg.embedding_threshold
    )
    max_ids = (cfg.global_batch_size // D) * large_mh
    # Per-shard unique capacity: uniform MOD sharding concentrates
    # tightly around max_ids/D distinct ids per shard; provision
    # `device_unique_factor`x that (capped at max_ids, the
    # one-source-entirely-congruent case). The theoretical worst
    # case is D*max_ids (EVERY source's ids congruent mod D) but
    # sizing for it multiplies the backward's per-unique-row work by
    # D; instead main() host-reads DeviceStats.dropped_ids
    # so any residual truncation is observed, not silent.
    max_unique = max(
        1,
        min(max_ids, cfg.device_unique_factor * -(-max_ids // D)),
    )
    model_cfg = DLRMConfig(
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        embedding_dim=cfg.embedding_dim,
        bottom_mlp=cfg.bottom_mlp,
        top_mlp=cfg.top_mlp,
        num_dcn_layers=cfg.num_dcn_layers,
        dcn_projection_dim=cfg.dcn_projection_dim,
        embedding_threshold=cfg.embedding_threshold,
        # The large tables always go through the sharded engine (the
        # reference places them on its embedding accelerator); "auto"
        # would turn them into plain dense tables on a one-device mesh.
        table_placement="sharded",
        max_ids_per_partition=max_ids,
        max_unique_ids_per_partition=max_unique,
        learning_rate=cfg.learning_rate,
        global_batch_size=cfg.global_batch_size,
        embedding_comm_dtype=cfg.embedding_comm_dtype,
        dense_output_dtype=cfg.dense_output_dtype,
    )
    return DLRMDCNv2(model_cfg, key=jax.random.key(0), mesh=mesh)


def main(config_name: str = "smoke_test", **overrides) -> dict:
    multihost.initialize()
    cache_dir = enable_compile_cache()
    cfg = CONFIGS[config_name](**overrides)
    mesh = mesh_lib.create_mesh(
        jax.devices()[: cfg.num_devices] if cfg.num_devices else None
    )
    logger.info(
        "config=%s devices=%d (%s) processes=%d compile_cache=%s",
        cfg.name, mesh.devices.size, jax.devices()[0].device_kind,
        jax.process_count(), cache_dir,
    )

    if jax.process_count() > 1 and not cfg.device_preprocessing:
        # The host COO path builds per-source-device buckets AND the
        # per-shard dedup maps, which need the GLOBAL batch — a host
        # only holds its shard. The device path runs the same transform
        # inside jit on the globally-sharded raw ids, so it is the
        # multi-host mode (and the faster one regardless).
        logger.info(
            "multi-host run: enabling device_preprocessing "
            "(host-side COO needs the global batch)"
        )
        cfg.device_preprocessing = True

    model = build_model(cfg, mesh)

    dataset = CriteoDataset(
        cfg.file_pattern,
        global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        file_batch_size=cfg.file_batch_size,
    )

    def raw_batches():
        if cfg.file_pattern:
            yield from dataset.batches(epochs=1000)
        else:
            yield from dataset.dummy_batches(cfg.num_steps)

    def preprocess(batch):
        pre = model.preprocess(batch, training=True)
        for k in list(pre):
            if k in ("dense", "label") or k.startswith("cat_"):
                pre[k] = mesh_lib.put_batch(mesh, np.asarray(pre[k]))
        return pre

    def put_raw(batch):
        # Device-preprocessing mode: host work is just the transfer.
        # Each process contributes its host shard; the result is one
        # globally-sharded array (single-process: plain device_put).
        return multihost.global_batch_from_host_shards(
            mesh, {k: np.asarray(v) for k, v in batch.items()}
        )

    if cfg.device_preprocessing:
        coo_backend = "device"
    else:
        from keras_rs_tpu.layers.embedding import native

        # preprocess_stack(backend="auto") takes the C++ engine when it
        # builds and loads, else the numpy reference.
        coo_backend = "native" if native.available() else "numpy"
    logger.info("COO preprocessing backend: %s", coo_backend)

    # Threaded host preprocessing (main.py:35-105 parity) — or, with
    # device_preprocessing, a thin transfer thread feeding raw ids.
    loader = ThreadedDataLoader(
        raw_batches(),
        put_raw if cfg.device_preprocessing else preprocess,
        num_workers=cfg.num_loader_threads,
    )

    ckpt = (
        training.CheckpointManager(cfg.checkpoint_dir)
        if cfg.checkpoint_dir
        else None
    )
    # Donating the state updates the tables in place; without it every
    # step holds two copies of them. An async checkpoint save may still
    # be reading the previous state's buffers, so donate only when no
    # checkpoint manager is in use.
    donate = ckpt is None

    optimizer = optax.adagrad(cfg.learning_rate)
    pipelined = (
        cfg.pipeline_embedding and model.embedding_layer is not None
    )
    next_batch = None
    if pipelined:
        # One-step-stale pipelined embedding execution (reference knob:
        # pipeline_execution_with_tensor_core). The prefetch for batch
        # t+1 reads the tables before update t, so it carries no data
        # dependency on the dense stack and XLA can overlap the gather +
        # exchange collectives with the dense matmuls.
        if cfg.device_preprocessing:
            def embed_fn(m, raw_large):
                return m.embedding_layer(
                    m.embedding_layer.preprocess_on_device(raw_large)
                )

            def p_get_pre(batch):
                return {
                    f"cat_{i}": batch[f"cat_{i}"]
                    for i in model.large_idx
                }

            def inject(batch, acts):
                return {**batch, "large_acts": acts}

            # Large features arrive via the injected activations;
            # small-table ids and dense floats are consumed raw by the
            # model, so no per-step preprocessing remains.
            p_loss = bce_loss
        else:
            embed_fn, p_get_pre, inject = training.dlrm_pipeline_fns()
            p_loss = bce_loss
        next_batch = next(loader)
        state = training.create_pipelined_train_state(
            model, optimizer, p_get_pre(next_batch), embed_fn
        )
        step_fn = training.make_pipelined_train_step(
            p_loss, optimizer, embed_fn, p_get_pre, inject, donate=donate
        )
    else:
        state = training.create_train_state(model, optimizer)
        if cfg.device_preprocessing:
            def loss_fn(m, b):
                return bce_loss(m, m.preprocess_on_device(b))
        else:
            loss_fn = bce_loss
        step_fn = training.make_train_step(
            loss_fn, optimizer, donate=donate
        )

    # Checkpoint-restart is the failure-recovery story (SURVEY.md §5):
    # on startup, resume from the latest step if one exists — a rerun
    # after a crash continues instead of restarting from scratch.
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, state)
        logger.info("resumed from checkpoint step %d", start_step)
        if pipelined and start_step < cfg.num_steps:
            # The restored `prefetched` activations belong to whatever
            # batch FOLLOWED the checkpoint in the original run; the
            # resumed loop draws a fresh batch, so pairing them would
            # train one step on mismatched (activations, labels).
            # Re-prime fresh from the resumed lookahead batch — same
            # step-0 semantics as a cold start. (Skipped when no
            # training steps will run: the re-prime would pay a wasted
            # jitted lookup compile.)
            state = state._replace(
                prefetched=jax.jit(
                    training.pipelined.prime, static_argnums=(2,)
                )(state.model, p_get_pre(next_batch), embed_fn)
            )

    dropped_fn = None
    if cfg.device_preprocessing and model.embedding_layer is not None:
        # Truncation watchdog for the static-capacity device path: one
        # extra jitted preprocessing pass every 100 steps and after the
        # last one, host-reading only the summed dropped_ids scalar.
        @jax.jit
        def dropped_fn(b):
            large = {
                f"cat_{i}": b[f"cat_{i}"] for i in model.large_idx
            }
            _, stats = model.embedding_layer.preprocess_on_device(
                large, return_stats=True
            )
            return sum(s.dropped_ids for s in stats.values())

    # Eval: streaming BinaryAccuracy + AUC (library metrics; the
    # confusion-state accumulation runs inside the jitted eval step, so
    # only the tiny metric state crosses to the host). Reused by the
    # per-eval_every curve points and the final eval.
    from keras_rs_tpu.metrics import AUC, BinaryAccuracy

    auc_m, acc_m = AUC(num_thresholds=512), BinaryAccuracy()

    @jax.jit
    def eval_step(m, b, auc_state, acc_state):
        if cfg.device_preprocessing:
            b = m.preprocess_on_device(b)
        logits = m(b)
        probs = jax.nn.sigmoid(logits)
        labels = b["label"]
        return (
            auc_m.update(auc_state, labels, probs),
            acc_m.update(acc_state, labels, probs),
            probs,
        )

    def eval_batch_iter():
        if cfg.val_file_pattern:
            val_dataset = CriteoDataset(
                cfg.val_file_pattern,
                global_batch_size=cfg.global_batch_size,
                vocab_sizes=cfg.vocab_sizes,
                multi_hot_sizes=cfg.multi_hot_sizes,
                process_index=jax.process_index(),
                process_count=jax.process_count(),
                file_batch_size=cfg.file_batch_size,
            )
            return val_dataset.batches(epochs=1)
        return dataset.dummy_batches(4, seed=777)

    def run_eval(m, collect_probs=False):
        """Returns (accuracy, auc, labels, probs) over the eval set."""
        auc_state, acc_state = auc_m.init_state(), acc_m.init_state()
        ck_labels, ck_probs = [], []
        for eval_batch in eval_batch_iter():
            pre = (
                multihost.global_batch_from_host_shards(
                    mesh,
                    {k: np.asarray(v) for k, v in eval_batch.items()},
                )
                if cfg.device_preprocessing
                else model.preprocess(eval_batch)
            )
            auc_state, acc_state, probs = eval_step(
                m, pre, auc_state, acc_state
            )
            if collect_probs:
                ck_labels.append(np.asarray(eval_batch["label"]))
                ck_probs.append(np.asarray(probs))
        return (
            float(acc_m.result_from_state(acc_state)),
            float(auc_m.result_from_state(auc_state)),
            ck_labels,
            ck_probs,
        )

    t0 = time.time()
    warmup = min(10, max(0, cfg.num_steps - start_step - 1))
    t_warm = t0
    losses = []
    auc_curve = []
    dropped_total = 0

    def check_dropped(b, step):
        nonlocal dropped_total
        n_dropped = int(dropped_fn(b))
        dropped_total += n_dropped
        if n_dropped:
            logger.warning(
                "device preprocessing dropped %d ids at step %d "
                "(unique capacity overflow — raise "
                "device_unique_factor)",
                n_dropped, step + 1,
            )

    for step in range(start_step, cfg.num_steps):
        if cfg.do_profile and step == 10:
            jax.profiler.start_trace(cfg.profile_dir)
        if pipelined:
            # One-batch lookahead: the step prefetches batch t+1's
            # activations. The final step feeds its own batch again (the
            # prefetch is discarded).
            batch = next_batch
            if step + 1 < cfg.num_steps:
                next_batch = next(loader)
            state, loss = step_fn(state, batch, p_get_pre(next_batch))
        else:
            batch = next(loader)
            state, loss = step_fn(state, batch)
        losses.append(loss)
        if step - start_step + 1 == warmup:
            # Exclude compilation from the throughput figure (the
            # device-preprocessing program's big sorts can take minutes
            # to compile; MLPerf-style accounting starts after warmup).
            jax.block_until_ready(loss)
            t_warm = time.time()
        if cfg.do_profile and step == 20:
            jax.block_until_ready(loss)
            jax.profiler.stop_trace()
        if ckpt and (step + 1) % cfg.checkpoint_every == 0:
            ckpt.save(step + 1, state)
        if cfg.eval_every and (step + 1) % cfg.eval_every == 0:
            # Keep eval wall time out of the training throughput clock.
            t_eval = time.time()
            acc_pt, auc_pt, _, _ = run_eval(state.model)
            auc_curve.append(
                {"step": step + 1, "auc": auc_pt, "accuracy": acc_pt}
            )
            logger.info(
                "eval @ step %d: auc %.4f acc %.4f",
                step + 1, auc_pt, acc_pt,
            )
            t_warm += time.time() - t_eval
        if (step + 1) % 100 == 0:
            logger.info(
                "step %d loss %.5f (%.1f ex/s post-warmup)",
                step + 1,
                float(loss),
                cfg.global_batch_size
                * (step - start_step + 1 - warmup)
                / max(time.time() - t_warm, 1e-9),
            )
            if dropped_fn is not None:
                check_dropped(batch, step)
    if losses:
        jax.block_until_ready(losses[-1])
    throughput = (
        cfg.global_batch_size
        * max(cfg.num_steps - start_step - warmup, 0)
        / max(time.time() - t_warm, 1e-9)
    )
    if dropped_fn is not None and losses and cfg.num_steps % 100:
        check_dropped(batch, cfg.num_steps - 1)

    device_step_ms = None
    if cfg.scan_timing and losses:
        # Device step time without the host loader: chain steps in one
        # jitted scan on the last batch (keras_rs_tpu/utils/timing.py).
        # The state is donated and returned, so training can continue
        # from it.
        from keras_rs_tpu.utils.timing import measure_step_time

        timed_step = step_fn
        if pipelined:
            # The scan runner chains `step(state, batch)` — feed the
            # measured batch's own pre as the prefetch target (steady-
            # state shape/work is identical to a real lookahead).
            raw_p = training.make_pipelined_train_step(
                p_loss, optimizer, embed_fn, p_get_pre, inject,
                donate=False, jit=False,
            )

            def timed_step(s, b):
                return raw_p(s, b, p_get_pre(b))

        s_per_step, state = measure_step_time(
            timed_step, state, batch, iters=20, blocks=3
        )
        device_step_ms = s_per_step * 1e3
        logger.info(
            "scan-chained device step: %.3f ms (%.1f ex/s on-device)",
            device_step_ms,
            cfg.global_batch_size / s_per_step,
        )
    loader.stop()

    # Final eval; the host-side exact rank-based AUC cross-checks the
    # thresholded streaming approximation (single-host only: it needs
    # host-addressable probs).
    single_host = jax.process_count() == 1
    acc, auc, ck_labels, ck_probs = run_eval(
        state.model, collect_probs=single_host
    )
    if single_host:
        # Host cross-check of the streaming approximation (needs
        # host-addressable probs; the streaming metric itself is
        # computed in-jit on the global arrays on any topology).
        exact = binary_auc(
            np.concatenate(ck_labels), np.concatenate(ck_probs)
        )
        if abs(exact - auc) > 0.01:
            logger.warning(
                "streaming AUC %.4f deviates from exact rank AUC %.4f",
                auc, exact,
            )
    if ckpt:
        ckpt.wait_until_finished()

    results = {
        "loss": float(losses[-1]) if losses else float("nan"),
        "losses": [float(v) for v in losses],
        "throughput": throughput,
        "accuracy": acc,
        "auc": auc,
        "num_devices": int(mesh.devices.size),
        "coo_backend": coo_backend,
        "stacked_rows": sum(
            s.global_rows for s in model.embedding_layer.stacks
        )
        if model.embedding_layer is not None
        else 0,
    }
    if dropped_fn is not None:
        results["dropped_ids"] = dropped_total
    if auc_curve:
        results["auc_curve"] = auc_curve
    if device_step_ms is not None:
        results["device_step_ms"] = device_step_ms
        results["device_examples_per_sec"] = (
            cfg.global_batch_size / (device_step_ms / 1e3)
        )
    logger.info("results: %s", results)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="smoke_test")
    parser.add_argument("--num_steps", type=int, default=None)
    parser.add_argument("--global_batch_size", type=int, default=None)
    parser.add_argument(
        "--dense_output_dtype", default=None,
        help="e.g. bfloat16: bf16-resident dense activations "
        "(params/accumulation stay f32)",
    )
    parser.add_argument("--file_pattern", default=None)
    parser.add_argument("--val_file_pattern", default=None)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument(
        "--device_preprocessing", action="store_true",
        help="run COO preprocessing on-device inside the jitted step",
    )
    parser.add_argument(
        "--eval_every", type=int, default=None,
        help="evaluate every N steps and record an AUC curve",
    )
    parser.add_argument(
        "--pipeline_embedding", action="store_true",
        help="one-step-stale pipelined embedding execution (overlaps "
        "the lookup+exchange with the dense compute; reference knob "
        "pipeline_execution_with_tensor_core)",
    )
    parser.add_argument(
        "--scan_timing", action="store_true",
        help="after training, time the train step chained in one jitted "
        "scan (device ms/step without the host loader)",
    )
    parser.add_argument(
        "--num_devices", type=int, default=None,
        help="use only the first N devices (default: all visible)",
    )
    args = parser.parse_args()
    overrides = {}
    if args.num_steps:
        overrides["num_steps"] = args.num_steps
    if args.global_batch_size:
        overrides["global_batch_size"] = args.global_batch_size
    if args.dense_output_dtype:
        overrides["dense_output_dtype"] = args.dense_output_dtype
    if args.file_pattern:
        overrides["file_pattern"] = args.file_pattern
    if args.val_file_pattern:
        overrides["val_file_pattern"] = args.val_file_pattern
    if args.profile:
        overrides["do_profile"] = True
    if args.device_preprocessing:
        overrides["device_preprocessing"] = True
    if args.scan_timing:
        overrides["scan_timing"] = True
    if args.num_devices:
        overrides["num_devices"] = args.num_devices
    if args.pipeline_embedding:
        overrides["pipeline_embedding"] = True
    if args.eval_every:
        overrides["eval_every"] = args.eval_every
    # Env overrides (documented in run.sh; convenient on --worker=all
    # launches where per-worker flags are awkward).
    import os

    if os.environ.get("KRT_PROFILE_DIR"):
        overrides["do_profile"] = True
        overrides["profile_dir"] = os.environ["KRT_PROFILE_DIR"]
    if os.environ.get("KRT_CHECKPOINT_DIR"):
        overrides["checkpoint_dir"] = os.environ["KRT_CHECKPOINT_DIR"]
    main(args.config, **overrides)
