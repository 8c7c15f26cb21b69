"""File-fed MLPerf pipeline: ml_perf trained from file-batched TFRecords.

The reference trains from tf.data-fed Criteo files (dataloader.py:
135-200). This tool generates ~1M records of synthetic Criteo in the
reference's FILE-BATCHED schema at real record size (file_batch_size=
4224, full 26-feature multi-hot mix — configs/v6e_8_full_dataset.py:
17-21), then runs examples/ml_perf/main.py from those files: threaded
host loader (fixed-column native parse) -> host COO preprocess ->
device. Vocabs are capped at 1M rows/table (the same cap as bench.py's
flagship variant); ids/example and record bytes stay at flagship
valence, which is what the pipeline rate depends on.

Reports the post-warmup wall throughput (the host-pipeline number) and
the scan-chained device step for the same model, so the two can be
compared.

Usage: python tools/mlperf_files_chip.py [--steps 300] [--records ~1M]
       python tools/mlperf_files_chip.py --cpu --vocab-cap 30000 \
           --steps 2 --batch 256 --files 2 --data-dir .data/small
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from keras_rs_tpu.data import criteo  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Reference Criteo shape (examples/ml_perf/configs.py mirrors it).
VOCABS = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
MULTI_HOT = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]
FBS = 4224  # reference v6e_*_full_dataset.py:17
VOCAB_CAP = 1_000_000  # bench.py flagship variant's per-table cap


def ensure_files(
    data_dir: str,
    protos_per_file: int,
    num_files: int,
    seed: int = 13,
    cap: int = VOCAB_CAP,
):
    os.makedirs(data_dir, exist_ok=True)
    have = globlib.glob(os.path.join(data_dir, "*.tfrecord"))
    if len(have) >= num_files:
        return
    # Generation draws ids under the CAPPED vocabs so training never
    # sees an out-of-range id.
    criteo.write_batched_criteo_files(
        data_dir,
        num_files=num_files,
        protos_per_file=protos_per_file,
        file_batch_size=FBS,
        vocab_sizes=[min(v, cap) for v in VOCABS],
        multi_hot_sizes=MULTI_HOT,
        seed=seed,
        # Learnable CTR labels (synthetic.ctr_labels): the run proves
        # LEARNING from real file-batched TFRecords end-to-end (native
        # parse -> COO -> device), not just plumbing — random labels pin
        # AUC at 0.5.
        learnable=True,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--files", type=int, default=40)
    ap.add_argument(
        # ensure_files only counts files: a directory written with other
        # settings is reused as it is.
        "--data-dir",
        default=os.path.join(REPO_ROOT, ".data", "criteo_files"),
    )
    ap.add_argument("--eval-every", type=int, default=0)
    # Smaller cap (with a matching fresh --data-dir) lets the whole
    # pipeline smoke-test on the CPU backend.
    ap.add_argument("--vocab-cap", type=int, default=VOCAB_CAP)
    ap.add_argument("--loader-threads", type=int, default=4)
    # CPU smoke mode (pair with a small --vocab-cap and fresh
    # --data-dir).
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")

    ensure_files(
        args.data_dir, protos_per_file=6, num_files=args.files,
        cap=args.vocab_cap,
    )
    # Held-out VALIDATION files (disjoint generator seed, same CTR label
    # function — ctr_labels' latent weights depend only on label_seed):
    # AUC is then measured on file-batched records the model never
    # trained on, end to end through the same native parse -> COO path.
    val_dir = args.data_dir + "_val"
    ensure_files(
        val_dir, protos_per_file=6, num_files=2, seed=1400,
        cap=args.vocab_cap,
    )
    n_rec = args.files * 6 * FBS
    print(f"dataset: {args.files} files, {n_rec:,} records (+2 val files)")

    from examples.ml_perf.main import main as ml_perf_main

    r = ml_perf_main(
        "smoke_test",
        vocab_sizes=[min(v, args.vocab_cap) for v in VOCABS],
        multi_hot_sizes=MULTI_HOT,
        global_batch_size=args.batch,
        num_steps=args.steps,
        file_pattern=os.path.join(args.data_dir, "*.tfrecord"),
        val_file_pattern=os.path.join(val_dir, "*.tfrecord"),
        file_batch_size=FBS,
        num_loader_threads=args.loader_threads,
        scan_timing=True,
        **({"eval_every": args.eval_every} if args.eval_every else {}),
    )
    out = {
        "metric": "mlperf_file_pipeline_examples_per_sec",
        "value": round(r.get("throughput", 0.0), 1),
        "unit": "examples/s",
        "auc": r.get("auc"),
        "accuracy": r.get("accuracy"),
        "auc_curve": r.get("auc_curve"),
        "loss": r.get("loss"),
        "device_step_ms": r.get("device_step_ms"),
        "device_examples_per_sec": r.get("device_examples_per_sec"),
        "steps": args.steps,
        "batch": args.batch,
        "records": n_rec,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
