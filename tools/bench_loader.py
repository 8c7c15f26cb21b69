"""Loader throughput benchmark: the native TFRecord reader.

Generates synthetic Criteo files in the reference's FILE-BATCHED schema
at REAL record size (file_batch_size=4224, full 26-feature multi-hot mix
— configs/v6e_8_full_dataset.py:17-21 + dataloader.py:135-181), then
measures:
  1. native single-file column-parse rate (records/s, input MB/s),
  2. the legacy two-pass vs single-pass (learned-ratio) protocol,
  3. end-to-end CriteoDataset.batches() rate vs prefetch thread count,
  4. the pure-Python reader on one file (for the speedup figure).

Prints a JSON summary line with the host's core count: the thread-
scaling rows measure how far the loader overlaps on THIS host, which is
what the device's input rate is compared against.

Usage: python tools/bench_loader.py [--records 202752] [--keep DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from keras_rs_tpu.data import criteo, native_io  # noqa: E402

# Full Criteo shape (examples/ml_perf/configs.py mirrors the reference).
VOCABS = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
MULTI_HOT = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]
FBS = 4224  # file_batch_size (reference v6e_*_full_dataset.py:17)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=202_752)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--keep", default=None, help="existing data dir")
    args = ap.parse_args()

    assert native_io.available(), "native reader did not build"
    rec_bytes = 13 * 4 + 8 + sum(MULTI_HOT) * 8
    protos_per_file = 6
    num_files = max(
        2, args.records // (FBS * protos_per_file)
    )

    tmp = None
    if args.keep:
        data_dir = args.keep
        import glob as globlib
        import os

        if not globlib.glob(os.path.join(data_dir, "*.tfrecord")):
            criteo.write_batched_criteo_files(
                data_dir,
                num_files=num_files,
                protos_per_file=protos_per_file,
                file_batch_size=FBS,
                vocab_sizes=VOCABS,
                multi_hot_sizes=MULTI_HOT,
                seed=7,
            )
    else:
        tmp = tempfile.mkdtemp(prefix="criteo_bench_")
        data_dir = tmp
        t0 = time.time()
        criteo.write_batched_criteo_files(
            data_dir,
            num_files=num_files,
            protos_per_file=protos_per_file,
            file_batch_size=FBS,
            vocab_sizes=VOCABS,
            multi_hot_sizes=MULTI_HOT,
            seed=7,
        )
        print(f"generated {num_files} files in {time.time() - t0:.1f}s")

    try:
        run(data_dir, args.batch, rec_bytes)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def run(data_dir: str, batch: int, rec_bytes: int) -> None:
    import glob as globlib
    import os

    files = sorted(globlib.glob(os.path.join(data_dir, "*.tfrecord")))
    fsize = os.path.getsize(files[0])
    keys = (
        ["clicked"]
        + [f"int-feature-{i}" for i in range(1, 14)]
        + [f"categorical-feature-{i}" for i in range(14, 40)]
    )

    # 1. Single-file native parse. Warm the OS page cache and the
    #    ratio cache first — generation dirties pages and the first
    #    touch pays page faults; production readers stream files the
    #    page cache has prefetched, which warm numbers model. Take the
    #    median of 5.
    native_io._est_cache.clear()
    native_io.parse_file_batched(files[0], keys)  # sizing+fill, warms
    native_io.parse_file_batched(files[1], keys)

    def timed(path):
        t0 = time.time()
        n, _ = native_io.parse_file_batched(path, keys)
        return n, time.time() - t0

    n, two_pass_s = timed(files[0])
    with_cache = sorted(timed(files[1])[1] for _ in range(5))
    one_pass_s = with_cache[2]
    def timed_two_pass(path):
        native_io._est_cache.clear()
        return timed(path)

    no_cache = sorted(timed_two_pass(files[1])[1] for _ in range(5))
    print(
        f"native parse warm: single-pass {n * FBS / one_pass_s:,.0f} "
        f"rec/s ({fsize / one_pass_s / 1e6:,.0f} MB/s input), "
        f"two-pass {n * FBS / no_cache[2]:,.0f} rec/s"
    )

    # 2. Pure-Python reference point (one proto is plenty).
    from keras_rs_tpu.data.tfrecord import parse_example, read_tfrecords

    t0 = time.time()
    payload = next(read_tfrecords(files[0]))
    parse_example(payload)
    py_s = time.time() - t0
    py_rate = FBS / py_s

    # 3. End-to-end batches() vs prefetch depth: one full warm epoch
    #    (page cache + ratio cache), then a measured epoch.
    e2e = {}
    for depth in (1, 2, 4):
        ds = criteo.CriteoDataset(
            os.path.join(data_dir, "*.tfrecord"),
            global_batch_size=batch,
            vocab_sizes=VOCABS,
            multi_hot_sizes=MULTI_HOT,
            file_batch_size=FBS,
        )
        for _ in ds.batches(epochs=1, file_prefetch=depth):
            pass
        t0 = time.time()
        got = 0
        for b in ds.batches(epochs=1, file_prefetch=depth):
            got += len(b["label"])
        dt = time.time() - t0
        e2e[depth] = got / dt
        print(f"end-to-end batches() depth={depth}: {got / dt:,.0f} ex/s")

    best = max(e2e.values())
    summary = {
        "metric": "criteo_loader_examples_per_sec",
        "value": round(best, 1),
        "unit": "examples/s",
        "record_bytes": rec_bytes,
        "native_single_pass_rec_s": round(n * FBS / one_pass_s, 1),
        "native_mb_s": round(fsize / one_pass_s / 1e6, 1),
        "python_rec_s": round(py_rate, 1),
        "speedup_vs_python": round(best / py_rate, 1),
        "host_cores": os.cpu_count(),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
