"""Per-op device time of the DLRM-DCNv2 train step, from a profiler trace.

Builds the MLPerf model (`examples.ml_perf.main.build_model`, the
`full_criteo` widths) with every table capped at `--vocab-cap` rows, runs
`--steps` train steps (in-step device preprocessing) chained in one
jitted scan under `jax.profiler`, and reduces the trace to:

  * device op time per step;
  * the ops under the `embedding_update` named scope (lookup.py: the
    unique-row block gather, `optimizer.apply` and the `.at[].set`
    scatter) per step, beside the bytes that update must move and the
    time those bytes take at the device's published memory bandwidth
    (bench.DEVICE_PEAKS);
  * every op above `--min-us` per step.

Trace events name their HLO instruction (`hlo_op`); the compiled HLO's
`op_name` metadata maps each instruction to its named scope. On the GPU
the tool turns XLA's CUDA-graph capture off, so that each op is its own
trace event.

Usage:  python tools/profile_embedding.py [--steps 5] [--batch 16384]
            [--vocab-cap 4000000] [--json chiprun_out/profile.json]
        python tools/profile_embedding.py --cpu --batch 64 \\
            --vocab-cap 30000      (CPU smoke of capture and reduction)
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

SCOPE = "embedding_update"

_HLO_LINE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\""
)


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> its metadata op_name (scope path)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def device_op_times(xplane_path: str) -> dict[str, float]:
    """Total device nanoseconds per HLO instruction in one trace.

    Uses the device planes when the trace has any (on a GPU, only their
    "XLA Ops" line, whose events are one per executed op), else the host
    CPU plane (the CPU backend runs ops on host threads).
    """
    from jax.profiler import ProfileData

    planes = list(ProfileData.from_file(xplane_path).planes)
    dev = [p for p in planes if p.name.startswith("/device:")]
    use = dev or [p for p in planes if p.name == "/host:CPU"]
    times: dict[str, float] = collections.defaultdict(float)
    for plane in use:
        lines = list(plane.lines)
        ops_lines = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in ops_lines or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op:
                    times[str(op)] += ev.duration_ns
    return dict(times)


def update_bytes(stack, rows: int) -> int:
    """Bytes the packed-layout update must move for `rows` unique rows:
    read each [stride, dim] block and its gradient row, write the block."""
    block = stack.state_stride * stack.stack_dim * 4
    return rows * (2 * block + stack.stack_dim * 4)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--vocab-cap", type=int, default=4_000_000)
    ap.add_argument("--min-us", type=float, default=100.0)
    ap.add_argument(
        "--out", default=os.path.join(REPO_ROOT, "chiprun_out", "trace")
    )
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU smoke run: no roofline, no card query")
    args = ap.parse_args(argv)
    if not args.cpu:
        # One trace event per op: by default XLA captures the step into a
        # CUDA graph, which the trace shows as one "command_buffer" op.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()

    import jax
    import optax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from examples.ml_perf.configs import full_criteo
    from examples.ml_perf.main import build_model
    from keras_rs_tpu import training
    from keras_rs_tpu.data.criteo import CriteoDataset
    from keras_rs_tpu.models.dlrm import bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib
    from keras_rs_tpu.utils.compile_cache import enable_compile_cache
    from keras_rs_tpu.utils.timing import make_scan_runner

    enable_compile_cache()
    device = jax.devices()[0]
    card = []
    hbm = None
    if not args.cpu:
        from bench import device_peaks
        from chip_smoke import card_name_and_power

        hbm = device_peaks(device)["hbm_bytes_per_s"]
        card = card_name_and_power()
    mesh = mesh_lib.create_mesh([device])
    cfg = full_criteo(global_batch_size=args.batch)
    cfg.vocab_sizes = [min(v, args.vocab_cap) for v in cfg.vocab_sizes]
    model = build_model(cfg, mesh)
    (stack,) = model.embedding_layer.stacks
    raw = next(
        CriteoDataset(
            None,
            global_batch_size=args.batch,
            vocab_sizes=cfg.vocab_sizes,
            multi_hot_sizes=cfg.multi_hot_sizes,
        ).dummy_batches(1)
    )
    # Unique rows this batch touches (tables are disjoint in the stack).
    unique_rows = sum(
        len(np.unique(raw[f"cat_{i}"])) for i in model.large_idx
    )
    batch = mesh_lib.put_batch(mesh, raw)

    def loss_fn(m, b):
        return bce_loss(m, m.preprocess_on_device(b))

    optimizer = optax.adagrad(cfg.learning_rate)
    state = training.create_train_state(model, optimizer)
    del model
    step = training.make_train_step(loss_fn, optimizer)
    run = make_scan_runner(step, args.steps)
    compiled = run.lower(state, batch).compile()
    names = hlo_op_names(compiled.as_text())
    state, loss = compiled(state, batch)  # warm
    jax.block_until_ready((state, loss))
    jax.profiler.start_trace(args.out)
    state, loss = compiled(state, batch)
    jax.block_until_ready((state, loss))
    jax.profiler.stop_trace()
    del state

    paths = sorted(
        glob.glob(os.path.join(args.out, "plugins/profile/*/*.xplane.pb")),
        key=os.path.getmtime,
    )
    times = device_op_times(paths[-1])
    per_step_us = {k: v / args.steps / 1e3 for k, v in times.items()}
    total_ms = sum(per_step_us.values()) / 1e3
    update = {
        k: v for k, v in per_step_us.items() if SCOPE in names.get(k, "")
    }
    update_ms = sum(update.values()) / 1e3
    capacity = stack.max_unique_ids_per_shard
    out = {
        "card": card,
        "device": device.device_kind,
        "batch": args.batch,
        "stacked_rows": stack.global_rows,
        "unique_capacity": capacity,
        "unique_rows": unique_rows,
        "device_op_ms_per_step": round(total_ms, 4),
        "update_ms_per_step": round(update_ms, 4),
        "update_ops": {k: round(v, 1) for k, v in sorted(
            update.items(), key=lambda kv: -kv[1])},
        "update_bytes_at_capacity": update_bytes(stack, capacity),
        "update_bytes_at_unique": update_bytes(stack, unique_rows),
        "ops_mapped_to_scopes": sum(k in names for k in times),
        "ops_traced": len(times),
    }
    if hbm:
        for key in ("capacity", "unique"):
            b = out[f"update_bytes_at_{key}"]
            out[f"update_min_ms_at_{key}"] = round(b / hbm * 1e3, 4)
            if update_ms:
                out[f"update_roofline_share_at_{key}"] = round(
                    b / hbm * 1e3 / update_ms, 4
                )
    for line in card:
        print(f"nvidia-smi: {line}")
    print(f"device op time/step: {total_ms:.3f} ms ({len(times)} ops); "
          f"{SCOPE}: {update_ms:.3f} ms/step")
    print(f"{'us/step':>10}  op  [scope]")
    for k, us in sorted(per_step_us.items(), key=lambda kv: -kv[1]):
        if us >= args.min_us:
            print(f"{us:>10.1f}  {k}  [{names.get(k, '?')[-90:]}]")
    print(json.dumps(out))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
