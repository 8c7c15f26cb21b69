"""Weak-scaling communication accounting over virtual CPU meshes.

Compiler-level evidence that needs no multi-device hardware: for
n = 1/2/4/8 virtual devices at FIXED per-device
batch (weak scaling), compile the FULL hybrid train step (data-parallel
dense + MOD-sharded embedding + fused optimizers) and account every
collective in the optimized HLO — op kind, tensor bytes, and the
per-device comm volume — plus the XLA cost model's FLOP count.

Design expectation (scaling-book dataflow, matching the SparseCore
exchange the lookup rebuilds): per-device all-to-all bytes stay CONSTANT
as n grows (each device exchanges its local batch's activations), the
dense all-reduce per-device bytes stay CONSTANT (ring reduce of fixed
parameter grads), so comm/compute ratio is flat and weak-scaling
efficiency is bounded by interconnect bandwidth, not by algorithmic
growth. The table printed here verifies the constancy; it measures no
device time.

Usage: python tools/weak_scaling.py  (forces CPU, 8 virtual devices)
"""

from __future__ import annotations

import json
import os
import re
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import optax  # noqa: E402

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1,
    "f8e5m2": 1, "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2,
    "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVES = (
    "all-to-all",
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
)


def shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string like 'f32[8,128]' or a tuple."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sums output bytes of every collective instruction by kind."""
    out = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.\-]+ = (.+?) ([\w\-]+)\(", line)
        if not m:
            continue
        shape_str, op = m.groups()
        # Normalize fusion names like all-to-all.42 handled by regex op
        # group already (no dot); check the op kind.
        for kind in _COLLECTIVES:
            if op == kind or op.startswith(kind + "-start"):
                out[kind] += shape_bytes(shape_str)
                break
    return out


def measure(
    n_devices: int,
    per_device_batch: int = 64,
    comm_dtype: str | None = None,
) -> dict:
    from __graft_entry__ import _make_model_and_batch
    from keras_rs_tpu import training
    from keras_rs_tpu.models.dlrm import bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib

    devices = jax.devices()[:n_devices]
    mesh = mesh_lib.create_mesh(devices)
    batch = per_device_batch * n_devices
    model, cfg, pre = _make_model_and_batch(
        mesh, batch, embedding_comm_dtype=comm_dtype
    )
    optimizer = optax.adagrad(0.01)
    state = training.create_train_state(model, optimizer)
    step = training.make_train_step(bce_loss, optimizer, donate=False)
    lowered = step.lower(state, pre)
    compiled = lowered.compile()
    comm = collective_bytes(compiled.as_text())
    # The pre-SPMD HLO carries the REQUESTED wire dtype of the
    # explicit shard_map collectives (the embedding exchange). It lacks
    # the dense-grad all-reduce (GSPMD inserts that at compile time),
    # and XLA's CPU backend float-normalizes bf16 collectives to f32 at
    # execution — so `comm` above reflects CPU execution, while
    # `requested` below is the wire format an accelerator backend with
    # native bf16 collectives ships.
    requested = collective_bytes(lowered.as_text("hlo"))
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", float("nan"))) if cost else None
    # SPMD HLO instruction shapes are PER-DEVICE shapes, so these sums
    # are already per-device buffer bytes. For ring all-reduce the
    # per-link traffic is ~2x the buffer size regardless of n; for
    # all-to-all / all-gather the buffer size IS the receive volume.
    total_comm = sum(comm.values())
    return {
        "n_devices": n_devices,
        "global_batch": batch,
        "per_device_batch": per_device_batch,
        "collective_bytes_per_device": total_comm,
        "per_kind_per_device": comm,
        "requested_per_kind_per_device": requested,
        "flops_per_device": flops,
        "comm_bytes_per_local_example": total_comm / per_device_batch,
    }


def main() -> None:
    rows32 = [measure(n) for n in (1, 2, 4, 8)]
    rows16 = [
        measure(n, comm_dtype="bfloat16") for n in (1, 2, 4, 8)
    ]
    print("-- executed collectives (compiled CPU HLO, comm f32) --")
    print(
        f"{'n':>2} {'batch':>6} {'a2a/dev':>12} {'ar(buf)':>12} "
        f"{'ag/dev':>12} {'rs/dev':>12} {'total/dev':>12} "
        f"{'B/loc.ex':>10}"
    )
    for r in rows32:
        n = r["n_devices"]
        k = r["per_kind_per_device"]
        print(
            f"{n:>2} {r['global_batch']:>6} "
            f"{k['all-to-all']:>12,} "
            f"{k['all-reduce']:>12,} "
            f"{k['all-gather']:>12,} "
            f"{k['reduce-scatter']:>12,} "
            f"{r['collective_bytes_per_device']:>12,} "
            f"{r['comm_bytes_per_local_example']:>10,.0f}"
        )
    print(
        "-- embedding-exchange wire bytes, requested (pre-SPMD HLO; "
        "accelerators ship these natively, CPU float-normalizes bf16 to "
        "f32) --"
    )
    print(
        f"{'n':>2} {'ag f32':>12} {'ag bf16':>12} {'rs f32':>12} "
        f"{'rs bf16':>12} {'a2a (both)':>12}"
    )
    for r32, r16 in zip(rows32, rows16):
        k32 = r32["requested_per_kind_per_device"]
        k16 = r16["requested_per_kind_per_device"]
        print(
            f"{r32['n_devices']:>2} "
            f"{k32['all-gather']:>12,} "
            f"{k16['all-gather']:>12,} "
            f"{k32['reduce-scatter']:>12,} "
            f"{k16['reduce-scatter']:>12,} "
            f"{k16['all-to-all']:>12,}"
        )
    print(
        json.dumps(
            {
                "weak_scaling_float32": rows32,
                "weak_scaling_comm_bfloat16": rows16,
            }
        )
    )


if __name__ == "__main__":
    main()
