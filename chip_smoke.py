"""Proof that the DLRM-DCNv2 train path runs on an NVIDIA GPU.

    python chip_smoke.py          # phases 1-5 on exactly one card
    python chip_smoke.py --four   # sharded tables on four cards vs one

Phases (one process, one card):
  1. COO parity: device preprocessing on the card against the numpy host
     backend; integer arrays bit-exact, f32 gains within 8 ULP.
  2. Embedding layer against a float32 numpy gather / weighted-sum /
     Adagrad reference (9 large Criteo tables capped at 1M rows, dim 128,
     batch 4096): forward activations and the table+slot rows after one
     update; untouched rows bit-identical.
  3. Dense stack precision: full-width DLRM logits in float32 at
     "highest" matmul precision on the card against the same model on
     the host CPU; the default (bf16-resident) numerics against them.
  4. The MLPerf trainer (`examples/ml_perf/main.py`) at the `full_criteo`
     widths, global batch 16,384, tables capped at 4M rows: 20 steps with
     in-step device preprocessing, then 2 with host preprocessing.
  5. SASRec at T=512: 3 train steps on the plain attention path.

`--four` runs only the sharded path: the same model on a 4-card and a
1-card mesh, 3 steps, losses and tables compared.

Each phase prints PASS/FAIL with every measured error beside its
tolerance, its seconds and the device's `peak_bytes_in_use` so far. The
last line is one JSON object, printed only when every phase passed.
Without a GPU the script exits nonzero before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

#: Tolerances, each with its reason.
GAIN_ULP_TOL = 8  # device segment sums add in another order
EMB_REL_TOL = 1e-5  # no matmul: only f32 summation order differs
DENSE_REL_TOL = 1e-4  # f32 "highest" on both sides; sum order differs
DEFAULT_LOSS_TOL = 1e-2  # bf16-resident activations / TF32 matmuls
FOUR_REL_TOL = 1e-5  # f32 "highest"; collectives reorder the sums

LR = 0.0034  # MLPerf DLRM-DCNv2 Adagrad learning rate


@dataclasses.dataclass
class Check:
    name: str
    value: float
    tol: float
    strict: bool = False  # value < tol instead of value <= tol

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        if self.strict:
            return self.value < self.tol
        return self.value <= self.tol

    def __str__(self) -> str:
        op = "<" if self.strict else "<="
        return f"{self.name}={self.value:.3g} (tol {op} {self.tol:g})"


def rel_err(got, ref) -> float:
    """Normwise relative error: max |got - ref| / max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if ref.size else 0.0
    return float(np.abs(got - ref).max() / scale) if scale else 0.0


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise ULP distance of two same-shape f32 arrays (0: equal).

    Monotone int32 reinterpretation (sign-folded two's complement), so
    the distance counts the representable f32 values between a and b.
    """
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi, bi)
    return np.abs(ai - bi)


def peak_bytes(devices) -> str:
    out = []
    for d in devices:
        stats = d.memory_stats() or {}
        out.append(str(stats.get("peak_bytes_in_use", "n/a")))
    return ",".join(out)


def run_phase(name: str, fn, devices) -> dict:
    """Runs one phase, prints its line, raises SystemExit on a failure."""
    t0 = time.perf_counter()
    try:
        checks, info = fn()
    except Exception:
        print(f"[{name}] FAIL (raised after "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        raise
    ok = all(c.ok for c in checks)
    parts = [str(c) for c in checks]
    parts += [f"{k}={v}" for k, v in info.items()]
    print(
        f"[{name}] {'PASS' if ok else 'FAIL'}  " + "  ".join(parts)
        + f"  seconds={time.perf_counter() - t0:.1f}"
        f"  peak_bytes_in_use={peak_bytes(devices)}",
        flush=True,
    )
    if not ok:
        raise SystemExit(1)
    gc.collect()
    return info


# --------------------------------------------------------------------------
# Phase 1: COO parity.
# --------------------------------------------------------------------------
PARITY_TRIALS = (
    # (batch, valence, vocab, combiner, weighted)
    (256, 8, 50_000, "sum", False),
    (256, 8, 50_000, "mean", True),
    (128, 16, 30_000, "sqrtn", True),
    (512, 4, 100_000, "sum", True),
)


def phase_coo_parity(trials=PARITY_TRIALS):
    import jax
    import jax.numpy as jnp

    from keras_rs_tpu.layers.embedding import preprocessing
    from keras_rs_tpu.layers.embedding.config import (
        FeatureConfig,
        TableConfig,
    )
    from keras_rs_tpu.layers.embedding.device_preprocessing import (
        preprocess_stack_device,
    )
    from keras_rs_tpu.layers.embedding.stacking import build_stacks

    rng = np.random.default_rng(7)
    max_ulp = 0
    int_mismatch = 0
    zero_mismatch = 0
    for B, L, vocab, combiner, weighted in trials:
        tables = [
            TableConfig(
                name=f"t{i}",
                vocabulary_size=vocab // (i + 1),
                embedding_dim=64,
                combiner=combiner,
                max_ids_per_partition=B * L * 3,
                max_unique_ids_per_partition=B * L * 3,
            )
            for i in range(2)
        ]
        feats = [
            FeatureConfig(
                name=f"f{i}",
                table=tables[i % 2],
                input_shape=(B, L),
                output_shape=(B, 64),
            )
            for i in range(3)
        ]
        (stack,) = build_stacks(feats, num_shards=1)
        # Negative ids are invalid entries (padding) by contract.
        inputs = {
            f"f{i}": rng.integers(-2, vocab, size=(B, L), dtype=np.int64)
            for i in range(3)
        }
        weights = (
            {
                f"f{i}": rng.random((B, L)).astype(np.float32)
                * (rng.random((B, L)) > 0.1)
                for i in range(3)
            }
            if weighted
            else None
        )
        host, _ = preprocessing.preprocess_stack(
            stack, inputs, weights, backend="numpy"
        )
        dev = jax.jit(
            lambda ins, ws, s=stack: preprocess_stack_device(s, ins, ws)[0]
        )(
            {k: jnp.asarray(v) for k, v in inputs.items()},
            None
            if weights is None
            else {k: jnp.asarray(v) for k, v in weights.items()},
        )
        for k, h in host.arrays().items():
            d = np.asarray(dev[k])
            if h.dtype == np.float32:
                zero_mismatch += int(((d == 0) != (h == 0)).sum())
                max_ulp = max(max_ulp, int(ulp_distance(d, h).max()))
            else:
                int_mismatch += int((d != h).sum())
    return [
        Check("int_elements_mismatched", int_mismatch, 0),
        Check("f32_zero_pattern_mismatched", zero_mismatch, 0),
        Check("f32_max_ulp", max_ulp, GAIN_ULP_TOL),
    ], {"trials": len(trials)}


# --------------------------------------------------------------------------
# Phase 2: embedding layer against a numpy reference.
# --------------------------------------------------------------------------
def large_criteo_features(vocab_cap: int):
    """(index, capped vocab, valence) of the Criteo tables that the DLRM
    model shards (vocabulary >= 21,000)."""
    from examples.ml_perf.configs import (
        CRITEO_MULTI_HOT_SIZES,
        CRITEO_VOCAB_SIZES,
    )

    return [
        (i, min(v, vocab_cap), m)
        for i, (v, m) in enumerate(
            zip(CRITEO_VOCAB_SIZES, CRITEO_MULTI_HOT_SIZES)
        )
        if v >= 21_000
    ]


def _segment_rows(ids: np.ndarray, rows: np.ndarray):
    """Sums `rows` [N, dim] per id: (unique ids, [U, dim] sums)."""
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    uniq, start = np.unique(sid, return_index=True)
    return uniq, np.add.reduceat(rows[order], start, axis=0)


def phase_embedding(
    devices, vocab_cap=1_000_000, batch=4096, dim=128, seed=0
):
    import jax
    import jax.numpy as jnp
    import optax

    from keras_rs_tpu import training
    from keras_rs_tpu.core.module import Module
    from keras_rs_tpu.layers.embedding import optimizers as opt_lib
    from keras_rs_tpu.layers.embedding.config import (
        FeatureConfig,
        TableConfig,
    )
    from keras_rs_tpu.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )
    from keras_rs_tpu.layers.embedding.stacking import gather_table
    from keras_rs_tpu.parallel import mesh as mesh_lib

    feats = large_criteo_features(vocab_cap)
    total_ids = sum(m for _, _, m in feats)
    fcs = {}
    for i, v, m in feats:
        table = TableConfig(
            name=f"table_{i}",
            vocabulary_size=v,
            embedding_dim=dim,
            optimizer=opt_lib.Adagrad(learning_rate=LR),
            combiner="sum",
            placement="sharded",
            max_ids_per_partition=batch * total_ids,
            max_unique_ids_per_partition=batch * total_ids,
        )
        fcs[f"cat_{i}"] = FeatureConfig(
            name=f"cat_{i}", table=table, input_shape=(batch, m),
            output_shape=(batch, dim),
        )
    mesh = mesh_lib.create_mesh(devices[:1])
    layer = DistributedEmbedding(fcs, key=jax.random.key(seed), mesh=mesh)
    (stack,) = layer.stacks
    rng = np.random.default_rng(seed)
    ids = {
        f"cat_{i}": rng.integers(0, v, size=(batch, m)).astype(np.int32)
        for i, v, m in feats
    }
    # Fixed cotangents: loss = sum_f <acts_f, cot_f>, so each entry's
    # gradient is its sample's cotangent row.
    cots = {
        f"cat_{i}": rng.standard_normal((batch, dim)).astype(np.float32)
        for i, _, _ in feats
    }

    class Probe(Module):
        def __init__(self, emb):
            self.emb = emb

    def lookup(m, x):
        return m.emb(m.emb.preprocess_on_device(x))

    def loss_fn(m, x, c):
        acts = lookup(m, x)
        return sum(jnp.sum(acts[k] * c[k]) for k in acts)

    x = mesh_lib.put_batch(mesh, ids)
    c = mesh_lib.put_batch(mesh, cots)
    acts = jax.jit(lookup)(Probe(layer), x)
    acts = {k: np.asarray(v) for k, v in acts.items()}
    state0 = np.asarray(layer.state.value[stack.name]["table"])
    tables0 = {
        f"table_{i}": gather_table(stack, state0[:, 0], f"table_{i}")
        for i, _, _ in feats
    }
    del state0

    optimizer = optax.sgd(0.0)  # the probe has no optax-updated params
    state = training.create_train_state(Probe(layer), optimizer)
    step = training.make_train_step(loss_fn, optimizer)
    state, _ = step(state, x, c)
    new_state = np.asarray(
        state.model.emb.state.value[stack.name]["table"]
    )
    del state, layer
    gc.collect()

    acc0 = np.float32(0.1)  # Adagrad's initial accumulator
    act_err = tab_err = acc_err = 0.0
    untouched_diff = 0
    touched = 0
    for i, _, m in feats:
        name, tname = f"cat_{i}", f"table_{i}"
        t0 = tables0[tname]
        ref_acts = t0[ids[name]].sum(axis=1)
        act_err = max(act_err, rel_err(acts[name], ref_acts))

        flat = ids[name].reshape(-1)
        uniq, g = _segment_rows(flat, np.repeat(cots[name], m, axis=0))
        acc = acc0 + g * g
        new_rows = t0[uniq] - np.float32(LR) * (
            g / (np.sqrt(acc) + np.float32(1e-7))
        )
        t1 = gather_table(stack, new_state[:, 0], tname)
        a1 = gather_table(stack, new_state[:, 1], tname)
        tab_err = max(tab_err, rel_err(t1[uniq], new_rows))
        acc_err = max(acc_err, rel_err(a1[uniq], acc))
        mask = np.ones(len(t0), bool)
        mask[uniq] = False
        untouched_diff += int((t1[mask] != t0[mask]).sum())
        untouched_diff += int((a1[mask] != acc0).sum())
        touched += len(uniq)
    return [
        Check("acts_rel_err", act_err, EMB_REL_TOL),
        Check("table_rows_rel_err", tab_err, EMB_REL_TOL),
        Check("slot_rows_rel_err", acc_err, EMB_REL_TOL),
        Check("untouched_elements_changed", untouched_diff, 0),
    ], {
        "rows": stack.global_rows,
        "entries": batch * total_ids,
        "touched_rows": touched,
    }


# --------------------------------------------------------------------------
# Phase 3: dense stack precision.
# --------------------------------------------------------------------------
def _dense_model_and_batch(batch: int, seed: int, **dtypes):
    """Full-width DLRM whose tables all stay below the sharding threshold
    (vocabularies capped at 20,000), so the same module runs unchanged on
    the card and on the host CPU; only the dense stack differs."""
    import jax

    from examples.ml_perf.configs import (
        CRITEO_MULTI_HOT_SIZES,
        CRITEO_VOCAB_SIZES,
    )
    from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2

    vocab = [min(v, 20_000) for v in CRITEO_VOCAB_SIZES]
    cfg = DLRMConfig(
        vocab_sizes=vocab,
        multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
        global_batch_size=batch,
        learning_rate=LR,
        **dtypes,
    )
    model = DLRMDCNv2(cfg, key=jax.random.key(seed))
    assert model.embedding_layer is None
    rng = np.random.default_rng(seed)
    b = {
        "dense": rng.standard_normal((batch, 13)).astype(np.float32),
        "label": (rng.random(batch) < 0.3).astype(np.float32),
    }
    for i, (v, m) in enumerate(zip(vocab, CRITEO_MULTI_HOT_SIZES)):
        b[f"cat_{i}"] = rng.integers(0, v, size=(batch, m)).astype(
            np.int32
        )
    return model, b


def phase_dense(devices, batch=1024, seed=0):
    import jax

    from keras_rs_tpu.models.dlrm import bce_loss

    def logits_and_loss(model, b):
        return model(b), bce_loss(model, b)

    fwd = jax.jit(logits_and_loss)
    f32 = dict(compute_dtype=None, dense_output_dtype="float32")
    model, b = _dense_model_and_batch(batch, seed, **f32)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        on_card = fwd(jax.device_put(model, devices[0]),
                      jax.device_put(b, devices[0]))
        on_cpu = fwd(jax.device_put(model, cpu), jax.device_put(b, cpu))
    ref_logits, ref_loss = np.asarray(on_cpu[0]), float(on_cpu[1])
    card_logits = np.asarray(on_card[0])

    # Default numerics: bf16 operands and bf16-resident activations.
    model_d, _ = _dense_model_and_batch(batch, seed)
    dflt = fwd(jax.device_put(model_d, devices[0]),
               jax.device_put(b, devices[0]))
    return [
        Check("f32_highest_vs_cpu_rel_err",
              rel_err(card_logits, ref_logits), DENSE_REL_TOL),
        Check("default_loss_abs_diff",
              abs(float(dflt[1]) - float(on_card[1])), DEFAULT_LOSS_TOL),
    ], {
        "default_logits_rel_err": f"{rel_err(dflt[0], card_logits):.3g}",
        "loss_f32": f"{ref_loss:.6f}",
        "loss_default": f"{float(dflt[1]):.6f}",
    }


# --------------------------------------------------------------------------
# Phase 4: the MLPerf trainer's main path.
# --------------------------------------------------------------------------
def phase_train(devices, vocab_cap=4_000_000, batch=16_384, steps=20,
                host_steps=2):
    from examples.ml_perf.configs import CRITEO_VOCAB_SIZES
    from examples.ml_perf.main import main as mlperf_main

    capped = [min(v, vocab_cap) for v in CRITEO_VOCAB_SIZES]
    large_rows = sum(v for v in capped if v >= 21_000)
    common = dict(
        vocab_sizes=capped, global_batch_size=batch, num_devices=1
    )
    dev = mlperf_main(
        "full_criteo", num_steps=steps, device_preprocessing=True, **common
    )
    gc.collect()
    host = mlperf_main("full_criteo", num_steps=host_steps, **common)
    losses = np.asarray(dev["losses"])
    host_losses = np.asarray(host["losses"])
    nonfinite = int((~np.isfinite(losses)).sum())
    nonfinite += int((~np.isfinite(host_losses)).sum())
    step_ms = 1e3 * batch / dev["throughput"]
    return [
        Check("nonfinite_losses", nonfinite, 0),
        Check("last3_mean_minus_step1",
              float(losses[-3:].mean() - losses[0]), 0.0, strict=True),
        Check("dropped_ids", dev["dropped_ids"], 0),
        Check("large_rows_outside_sharded_stack",
              max(0, large_rows - min(dev["stacked_rows"],
                                      host["stacked_rows"])), 0),
    ], {
        "stacked_rows": dev["stacked_rows"],
        "entries_per_step": batch * sum(
            m for _, _, m in large_criteo_features(vocab_cap)
        ),
        "loss_step1": f"{losses[0]:.6f}",
        "loss_last3_mean": f"{losses[-3:].mean():.6f}",
        "host_coo_backend": host["coo_backend"],
        "host_losses": "/".join(f"{v:.6f}" for v in host_losses),
        "post_warmup_step_ms(not a benchmark)": f"{step_ms:.1f}",
    }


# --------------------------------------------------------------------------
# Phase 5: SASRec at T=512 on the plain attention path.
# --------------------------------------------------------------------------
def phase_sasrec(devices, batch=128, seq_len=512, items=3706, steps=3):
    import jax
    import optax

    from keras_rs_tpu import training
    from keras_rs_tpu.models.sasrec import SASRec, sasrec_loss

    model = SASRec(
        vocabulary_size=items, num_layers=2, num_heads=2, hidden_dim=64,
        max_sequence_length=seq_len, key=jax.random.key(0),
    )
    rng = np.random.default_rng(0)
    seq = rng.integers(1, items + 1, size=(batch, seq_len + 1))
    b = {
        "item_history": seq[:, :-1],
        "positive_sequence": seq[:, 1:],
        "negative_sequence": rng.integers(
            1, items + 1, size=(batch, seq_len)
        ),
    }
    b = jax.device_put({k: v.astype(np.int32) for k, v in b.items()},
                       devices[0])
    optimizer = optax.adam(1e-3)
    state = jax.device_put(
        training.create_train_state(model, optimizer), devices[0]
    )
    step = training.make_train_step(sasrec_loss, optimizer)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, b)
        jax.block_until_ready((state, loss))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return [
        Check("nonfinite_losses", int((~np.isfinite(losses)).sum()), 0),
    ], {
        "losses": "/".join(f"{v:.5f}" for v in losses),
        "step_ms_after_compile": f"{1e3 * np.mean(times[1:]):.2f}",
        "shape": f"B={batch},T={seq_len},dim=64,heads=2,layers=2",
    }


# --------------------------------------------------------------------------
# --four: row-sharded tables on four cards against one card.
# --------------------------------------------------------------------------
def _sharded_model(mesh, vocab_cap, batch, tables=None):
    import jax

    from examples.ml_perf.configs import (
        CRITEO_MULTI_HOT_SIZES,
        CRITEO_VOCAB_SIZES,
    )
    from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2

    D = mesh.devices.size
    large = sum(
        m for v, m in zip(CRITEO_VOCAB_SIZES, CRITEO_MULTI_HOT_SIZES)
        if v >= 21_000
    )
    max_ids = (batch // D) * large
    cfg = DLRMConfig(
        vocab_sizes=[min(v, vocab_cap) for v in CRITEO_VOCAB_SIZES],
        multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
        global_batch_size=batch,
        learning_rate=LR,
        table_placement="sharded",
        max_ids_per_partition=max_ids,
        max_unique_ids_per_partition=max_ids,
        compute_dtype=None,
        dense_output_dtype="float32",
    )
    model = DLRMDCNv2(cfg, key=jax.random.key(0), mesh=mesh)
    if tables is not None:
        # Identical logical tables on both meshes (the padded-vocab
        # initial draws differ with the shard count).
        model.embedding_layer.set_embedding_tables(tables)
    return model


def _train_sharded(model, mesh, batches):
    import jax
    import optax

    from keras_rs_tpu import training
    from keras_rs_tpu.models.dlrm import bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib

    def loss_fn(m, b):
        return bce_loss(m, m.preprocess_on_device(b))

    optimizer = optax.adagrad(LR)
    state = training.create_train_state(model, optimizer)
    step = training.make_train_step(loss_fn, optimizer)
    losses = []
    with jax.default_matmul_precision("highest"):
        for raw in batches:
            state, loss = step(state, mesh_lib.put_batch(mesh, raw))
            losses.append(float(loss))
    return losses, state.model.embedding_layer.get_embedding_tables()


def phase_four(devices, vocab_cap=1_000_000, batch=16_384, steps=3):
    from examples.ml_perf.configs import (
        CRITEO_MULTI_HOT_SIZES,
        CRITEO_VOCAB_SIZES,
    )
    from keras_rs_tpu.data.criteo import CriteoDataset
    from keras_rs_tpu.parallel import mesh as mesh_lib

    mesh4 = mesh_lib.create_mesh(devices[:4])
    mesh1 = mesh_lib.create_mesh(devices[:1])
    data = CriteoDataset(
        None,
        global_batch_size=batch,
        vocab_sizes=[min(v, vocab_cap) for v in CRITEO_VOCAB_SIZES],
        multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
    )
    batches = list(data.dummy_batches(steps, seed=3))

    model4 = _sharded_model(mesh4, vocab_cap, batch)
    emb = model4.embedding_layer
    (stack,) = emb.stacks
    table = emb.state.value[stack.name]["table"]
    table_cards = len(table.sharding.device_set)
    shard_rows = {s.data.shape[0] for s in table.addressable_shards}
    quarter = table.nbytes // 4
    in_use = [
        (d.memory_stats() or {}).get("bytes_in_use") for d in devices[:4]
    ]
    tables = emb.get_embedding_tables()
    del emb, table
    losses4, tables4 = _train_sharded(model4, mesh4, batches)
    del model4
    gc.collect()

    model1 = _sharded_model(mesh1, vocab_cap, batch, tables)
    losses1, tables1 = _train_sharded(model1, mesh1, batches)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses4, losses1))
    table_err = max(rel_err(tables4[k], tables1[k]) for k in tables1)
    return [
        Check("cards_missing_from_table_sharding", 4 - table_cards, 0),
        Check("distinct_shard_row_counts", len(shard_rows), 1),
        Check("cards_without_memory_stats",
              sum(b is None for b in in_use), 0),
        Check("cards_below_quarter_of_table_bytes",
              sum(b is not None and b < quarter for b in in_use), 0),
        Check("loss_rel_err_4v1", loss_err, FOUR_REL_TOL),
        Check("table_rel_err_4v1", table_err, FOUR_REL_TOL),
    ], {
        "losses4": "/".join(f"{v:.6f}" for v in losses4),
        "losses1": "/".join(f"{v:.6f}" for v in losses1),
        "table_bytes_per_card": quarter,
        "bytes_in_use_per_card": ",".join(map(str, in_use)),
    }


# --------------------------------------------------------------------------
def card_name_and_power() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the 4-card sharded path and its 1-card comparison",
    )
    args = parser.parse_args(argv)

    import jax

    all_devices = jax.devices()
    if all_devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{all_devices[0].platform!r})", file=sys.stderr)
        return 1
    count = 4 if args.four else 1
    if len(all_devices) < count:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(all_devices)}",
              file=sys.stderr)
        return 1
    devices = all_devices[:count]

    sys.path.insert(0, REPO_ROOT)
    from keras_rs_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    for line in card_name_and_power():
        print(f"nvidia-smi: {line}")
    print(f"devices used: {count} x {devices[0].device_kind}; "
          f"compile cache: {cache_dir}", flush=True)

    if args.four:
        run_phase("four-card sharding", lambda: phase_four(devices),
                  devices)
    else:
        run_phase("1 COO parity", phase_coo_parity, devices)
        run_phase("2 embedding vs numpy",
                  lambda: phase_embedding(devices), devices)
        run_phase("3 dense precision", lambda: phase_dense(devices),
                  devices)
        run_phase("4 mlperf train path", lambda: phase_train(devices),
                  devices)
        run_phase("5 sasrec T=512", lambda: phase_sasrec(devices),
                  devices)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": count,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
