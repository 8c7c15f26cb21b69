"""A/B the dense-stack precision variants on one device.

Isolates the DLRM dense stack exactly like bench.py's dense-only
measurement (embedding layer stripped, activations fed as batch data)
and times three variants, steps chained in one jitted scan:

  f32_resident  : bf16 matmul operands, f32 activations between fusions
                  (the current default — DLRMConfig.compute_dtype only)
  bf16_resident : + dense_output_dtype="bfloat16" — activations stay
                  bf16 between matmul fusions (params/accum stay f32)
  f32_full      : no mixed precision at all (reference numerics)

Run on two concat widths: the bench mix (4 tables, concat 640) and the
flagship Criteo mix (26 tables, concat 3456). Prints one JSON line per
(shape, variant) with ms/step and dense MFU against the device's
published bf16 peak (bench.DEVICE_PEAKS; an unlisted device is an
error).

`--small` runs a tiny CPU-mesh validation (shapes compile, losses of the
three variants agree to bf16 tolerance) without timing claims.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_dense_only(
    batch_size: int,
    num_tables: int,
    multi_hot,
    mesh,
    compute_dtype,
    dense_output_dtype,
    seed: int = 0,
):
    import jax
    import optax

    from keras_rs_tpu import training
    from keras_rs_tpu.data import synthetic
    from keras_rs_tpu.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib

    # All "large" tables get a tiny >=threshold vocab: the embedding
    # engine is stripped below, only the dense stack's concat width
    # (driven by len(vocab_sizes)) must match the real workload.
    vocab_sizes = [30_000] * (num_tables - 2) + [2000, 500]
    multi_hot = list(multi_hot)[: len(vocab_sizes)]
    cfg = DLRMConfig(
        vocab_sizes=vocab_sizes,
        multi_hot_sizes=multi_hot,
        num_dense_features=13,
        embedding_dim=128,
        bottom_mlp=(512, 256, 128),
        top_mlp=(1024, 512, 256, 1),
        num_dcn_layers=3,
        dcn_projection_dim=256,
        embedding_threshold=21_000,
        global_batch_size=batch_size,
        compute_dtype=compute_dtype,
        dense_output_dtype=dense_output_dtype,
    )
    model = DLRMDCNv2(cfg, key=jax.random.key(0), mesh=mesh)
    raw = synthetic.criteo_like_batch(
        batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        seed=seed,
    )
    batch = {
        k: mesh_lib.put_batch(mesh, np.asarray(v)) for k, v in raw.items()
    }
    rng = np.random.default_rng(seed)
    acts = {
        f"cat_{i}": mesh_lib.put_batch(
            mesh,
            rng.standard_normal(
                (batch_size, cfg.embedding_dim), dtype=np.float32
            ),
        )
        for i in model.large_idx
    }
    model_d = model.replace(embedding_layer=None)
    state = training.create_train_state(
        model_d, optax.adagrad(cfg.learning_rate)
    )
    batch["large_acts"] = acts
    step = training.make_train_step(
        lambda m, b: bce_loss(m, b), optax.adagrad(cfg.learning_rate)
    )
    return state, step, batch, cfg


VARIANTS = [
    ("f32_resident", "bfloat16", None),
    ("bf16_resident", "bfloat16", "bfloat16"),
    ("f32_full", None, None),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CPU validation")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=5)
    args = ap.parse_args()

    if args.small:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
        args.batch = 256
        args.iters, args.blocks = 2, 1

    import jax

    from bench import dense_flops_per_step, device_peaks
    from examples.ml_perf.configs import CRITEO_MULTI_HOT_SIZES
    from keras_rs_tpu.parallel import mesh as mesh_lib
    from keras_rs_tpu.utils.timing import measure_step_time

    device = jax.devices()[0]
    mesh = mesh_lib.create_mesh([device])
    peak = None if args.small else device_peaks(device)["bf16_flops_per_s"]

    shapes = [
        ("bench_mix", 4, [3, 2, 1, 1]),
        ("flagship_mix", 26, CRITEO_MULTI_HOT_SIZES),
    ]
    losses = {}
    for shape_name, num_tables, mh in shapes:
        for name, cd, od in VARIANTS:
            state, step, batch, cfg = build_dense_only(
                args.batch, num_tables, mh, mesh, cd, od
            )
            if args.small:
                # One step, record the loss for cross-variant parity.
                new_state, loss = step(state, batch)
                losses[(shape_name, name)] = float(loss)
                del state, new_state
                continue
            s_per_step, state = measure_step_time(
                step, state, batch, iters=args.iters, blocks=args.blocks
            )
            del state
            flops = dense_flops_per_step(cfg, args.batch)
            print(
                json.dumps(
                    {
                        "shape": shape_name,
                        "variant": name,
                        "device": device.device_kind,
                        "dense_ms": round(s_per_step * 1e3, 3),
                        "mfu_dense": round(flops / s_per_step / peak, 3),
                    }
                ),
                flush=True,
            )
    if args.small:
        for shape_name, _, _ in shapes:
            base = losses[(shape_name, "f32_full")]
            for name, _, _ in VARIANTS:
                rel = abs(losses[(shape_name, name)] - base) / max(
                    abs(base), 1e-9
                )
                status = "ok" if rel < 0.05 else "DIVERGED"
                print(
                    json.dumps(
                        {
                            "shape": shape_name,
                            "variant": name,
                            "loss": losses[(shape_name, name)],
                            "rel_vs_f32": round(rel, 5),
                            "status": status,
                        }
                    ),
                    flush=True,
                )


if __name__ == "__main__":
    main()
