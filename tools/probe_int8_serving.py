"""Probe: int8 serving lookups against f32, per lookup formulation.

The quantized path does 3 ops per feature (int8 row gather + per-row
scale gather + dequant multiply) vs 1 for f32. This probe times the
isolated lookup variants at serving shape, each chained in one jitted
scan (keras_rs_tpu.utils.timing.chained_call_ms):

  f32          take(f32[R,128])                          (baseline)
  int8_cur     take(int8[R,128]) * take(scale[R,1])      (current path)
  int8_noscale take(int8[R,128]).astype(f32)             (isolate scale)
  int8_scale1d take(int8) * take(scale[R])[:, None]      (1-D scale arr)
  packed       take(int32[R/4,128], ids//4) -> one-hot   (word-typed
               int32 select of the 32-word row -> bitcast  gather, 4
               -> int8 -> f32 * scale                      rows per group)
  packed_noscale  same without the scale gather

The packed layout keeps the full 128-wide minor dimension (4 consecutive
int8 rows = 128 int32 words), so memory stays at ~129 B/row while the
gather is 32-bit typed. Bit-exactness of each variant vs the current
dequant path is asserted before timing.

Run:  python tools/probe_int8_serving.py [--json out.json]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np


# The packed layout under test IS the production one: time the shipped
# functions so the probe cannot drift from what QuantizedEmbedReduce
# serves.
from keras_rs_tpu.utils.timing import chained_call_ms  # noqa: E402
from keras_rs_tpu.ops.quant import (  # noqa: E402
    pack_rows_int8_fused,
    pack_rows_int8_groups,
    take_rows_int8_fused,
    take_rows_int8_packed,
)


def take_packed(packed, scale1d, ids, dim):
    return take_rows_int8_packed(packed, scale1d, ids)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--n-ids", type=int, default=40_960)
    ap.add_argument("--json", default=None)
    # Correctness smoke on the CPU (its timings say nothing about the
    # accelerator).
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    R, dim, N = args.rows, args.dim, args.n_ids

    rng = np.random.default_rng(0)
    q_h = rng.integers(-127, 128, size=(R, dim), dtype=np.int8)
    scale_h = (rng.random(R, dtype=np.float32) + 0.5) / 127.0
    ids_h = rng.integers(0, R, size=N).astype(np.int32)

    q = jnp.asarray(q_h)
    scale2d = jnp.asarray(scale_h[:, None])
    scale1d = jnp.asarray(scale_h)
    packed = pack_rows_int8_groups(q)
    fused = pack_rows_int8_fused(q, jnp.asarray(scale_h))
    f32_table = jnp.asarray(
        q_h.astype(np.float32) * scale_h[:, None]
    )
    ids = jnp.asarray(ids_h)

    # --- bit-exactness of every variant vs the current path -------------
    want = np.asarray(
        jnp.take(q, ids, axis=0).astype(jnp.float32)
        * jnp.take(scale2d, ids, axis=0)
    )
    got_1d = np.asarray(
        jnp.take(q, ids, axis=0).astype(jnp.float32)
        * jnp.take(scale1d, ids)[:, None]
    )
    got_packed = np.asarray(take_packed(packed, scale1d, ids, dim))
    got_fused = np.asarray(take_rows_int8_fused(fused, ids))
    assert np.array_equal(want, got_1d), "scale1d mismatch"
    assert np.array_equal(want, got_packed), "packed mismatch"
    assert np.array_equal(want, got_fused), "fused mismatch"
    print(f"bit-exactness: PASS (N={N}, R={R}, dim={dim})")

    def perturb(a, tick):
        # last element is ids; tables pass through untouched.
        return tuple(a[:-1]) + (
            (a[-1] + tick.astype(jnp.int32)) % R,
        )

    derive = lambda out: (  # noqa: E731
        jnp.sum(out[0]) > 1e30
    ).astype(jnp.float32)

    # Tables are passed as jit ARGUMENTS: closure-captured device arrays
    # would become multi-GB jit constants.
    variants = {
        "f32": (
            lambda t, i: (jnp.take(t, i, axis=0),),
            (f32_table,),
        ),
        "int8_cur": (
            lambda t, s2, i: (
                jnp.take(t, i, axis=0).astype(jnp.float32)
                * jnp.take(s2, i, axis=0),
            ),
            (q, scale2d),
        ),
        "int8_noscale": (
            lambda t, i: (jnp.take(t, i, axis=0).astype(jnp.float32),),
            (q,),
        ),
        "int8_scale1d": (
            lambda t, s1, i: (
                jnp.take(t, i, axis=0).astype(jnp.float32)
                * jnp.take(s1, i)[:, None],
            ),
            (q, scale1d),
        ),
        "packed": (
            lambda pk, s1, i: (take_packed(pk, s1, i, dim),),
            (packed, scale1d),
        ),
        # Shift-based byte extract without the scale gather (matches the
        # shipped layout of quant.py pack_rows_int8_groups).
        "fused": (
            lambda fz, i: (take_rows_int8_fused(fz, i),),
            (fused,),
        ),
        "packed_noscale": (
            lambda pk, i: (
                (
                    (
                        jnp.take(pk, i // 4, axis=0)
                        << (24 - 8 * (i % 4)).astype(jnp.int32)[:, None]
                    )
                    >> 24
                ).astype(jnp.float32),
            ),
            (packed,),
        ),
    }
    d = jax.devices()[0]
    out = {
        "rows": R, "dim": dim, "n_ids": N,
        "device": {"platform": d.platform, "kind": d.device_kind},
    }
    for name, (fn, tables) in variants.items():
        ms = chained_call_ms(fn, tables + (ids,), perturb, derive)
        out[f"{name}_ms"] = round(ms, 4)
        print(f"{name:<16} {ms:8.4f} ms / lookup of {N} rows")
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
