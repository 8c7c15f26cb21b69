"""Unit tests for the uint32-packed bf16 table storage (ops/bitpack.py).

The flat bf16 array is the oracle: every packed operation must be
bit-identical to the same operation on the unpacked [R, dim] table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from keras_rs_tpu.ops import bitpack


def _table(R, dim, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.standard_normal((R, dim)).astype(jnp.bfloat16)
    )


def _u16(x):
    return np.asarray(x).view(np.uint16)


def test_pack_unpack_roundtrip():
    t = _table(64, 16)
    words = bitpack.pack_rows(t)
    assert words.shape == (32, 16) and words.dtype == jnp.float32
    np.testing.assert_array_equal(
        _u16(bitpack.unpack_rows(words)), _u16(t)
    )


def test_pack_rejects_bad_inputs():
    with pytest.raises(ValueError, match="even"):
        bitpack.pack_rows(_table(7, 8)[:7])
    with pytest.raises(ValueError, match="bfloat16"):
        bitpack.pack_rows(jnp.zeros((4, 8), jnp.float32))


def test_take_rows_matches_flat_gather():
    t = _table(256, 32, seed=1)
    words = bitpack.pack_rows(t)
    rng = np.random.default_rng(2)
    ids = jnp.asarray(rng.integers(0, 256, size=100).astype(np.int32))
    rows, pair_words = bitpack.take_rows(words, ids)
    np.testing.assert_array_equal(
        _u16(rows), _u16(jnp.take(t, ids, axis=0))
    )
    np.testing.assert_array_equal(
        np.asarray(pair_words),
        np.asarray(jnp.take(words, ids >> 1, axis=0)).view(np.uint32),
    )


@pytest.mark.parametrize("N", [1, 2, 9, 64])
def test_merge_updated_rows_oracle(N):
    """Writing the merged words == the flat row scatter, including pairs
    where both rows update (adjacent sorted ids)."""
    R, dim = 128, 16
    t = _table(R, dim, seed=N)
    words = bitpack.pack_rows(t)
    rng = np.random.default_rng(N + 10)
    ids = jnp.asarray(
        np.sort(rng.choice(R, size=N, replace=False)).astype(np.int32)
    )
    new_rows = jnp.asarray(
        rng.standard_normal((N, dim)).astype(jnp.bfloat16)
    )
    pair, merged = bitpack.merge_updated_rows(
        jax.lax.bitcast_convert_type(
            jnp.take(words, ids >> 1, axis=0), jnp.uint32
        ),
        ids,
        new_rows,
    )
    got = bitpack.unpack_rows(words.at[pair].set(merged))
    want = t.at[ids].set(new_rows)
    np.testing.assert_array_equal(_u16(got), _u16(want))
    # Duplicate pair writes must be identical words (benign race).
    p = np.asarray(pair)
    m = np.asarray(merged).view(np.uint32)
    for v in np.unique(p):
        grp = m[p == v]
        assert (grp == grp[0]).all()


def test_merge_sink_duplicates_are_benign():
    """Dedup pads with repeats of the sink id; the sink's pair holds no
    other updated row (stacking gives it a dead partner). All sink
    entries must emit the same word and preserve the partner half."""
    R, dim = 32, 8
    t = _table(R, dim, seed=5)
    words = bitpack.pack_rows(t)
    sink = R - 1  # odd => high half; partner (dead) row R-2 untouched
    rng = np.random.default_rng(6)
    real = np.sort(rng.choice(R - 2, size=5, replace=False))
    ids = jnp.asarray(
        np.concatenate([real, [sink] * 4]).astype(np.int32)
    )
    new_rows = jnp.asarray(
        rng.standard_normal((ids.shape[0], dim)).astype(jnp.bfloat16)
    )
    # Sink entries carry the sink's CURRENT value (the masked-gradient
    # no-op update round-trips exactly).
    new_rows = new_rows.at[5:].set(t[sink])
    pair, merged = bitpack.merge_updated_rows(
        jax.lax.bitcast_convert_type(
            jnp.take(words, ids >> 1, axis=0), jnp.uint32
        ),
        ids,
        new_rows,
    )
    got = bitpack.unpack_rows(words.at[pair].set(merged))
    want = t.at[ids].set(new_rows)
    np.testing.assert_array_equal(_u16(got), _u16(want))
    # The dead partner row kept its bits.
    np.testing.assert_array_equal(
        _u16(got[R - 2]), _u16(t[R - 2])
    )
    m = np.asarray(merged).view(np.uint32)
    assert (m[5:] == m[5]).all()


@pytest.mark.parametrize("with_sink", [False, True])
def test_packed_scatter_through_xla(with_sink):
    """End-to-end: merge + XLA's unique-index word scatter (the update
    path lookup.py takes) equals the flat bf16 scatter, including the
    sink-duplicate tail the dedup contract pads with."""
    R, dim = 4096, 128
    t = _table(R, dim, seed=9)
    words = bitpack.pack_rows(t)
    rng = np.random.default_rng(10)
    real = np.sort(rng.choice(R - 2, size=300, replace=False))
    sink = R - 1
    ids_np = np.concatenate([real, [sink] * 5]) if with_sink else real
    ids = jnp.asarray(ids_np.astype(np.int32))
    new_rows = jnp.asarray(
        rng.standard_normal((len(ids_np), dim)).astype(jnp.bfloat16)
    )
    if with_sink:
        # Zero-gradient sink entries write the sink's current value.
        new_rows = new_rows.at[len(real):].set(t[sink])
    pair, merged = bitpack.merge_updated_rows(
        jax.lax.bitcast_convert_type(
            jnp.take(words, ids >> 1, axis=0), jnp.uint32
        ),
        ids,
        new_rows,
    )
    got_words = jax.jit(
        lambda w, p, m: w.at[p].set(m, unique_indices=True)
    )(words, pair, merged)
    want = t.at[ids].set(new_rows)
    np.testing.assert_array_equal(
        _u16(bitpack.unpack_rows(got_words)), _u16(want)
    )
