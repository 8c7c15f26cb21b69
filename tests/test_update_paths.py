"""The embedding backward update (lookup.py) against a numpy oracle.

One lookup step through `stack_lookup` under `jax.grad` (the Overwrite
contract returns the updated state as the cotangent), compared per
logical row with a float32 numpy reimplementation of each fused
optimizer. The update is XLA's unique-index scatter over the deduped
rows: rows no id touched, and the per-shard sink rows that pad the
unique list, must come back bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from keras_rs_tpu.layers.embedding import optimizers as opt_lib
from keras_rs_tpu.layers.embedding.config import FeatureConfig, TableConfig
from keras_rs_tpu.layers.embedding.lookup import (
    init_stack_state,
    split_activations,
    stack_lookup,
)
from keras_rs_tpu.layers.embedding.preprocessing import preprocess_stack
from keras_rs_tpu.layers.embedding.stacking import (
    build_stacks,
    gather_table,
    init_stack_table,
)
from keras_rs_tpu.parallel import mesh as mesh_lib

LR = 0.05


def _optimizer(name):
    return {
        "sgd": opt_lib.SGD(LR),
        "adagrad": opt_lib.Adagrad(LR),
        "adam": opt_lib.Adam(LR),
        "ftrl": opt_lib.FTRL(LR, l1_regularization_strength=0.001,
                             l2_regularization_strength=0.01),
        "rowwise_adagrad": opt_lib.RowWiseAdagrad(LR),
    }[name]


def _np_apply(opt, rows, g, slots):
    """Float32 numpy reference of each fused optimizer at step 0."""
    f = np.float32
    if isinstance(opt, opt_lib.RowWiseAdagrad):
        acc = slots["accumulator"] + (g * g).sum(-1)
        return rows - f(LR) * g / (np.sqrt(acc)[:, None] + f(1e-7)), {
            "accumulator": acc}
    if isinstance(opt, opt_lib.SGD):
        return rows - f(LR) * g, {}
    if isinstance(opt, opt_lib.Adagrad):
        acc = slots["accumulator"] + g * g
        return rows - f(LR) * g / (np.sqrt(acc) + f(1e-7)), {
            "accumulator": acc}
    if isinstance(opt, opt_lib.Adam):
        m = f(0.9) * slots["momentum"] + f(0.1) * g
        v = f(0.999) * slots["velocity"] + f(0.001) * g * g
        m_hat = m / f(1 - 0.9)
        v_hat = v / f(1 - 0.999)
        return rows - f(LR) * m_hat / (np.sqrt(v_hat) + f(1e-7)), {
            "momentum": m, "velocity": v}
    if isinstance(opt, opt_lib.FTRL):
        acc, lin = slots["accumulator"], slots["linear"]
        new_acc = acc + g * g
        sigma = (np.sqrt(new_acc) - np.sqrt(acc)) / f(LR)
        new_lin = lin + g - sigma * rows
        quad = np.sqrt(new_acc) / f(LR) + f(2 * 0.01)
        pruned = np.where(
            np.abs(new_lin) > f(0.001),
            f(0.001) * np.sign(new_lin) - new_lin,
            f(0.0),
        )
        return pruned / quad, {"accumulator": new_acc, "linear": new_lin}
    raise AssertionError(opt)


def _build(opt_name, *, B, L, vocab, dim=128, shards=1, packed=True,
           dtype="float32", capacity=None):
    cap = capacity or B * L
    t = TableConfig(
        "t", vocab, dim, optimizer=_optimizer(opt_name), combiner="sum",
        placement="sharded", max_ids_per_partition=cap,
        max_unique_ids_per_partition=cap + 1, dtype=dtype,
    )
    fc = FeatureConfig("f", t, (B, L), (B, dim))
    (stack,) = build_stacks([fc], shards)
    if not packed:
        stack = dataclasses.replace(stack, packed_state=False)
    assert stack.packed_state == packed
    table0 = init_stack_table(
        stack, {"t": t}, jax.random.key(1),
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
    )
    return stack, init_stack_state(stack, table0)


def _step(stack, state, ids, cot):
    mesh = mesh_lib.create_mesh(jax.devices()[: stack.num_shards])
    coo, _ = preprocess_stack(stack, {"f": ids})
    coo = {k: jnp.asarray(v) for k, v in coo.arrays().items()}

    def loss(s):
        acts = stack_lookup(stack, mesh, "data", s, coo)
        return jnp.sum(split_activations(stack, acts)["f"] * cot)

    return jax.jit(jax.grad(loss))(state)


def _logical(stack, state):
    """(table [vocab, dim] f32, {slot: [vocab, dim]}) of table "t"."""
    arr = np.asarray(state["table"])
    if arr.ndim == 3:
        names = stack.optimizer.slot_names
        return gather_table(stack, arr[:, 0], "t"), {
            k: gather_table(stack, arr[:, 1 + i], "t")
            for i, k in enumerate(names)
        }
    table = gather_table(stack, arr, "t").astype(np.float32)
    return table, {
        k: gather_table(stack, np.asarray(v), "t")
        for k, v in state["slots"].items()
    }


def _oracle(stack, old_table, old_slots, ids, cot):
    """Touched logical rows and their expected (rows, slots)."""
    valid = (ids >= 0) & (ids < old_table.shape[0])
    flat = ids[valid]
    grads = np.repeat(cot[:, None, :], ids.shape[1], axis=1)[valid]
    touched = np.unique(flat)
    g = np.zeros((len(touched), cot.shape[1]), np.float32)
    np.add.at(g, np.searchsorted(touched, flat), grads)
    rows, slots = _np_apply(
        stack.optimizer,
        old_table[touched],
        g,
        {k: v[touched] for k, v in old_slots.items()},
    )
    return touched, rows, slots


def _sink_rows(stack, arr):
    """Per-shard sink rows of a state array (global row layout)."""
    return np.asarray(arr)[stack.rows_per_shard - 1 :: stack.rows_per_shard]


def _check_step(stack, state, ids, cot, rtol=1e-5, atol=1e-6):
    old_table, old_slots = _logical(stack, state)
    old_sinks = [_sink_rows(stack, state["table"])] + [
        _sink_rows(stack, v) for v in state.get("slots", {}).values()
    ]
    new_state = _step(stack, state, ids, cot)
    new_table, new_slots = _logical(stack, new_state)
    touched, want_rows, want_slots = _oracle(
        stack, old_table, old_slots, ids, cot
    )
    np.testing.assert_allclose(
        new_table[touched], want_rows, rtol=rtol, atol=atol
    )
    for k, want in want_slots.items():
        np.testing.assert_allclose(
            new_slots[k][touched], want, rtol=rtol, atol=atol
        )
    untouched = np.ones(old_table.shape[0], bool)
    untouched[touched] = False
    np.testing.assert_array_equal(
        new_table[untouched], old_table[untouched]
    )
    for k in old_slots:
        np.testing.assert_array_equal(
            new_slots[k][untouched], old_slots[k][untouched]
        )
    new_sinks = [_sink_rows(stack, new_state["table"])] + [
        _sink_rows(stack, v) for v in new_state.get("slots", {}).values()
    ]
    for a, b in zip(old_sinks, new_sinks):
        np.testing.assert_array_equal(a, b)
    assert float(new_state["step"]) == 1.0
    return touched


def _data(B, L, vocab, seed=0, dim=128, distinct=None):
    rng = np.random.default_rng(seed)
    pool = (
        rng.choice(vocab, size=distinct, replace=False)
        if distinct
        else np.arange(vocab)
    )
    # Every pool id occurs at least once; the rest repeat pool ids.
    draw = np.concatenate(
        [pool, pool[rng.integers(0, len(pool), size=B * L - len(pool))]]
    ) if distinct else pool[rng.integers(0, len(pool), size=B * L)]
    ids = rng.permutation(draw).reshape(B, L).astype(np.int64)
    cot = rng.standard_normal((B, dim)).astype(np.float32)
    return ids, cot


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize(
    "opt_name,packed",
    [
        ("sgd", False),  # no slots: never packed
        ("adagrad", True),
        ("adagrad", False),
        ("adam", True),
        ("adam", False),
        ("ftrl", True),
        ("ftrl", False),
    ],
)
def test_update_matches_numpy(opt_name, packed, shards):
    B, L, vocab = 16, 4, 640
    stack, state = _build(
        opt_name, B=B, L=L, vocab=vocab, shards=shards, packed=packed
    )
    ids, cot = _data(B, L, vocab)
    _check_step(stack, state, ids, cot)


@pytest.mark.parametrize("distinct", [0, 1, 7, 8, 100, 250])
def test_sink_tail_unchanged_for_any_unique_count(distinct):
    """Unique capacity 256 per shard; `distinct` rows are real, the rest
    of the unique list is sink padding whose writes must be no-ops.
    distinct=0 feeds only invalid ids: nothing may change."""
    B, L, vocab = 64, 4, 1000
    stack, state = _build(
        "adagrad", B=B, L=L, vocab=vocab, capacity=256
    )
    if distinct:
        ids, cot = _data(B, L, vocab, seed=distinct, distinct=distinct)
    else:
        ids = np.full((B, L), -1, np.int64)
        cot = np.ones((B, 128), np.float32)
    touched = _check_step(stack, state, ids, cot)
    assert len(touched) == distinct


@pytest.mark.parametrize("B,L", [(1, 1), (7, 3), (2048, 1), (2053, 2)])
def test_update_shapes(B, L):
    stack, state = _build("adagrad", B=B, L=L, vocab=5000)
    ids, cot = _data(B, L, 5000, seed=B)
    _check_step(stack, state, ids, cot)


@pytest.mark.parametrize(
    "opt_name,dim,bitpacked",
    [("rowwise_adagrad", 128, True), ("adagrad", 64, False)],
)
def test_bf16_update_within_one_ulp(opt_name, dim, bitpacked):
    """bf16 tables round the f32 update stochastically: each new row is
    the f32 oracle rounded down or up, so within one bf16 ulp."""
    B, L, vocab = 32, 3, 500
    stack, state = _build(
        opt_name, B=B, L=L, vocab=vocab, dim=dim, packed=False,
        dtype="bfloat16",
    )
    assert stack.bitpacked_state == bitpacked
    ids, cot = _data(B, L, vocab, dim=dim)
    old = gather_table(stack, np.asarray(state["table"]), "t")
    old_acc = np.asarray(state["slots"]["accumulator"])[:vocab]
    new_state = _step(stack, state, ids, cot)
    new = gather_table(stack, np.asarray(new_state["table"]), "t")
    new_acc = np.asarray(new_state["slots"]["accumulator"])[:vocab]
    touched, want, want_slots = _oracle(
        stack, old.astype(np.float32), {"accumulator": old_acc}, ids, cot
    )
    got = new[touched].astype(np.float32)
    ulp = np.float32(2.0) ** (
        np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7
    )
    assert (np.abs(got - want) <= ulp * 1.001 + 1e-30).all()
    np.testing.assert_allclose(
        new_acc[touched], want_slots["accumulator"], rtol=1e-5
    )
    untouched = np.ones(vocab, bool)
    untouched[touched] = False
    np.testing.assert_array_equal(
        new[untouched].view(np.uint16), old[untouched].view(np.uint16)
    )
    np.testing.assert_array_equal(new_acc[untouched], old_acc[untouched])


def test_packed_vs_split_layout_training_equivalence():
    """The packed (row-interleaved) state layout must train bit-for-bit
    like the split layout: same activations, same post-step tables."""
    B, dim = 16, 128
    mesh = mesh_lib.create_mesh()
    t = TableConfig(
        "t", 640, dim, optimizer="adagrad", combiner="mean",
        placement="sharded", max_ids_per_partition=32,
        max_unique_ids_per_partition=32,
    )
    fc = FeatureConfig("f", t, (B, 4), (B, dim))
    (stack,) = build_stacks([fc], 8)
    assert stack.packed_state and stack.state_stride == 2
    split_stack = dataclasses.replace(stack, packed_state=False)

    table0 = init_stack_table(
        stack, {"t": t}, jax.random.key(1), jnp.float32
    )
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 640, size=(B, 4))
    coo, _ = preprocess_stack(stack, {"f": ids})
    coo_arrays = {k: jnp.asarray(v) for k, v in coo.arrays().items()}

    def one_step(stk):
        state = init_stack_state(stk, table0)

        def loss(s):
            acts = stack_lookup(stk, mesh, "data", s, coo_arrays)
            f = split_activations(stk, acts)["f"]
            return jnp.sum(f * f)

        fwd = float(loss(state))
        new_state = jax.jit(jax.grad(loss))(state)
        return fwd, gather_table(stk, np.asarray(new_state["table"]), "t")

    fwd_p, table_p = one_step(stack)
    fwd_s, table_s = one_step(split_stack)
    np.testing.assert_allclose(fwd_p, fwd_s, rtol=1e-6)
    np.testing.assert_array_equal(table_p, table_s)
