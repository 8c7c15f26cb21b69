"""MultiHeadSelfAttention against a float32 numpy attention oracle.

Covers the masking matrix (causal x key padding), sequence lengths that
are not multiples of 128, bf16 inputs, and gradients against an
independent jnp implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from keras_rs_tpu.layers.attention import MultiHeadSelfAttention


def _np_attention(x, mha, causal, mask):
    """float64 numpy reference of the layer's math."""
    x = np.asarray(x, np.float64)
    w = {k: np.asarray(getattr(mha, k), np.float64)
         for k in ("wq", "wk", "wv", "wo")}
    B, T, D = x.shape
    H = mha.num_heads
    hd = D // H
    q, k, v = (
        (x @ w[n]).reshape(B, T, H, hd) for n in ("wq", "wk", "wv")
    )
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    keep = np.ones((B, 1, T, T), bool)
    if causal:
        keep &= np.tril(np.ones((T, T), bool))[None, None]
    if mask is not None:
        keep &= np.asarray(mask, bool)[:, None, None, :]
    logits = np.where(keep, logits, -1e9)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, D)
    return out @ w["wo"]


def _jnp_attention(x, wq, wk, wv, wo, H, causal, mask):
    """Independent jnp implementation, for gradients."""
    B, T, D = x.shape
    hd = D // H
    q = jnp.einsum("btd,de->bte", x, wq).reshape(B, T, H, hd)
    k = jnp.einsum("btd,de->bte", x, wk).reshape(B, T, H, hd)
    v = jnp.einsum("btd,de->bte", x, wv).reshape(B, T, H, hd)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
    keep = jnp.ones((B, 1, T, T), bool)
    if causal:
        keep = keep & jnp.tril(jnp.ones((T, T), bool))[None, None]
    if mask is not None:
        keep = keep & mask.astype(bool)[:, None, None, :]
    s = jnp.where(keep, s, -1e9)
    e = jnp.exp(s - jax.lax.stop_gradient(s.max(-1, keepdims=True)))
    p = e / e.sum(-1, keepdims=True)
    out = jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, D)
    return out @ wo


def _inputs(B, T, D, H, seed=0, dtype=jnp.float32):
    kx, km, kl = jax.random.split(jax.random.key(seed), 3)
    mha = MultiHeadSelfAttention(D, H, key=kl, dtype=dtype)
    x = jax.random.normal(kx, (B, T, D), dtype)
    mask = (jax.random.uniform(km, (B, T)) > 0.25).astype(jnp.float32)
    mask = mask.at[:, 0].set(1.0)  # every query keeps >= 1 valid key
    return mha, x, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [True, False])
def test_forward_matches_numpy(causal, use_mask):
    mha, x, mask = _inputs(2, 48, 32, 4)
    m = mask if use_mask else None
    out = mha(x, padding_mask=m, causal=causal)
    ref = _np_attention(x, mha, causal, m)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [17, 200])
def test_lengths_not_multiple_of_128(T):
    mha, x, mask = _inputs(2, T, 16, 2, seed=T)
    out = mha(x, padding_mask=mask)
    assert out.shape == (2, T, 16)
    np.testing.assert_allclose(
        out, _np_attention(x, mha, True, mask), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_reference(causal):
    mha, x, mask = _inputs(2, 24, 16, 2, seed=1)

    def loss_layer(x, wq, wk, wv, wo):
        m = mha.replace(wq=wq, wk=wk, wv=wv, wo=wo)
        return jnp.sum(jnp.sin(m(x, padding_mask=mask, causal=causal)))

    def loss_ref(x, wq, wk, wv, wo):
        return jnp.sum(jnp.sin(_jnp_attention(
            x, wq, wk, wv, wo, mha.num_heads, causal, mask)))

    args = (x, mha.wq, mha.wk, mha.wv, mha.wo)
    with jax.default_matmul_precision("highest"):
        got = jax.grad(loss_layer, argnums=range(5))(*args)
        want = jax.grad(loss_ref, argnums=range(5))(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4)


def test_bf16_inputs():
    mha, x, mask = _inputs(1, 64, 32, 2, seed=2, dtype=jnp.bfloat16)
    out = mha(x, padding_mask=mask)
    assert out.dtype == jnp.bfloat16
    ref = _np_attention(np.asarray(x, np.float32), mha, True, mask)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref, atol=5e-2, rtol=5e-2
    )
