"""SASRec: self-attentive sequential recommendation — full walkthrough.

Counterpart of the reference's examples/sas_rec.py (656 lines): there,
MovieLens-1M watch histories are turned into fixed-length sessions, a
keras-hub ReversibleEmbedding + PositionEmbedding + causal
TransformerDecoder stack is trained with a contrastive BCE on aligned
positive/negative sequences (:377-561), and next-item retrieval uses the
tied item embedding as the candidate table. This walkthrough reproduces
each of those stages:

  1. DATA  — sessions from `synthetic.markov_sessions` (no network in
     this environment): a noisy item-transition graph, so next-item
     prediction has intrinsic entropy and held-out recall@10 is bounded
     by ~(1 - noise) * 10 / branching, NOT 1.0. Sessions are truncated/
     left-padded to a fixed context length exactly like the reference
     pads ML-1M histories (pad id 0 = mask).
  2. MODEL — `models.sasrec.SASRec`: tied item embedding (the same
     matrix embeds inputs and scores candidates — "reversible"), learned
     position embedding, N pre-norm causal transformer blocks.
  3. OBJECTIVE — for every position t, the model state must score the
     TRUE next item above a sampled negative: elementwise BCE on
     (positive, negative) logits, masked at padding (sasrec_loss).
  4. EVAL — next-item recall@10 and NDCG@10 on HELD-OUT sessions, with a
     popularity baseline (the honest floor) and the task ceiling printed
     for context.

Run:  python examples/sas_rec.py            (defaults, ~1 min on CPU)
      python examples/sas_rec.py --epochs 20 --layers 3
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from keras_rs_tpu import training
from keras_rs_tpu.data import synthetic
from keras_rs_tpu.models.sasrec import SASRec, sasrec_loss

# --------------------------------------------------------------------------
# 1. Data: noisy Markov sessions, padded like the reference pads ML-1M.
# --------------------------------------------------------------------------
NUM_ITEMS = 500
BRANCHING = 12
NOISE = 0.2
T = 20  # context length (the reference uses 200 for ML-1M)


def make_sessions(num_sessions: int, seed: int = 0):
    """Full sequences [N, T+1] -> (history, per-position positives,
    sampled negatives). Position t's positive is the item at t+1, the
    same shifted-by-one alignment the reference builds (:430-470)."""
    seq = synthetic.markov_sessions(
        num_items=NUM_ITEMS, num_sessions=num_sessions, length=T,
        branching=BRANCHING, noise=NOISE, seed=seed,
    )
    rng = np.random.default_rng(seed + 1)
    hist = seq[:, :T]
    pos = seq[:, 1 : T + 1]
    # Uniform negatives, resampled away from the positive (the reference
    # samples uniformly over the catalog too).
    neg = rng.integers(1, NUM_ITEMS + 1, size=pos.shape).astype(np.int32)
    neg = np.where(neg == pos, (pos % NUM_ITEMS) + 1, neg)
    return hist, pos, neg


def pad_left(hist: np.ndarray, to_length: int) -> np.ndarray:
    """Left-pad variable-length prefixes to a fixed context (pad id 0).

    Demonstrates the reference's session padding; the training data
    above is already fixed-length, so this is used for the ragged-prefix
    inference demo at the end."""
    out = np.zeros((hist.shape[0], to_length), hist.dtype)
    out[:, to_length - hist.shape[1]:] = hist
    return out


# --------------------------------------------------------------------------
# 4. Eval helpers: recall@10, NDCG@10, popularity baseline.
# --------------------------------------------------------------------------
def evaluate(model, hist, truth, k=10):
    user_repr = model(jnp.asarray(hist))
    retrieval = model.make_retrieval(k=k)
    _, top = retrieval(user_repr)
    top = np.asarray(top)
    hits = np.asarray([
        np.nonzero(top[i] == truth[i])[0] for i in range(len(top))
    ], dtype=object)
    recall = float(np.mean([len(h) > 0 for h in hits]))
    ndcg = float(np.mean([
        1.0 / np.log2(2 + h[0]) if len(h) else 0.0 for h in hits
    ]))
    return recall, ndcg


def popularity_baseline(train_pos, truth, k=10):
    pop = np.argsort(np.bincount(train_pos.reshape(-1)))[-k:]
    return float(np.mean(np.isin(truth, pop)))


def main(epochs: int = 10, layers: int = 2, heads: int = 2,
         dim: int = 64, batch: int = 256):
    hist, pos, neg = make_sessions(6144)
    n_train = 5120  # 1024 held-out sessions

    # ----------------------------------------------------------------------
    # 2. Model: tied embedding + positions + causal transformer blocks.
    # ----------------------------------------------------------------------
    model = SASRec(
        vocabulary_size=NUM_ITEMS,
        num_layers=layers,
        num_heads=heads,
        hidden_dim=dim,
        max_sequence_length=32,
        key=jax.random.key(0),
    )
    n_params = sum(
        x.size for x in jax.tree_util.tree_leaves(model)
        if hasattr(x, "size")
    )
    print(f"SASRec: {layers} blocks, {heads} heads, dim {dim} "
          f"({n_params:,} params)")

    # ----------------------------------------------------------------------
    # 3. Train with the contrastive objective.
    # ----------------------------------------------------------------------
    trainer = training.Trainer(model, optax.adam(0.005), sasrec_loss)

    def data():
        order = np.random.default_rng(2).permutation(n_train)
        for i in range(0, n_train, batch):
            j = order[i : i + batch]
            yield {
                "item_history": jnp.asarray(hist[j]),
                "positive_sequence": jnp.asarray(pos[j]),
                "negative_sequence": jnp.asarray(neg[j]),
            }

    t0 = time.time()
    h = trainer.fit(data, epochs=epochs, log_every=0)
    print(f"loss: {h['loss'][0]:.4f} -> {h['loss'][-1]:.4f} "
          f"({time.time() - t0:.0f}s, {epochs} epochs)")

    # ----------------------------------------------------------------------
    # 4. Held-out next-item eval vs baseline and ceiling.
    # ----------------------------------------------------------------------
    truth = pos[n_train:, -1]
    recall, ndcg = evaluate(trainer.model, hist[n_train:], truth)
    pop = popularity_baseline(pos[:n_train], truth)
    ceiling = (1 - NOISE) * 10 / BRANCHING
    print(f"held-out recall@10: {recall:.3f}  NDCG@10: {ndcg:.3f} "
          f"(popularity {pop:.3f}, task ceiling ~{ceiling:.2f})")

    # Ragged-prefix inference: score users with SHORT histories by
    # left-padding into the fixed context (pad id 0 is masked).
    short = pad_left(hist[n_train : n_train + 4, -5:], T)
    r5, _ = evaluate(trainer.model, short, truth[:4])
    print(f"5-item-prefix demo recall@10 (4 users): {r5:.2f}")
    return recall


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--batch", type=int, default=256)
    a = p.parse_args()
    main(a.epochs, a.layers, a.heads, a.dim, a.batch)
