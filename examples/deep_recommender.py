"""Deep recommender: multi-feature towers with feature engineering — a
full walkthrough.

Counterpart of the reference's examples/deep_recommender.py (871 lines),
which is a tour of building a production-shaped retrieval model in four
stages: (1) feature engineering with keras FeatureSpace — discretized
continuous features, crossed categoricals, TextVectorization of titles
(:137-303); (2) multi-feature Query and Candidate towers (:487-630);
(3) training on MovieLens; (4) recall@k eval with a candidate-embedding
refresh before evaluation (:669-760). This walkthrough rebuilds every
stage:

  1. FEATURE ENGINEERING (`data.feature_engineering`):
       * `bucketize`           <- FeatureSpace.float_discretized
       * `hash_cross`          <- FeatureSpace.cross(crossing_dim=...)
       * `TextVectorizer`      <- keras TextVectorization
     All transforms run on the host in numpy and emit integer ids; the
     device only ever does embedding lookups (integer gathers are the
     jit-friendly boundary — no strings or dynamic shapes cross jit).
  2. TOWERS: the query tower embeds user id + bucketized age + the
     (user x age-bucket) cross; the candidate tower embeds item id +
     multi-hot genres (weighted mean combiner) + title-token mean. Each
     tower concatenates and MLPs into a shared space.
  3. TRAINING: in-batch sampled softmax (each row's item is the
     positive; the rest of the batch are negatives).
  4. EVAL: candidates are RE-EMBEDDED with the trained tower before
     evaluation (the candidate refresh the reference demonstrates),
     then held-out recall@k at several k with a popularity baseline.

Data is `synthetic.implicit_feedback` (no network in this sandbox):
stochastic multimodal preferences whose held-out recall has a sub-1.0
ceiling (the top-k preference mass), so the metric is discriminative.

Run:  python examples/deep_recommender.py
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from keras_rs_tpu import training
from keras_rs_tpu.core.module import Module
from keras_rs_tpu.data import synthetic
from keras_rs_tpu.data.feature_engineering import (
    TextVectorizer,
    bucketize,
    hash_cross,
)
from keras_rs_tpu.layers import MLP, EmbedReduce
from keras_rs_tpu.layers.retrieval.retrieval import BruteForceRetrieval

CROSS_BINS = 256
AGE_BOUNDARIES = np.linspace(20, 70, 9)  # 10 buckets


# --------------------------------------------------------------------------
# 2. Towers. Every input is an integer id stream produced by stage 1.
# --------------------------------------------------------------------------
class QueryTower(Module):
    """user id ++ age bucket ++ hash_cross(user, age) -> MLP -> R^dim."""

    def __init__(self, num_users, num_age_buckets, dim, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        self.user_emb = EmbedReduce(num_users, dim, key=k1)
        self.age_emb = EmbedReduce(num_age_buckets + 1, 8, key=k2)
        # Crossed feature (user x age bucket), FeatureSpace.cross parity:
        # lets the model learn age-conditional user taste with one table.
        self.cross_emb = EmbedReduce(CROSS_BINS, 8, key=k4)
        self.mlp = MLP(dim + 8 + 8, (64, dim), key=k3)

    def __call__(self, user_ids, age_bucket, cross_ids):
        x = jnp.concatenate(
            [
                self.user_emb(user_ids),
                self.age_emb(age_bucket),
                self.cross_emb(cross_ids),
            ],
            axis=-1,
        )
        return self.mlp(x)


class CandidateTower(Module):
    """item id ++ weighted multi-hot genres ++ title tokens -> MLP."""

    def __init__(self, num_items, num_genres, title_vocab, dim, key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        self.item_emb = EmbedReduce(num_items, dim, key=k1)
        # Multi-hot genre list, mean-combined with per-genre weights
        # (EmbedReduce's combiner path == the reference's weighted
        # embedding lookup).
        self.genre_emb = EmbedReduce(num_genres, 8, key=k2, combiner="mean")
        # Title text tower (TextVectorization parity): mean of token embs.
        self.title_emb = EmbedReduce(
            title_vocab, 8, key=k4, combiner="mean"
        )
        self.mlp = MLP(dim + 8 + 8, (64, dim), key=k3)

    def __call__(self, item_ids, genres, genre_weights, title_ids,
                 title_w):
        x = jnp.concatenate(
            [
                self.item_emb(item_ids),
                self.genre_emb(genres, genre_weights),
                self.title_emb(title_ids, title_w),
            ],
            axis=-1,
        )
        return self.mlp(x)


class DeepRecommender(Module):
    def __init__(self, num_users, num_items, num_genres, title_vocab,
                 dim, key):
        kq, kc = jax.random.split(key)
        self.query = QueryTower(num_users, 10, dim, kq)
        self.candidate = CandidateTower(
            num_items, num_genres, title_vocab, dim, kc
        )


def main():
    num_users, num_items, num_genres, dim = 400, 150, 12, 32
    rng = np.random.default_rng(0)

    # ----------------------------------------------------------------------
    # 0. Interactions: stochastic preferences + held-out events.
    # ----------------------------------------------------------------------
    fb = synthetic.implicit_feedback(
        num_users=num_users, num_items=num_items, num_events=20_000,
        holdout_per_user=2, seed=0,
    )
    user_ids, item_ids = fb["user_id"], fb["item_id"]
    n = len(user_ids)

    # ----------------------------------------------------------------------
    # 1. Feature engineering on the host (integer ids out).
    # ----------------------------------------------------------------------
    ages = rng.uniform(18, 80, size=n).astype(np.float32)
    age_bucket = bucketize(ages, AGE_BOUNDARIES)
    item_genres = rng.integers(
        0, num_genres, size=(num_items, 3)
    ).astype(np.int32)
    genre_w = np.ones((num_items, 3), np.float32)
    # Synthetic titles -> TextVectorization-parity token ids.
    words = ["lion", "space", "war", "love", "king", "night", "return",
             "city", "last", "dream"]
    titles = [
        f"the {words[i % 10]} {words[(i * 3) % 10]}"
        for i in range(num_items)
    ]
    tv = TextVectorizer(output_sequence_length=4).adapt(titles)
    title_ids, title_w = tv(titles)
    print(
        f"features: {len(AGE_BOUNDARIES) + 1} age buckets, "
        f"{CROSS_BINS}-bin user x age cross, "
        f"{tv.vocabulary_size}-token title vocab"
    )

    model = DeepRecommender(
        num_users, num_items, num_genres, tv.vocabulary_size, dim,
        jax.random.key(0),
    )

    # ----------------------------------------------------------------------
    # 3. In-batch sampled-softmax training.
    # ----------------------------------------------------------------------
    def loss_fn(m, batch):
        q = m.query(
            batch["user_id"], batch["age_bucket"], batch["cross"]
        )
        c = m.candidate(
            batch["item_id"], batch["genres"], batch["genre_w"],
            batch["title_ids"], batch["title_w"],
        )
        scores = q @ c.T
        labels = jnp.arange(scores.shape[0])
        return -jnp.mean(
            jnp.take_along_axis(
                jax.nn.log_softmax(scores, -1), labels[:, None], -1
            )
        )

    trainer = training.Trainer(model, optax.adagrad(0.2), loss_fn)

    def data():
        idx = np.random.default_rng(1).permutation(n)
        for i in range(0, n, 512):
            j = idx[i : i + 512]
            yield {
                "user_id": jnp.asarray(user_ids[j]),
                "age_bucket": jnp.asarray(age_bucket[j]),
                "cross": jnp.asarray(
                    hash_cross(
                        [user_ids[j], age_bucket[j]], CROSS_BINS
                    )
                ),
                "item_id": jnp.asarray(item_ids[j]),
                "genres": jnp.asarray(item_genres[item_ids[j]]),
                "genre_w": jnp.asarray(genre_w[item_ids[j]]),
                "title_ids": jnp.asarray(title_ids[item_ids[j]]),
                "title_w": jnp.asarray(title_w[item_ids[j]]),
            }

    trainer.fit(data, epochs=12, log_every=0)

    # ----------------------------------------------------------------------
    # 4. Candidate refresh, then held-out recall@k + baseline.
    # Candidates MUST be re-embedded with the trained tower before eval
    # (deep_recommender.py:669-672 parity) — retrieval layers hold a
    # snapshot, not a live view, of the candidate embeddings.
    # ----------------------------------------------------------------------
    all_items = jnp.arange(num_items)
    candidates = trainer.model.candidate(
        all_items, jnp.asarray(item_genres), jnp.asarray(genre_w),
        jnp.asarray(title_ids), jnp.asarray(title_w),
    )
    eval_ages = bucketize(np.full(num_users, 40.0), AGE_BOUNDARIES)
    q = trainer.model.query(
        jnp.arange(num_users),
        jnp.asarray(eval_ages),
        jnp.asarray(
            hash_cross([np.arange(num_users), eval_ages], CROSS_BINS)
        ),
    )
    eu, ei = fb["eval_user_id"], fb["eval_item_id"]
    pop10 = np.argsort(np.bincount(item_ids, minlength=num_items))[-10:]
    recall10 = 0.0
    for k in (5, 10, 50):
        retrieval = BruteForceRetrieval(candidates, k=k)
        _, top = retrieval(q)
        top = np.asarray(top)
        r = float(np.mean([ei[j] in top[eu[j]] for j in range(len(eu))]))
        extra = (
            f"  (popularity baseline "
            f"{float(np.mean(np.isin(ei, pop10))):.3f})"
            if k == 10
            else ""
        )
        print(f"recall@{k}: {r:.3f}{extra}")
        if k == 10:
            recall10 = r
    return recall10


if __name__ == "__main__":
    main()
