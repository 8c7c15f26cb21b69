"""MLPerf DLRM-DCNv2 experiment configs.

Parity with examples/ml_perf/configs/*.py in the reference: the full
26-feature Criteo vocabulary (4x40M, 3M, 590k, ...), embedding_dim 128,
Adagrad lr 0.0034, global batch 16384, embedding_threshold 21000
(configs/v6e_8.py:15-190, 202-205). The reference's per-partition id
capacities are not configs here: main.build_model derives them from the
batch and the mesh.
"""

from __future__ import annotations

import dataclasses

# Criteo 26 categorical vocab sizes (reference configs/v6e_8.py:15-172).
CRITEO_VOCAB_SIZES = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
CRITEO_MULTI_HOT_SIZES = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    vocab_sizes: list
    multi_hot_sizes: list
    embedding_dim: int = 128
    bottom_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    num_dcn_layers: int = 3
    dcn_projection_dim: int = 512
    embedding_threshold: int = 21_000
    learning_rate: float = 0.0034
    global_batch_size: int = 16_384
    num_steps: int = 28_000
    file_pattern: str | None = None  # None -> dummy data
    val_file_pattern: str | None = None  # None -> dummy eval batches
    #: The reference's full-dataset TFRecords pack this many logical
    #: records per tf.train.Example (FILE-BATCHED schema — label
    #: Int64List[N], per-key dense FloatLists, categorical BytesLists
    #: of raw-i64 strings; reference configs/v6e_8_full_dataset.py:17
    #: sets 4224). None = one record per Example.
    file_batch_size: int | None = None
    num_loader_threads: int = 4
    #: Run the COO preprocessing ON DEVICE inside the jitted step
    #: instead of on host loader threads (the reference needs 4 threads
    #: to feed the chip; the device path removes the host bottleneck
    #: entirely — see device_preprocessing.py). Capacities are set to
    #: the worst case automatically since the in-jit path cannot grow.
    device_preprocessing: bool = False
    #: Safety factor over the uniform-MOD-sharding expectation when
    #: auto-sizing the per-shard UNIQUE capacity (the
    #: id-bucket capacity is always worst-case). The absolute worst case
    #: (every id of every shard congruent mod D) would need
    #: factor=num_shards; that inflates the backward's per-unique-row
    #: work D-fold, so the default covers 4x skew and training logs the
    #: observed dropped_ids so residual truncation is visible.
    device_unique_factor: int = 4
    #: One-step-stale pipelined embedding execution (the reference TF
    #: backend's `pipeline_execution_with_tensor_core`,
    #: tensorflow/distributed_embedding.py:49-50): the lookup for batch
    #: t+1 is dataflow-independent of batch t's dense compute, so XLA
    #: overlaps the gather + exchange collectives with the dense matmuls
    #: at the cost of lookups being one update old. Checkpoints written
    #: in this mode carry the prefetched activations and only resume
    #: into pipelined runs.
    pipeline_embedding: bool = False
    do_profile: bool = False
    #: After training, re-measure the train step chained in one jitted
    #: scan (keras_rs_tpu/utils/timing.py) and report `device_step_ms` /
    #: `device_examples_per_sec`, independent of the host loader.
    scan_timing: bool = False
    #: Use only the first N devices (None: every visible device). A
    #: one-card run on a several-card host sets 1.
    num_devices: int | None = None
    #: Evaluate (streaming AUC/accuracy over the eval batches) every N
    #: training steps and record an `auc_curve` in the results — the
    #: convergence-to-plateau evidence (reference target protocol:
    #: configs/v6e_32_full_dataset.py:205, AUC 0.8275). 0 = final only.
    eval_every: int = 0
    profile_dir: str = "/tmp/keras_rs_tpu_profile"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1000
    #: "bfloat16" halves the bytes of the embedding exchange (fwd
    #: activation reduce-scatter + bwd cotangent all-gather; local
    #: accumulation stays f32) — for exchange-bound multi-chip runs.
    embedding_comm_dtype: str | None = None
    #: "bfloat16" (default) keeps dense-stack activations resident in
    #: bf16 between matmul fusions (params/accumulation stay f32). Pass
    #: "float32" for f32-resident numerics.
    dense_output_dtype: str | None = "bfloat16"


def full_criteo(name="full_criteo", **overrides) -> ExperimentConfig:
    """The published model; `vocab_sizes` may be overridden to cap the
    tables for a device's memory."""
    defaults = dict(
        vocab_sizes=list(CRITEO_VOCAB_SIZES),
        multi_hot_sizes=list(CRITEO_MULTI_HOT_SIZES),
    )
    defaults.update(overrides)
    return ExperimentConfig(name=name, **defaults)


def smoke_test(**overrides) -> ExperimentConfig:
    """Tiny config for CI / single-chip smoke runs."""
    defaults = dict(
        vocab_sizes=[100_000, 50_000, 1000, 500, 60_000, 30],
        multi_hot_sizes=[3, 2, 1, 1, 4, 1],
        embedding_dim=32,
        bottom_mlp=(64, 32),
        top_mlp=(128, 64, 1),
        dcn_projection_dim=32,
        global_batch_size=512,
        num_steps=20,
    )
    defaults.update(overrides)
    return ExperimentConfig(name="smoke_test", **defaults)


# Per-topology configs mirroring the reference's five experiment files
# (configs/v6e_8.py, v6e_16.py, v6e_{8,16,32}_full_dataset.py). They
# share the model shape and differ only in data source, global batch,
# and step budget (reference v6e_8.py:195-198, v6e_16.py:197-200,
# v6e_16_full_dataset.py:202-205, v6e_32_full_dataset.py:202-205).
# The topology itself comes from the mesh at runtime, not the config,
# so these are named for the reference runs they reproduce.


def v6e_8(**overrides) -> ExperimentConfig:
    """Dummy-data bring-up run (reference v6e_8.py: batch 128, 2 steps)."""
    defaults = dict(global_batch_size=128, num_steps=2)
    defaults.update(overrides)
    return full_criteo(name="v6e_8", **defaults)


def v6e_16(**overrides) -> ExperimentConfig:
    """Dummy-data 2-host run (reference v6e_16.py: batch 16896, 10 steps)."""
    defaults = dict(global_batch_size=16_896, num_steps=10)
    defaults.update(overrides)
    return full_criteo(name="v6e_16", **defaults)


def _full_dataset(name, num_steps, **overrides) -> ExperimentConfig:
    defaults = dict(
        file_pattern="criteo/train/*.tfrecord",
        val_file_pattern=None,
        global_batch_size=16_384,
        num_steps=num_steps,
    )
    defaults.update(overrides)
    return full_criteo(name=name, **defaults)


def v6e_8_full_dataset(**overrides) -> ExperimentConfig:
    return _full_dataset("v6e_8_full_dataset", num_steps=2, **overrides)


def v6e_16_full_dataset(**overrides) -> ExperimentConfig:
    return _full_dataset("v6e_16_full_dataset", num_steps=40, **overrides)


def v6e_32_full_dataset(**overrides) -> ExperimentConfig:
    """The MLPerf target run: 28000 steps at global batch 16384."""
    return _full_dataset(
        "v6e_32_full_dataset", num_steps=28_000, **overrides
    )


CONFIGS = {
    "full_criteo": full_criteo,
    "smoke_test": smoke_test,
    "v6e_8": v6e_8,
    "v6e_16": v6e_16,
    "v6e_8_full_dataset": v6e_8_full_dataset,
    "v6e_16_full_dataset": v6e_16_full_dataset,
    "v6e_32_full_dataset": v6e_32_full_dataset,
}
