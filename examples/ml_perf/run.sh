#!/usr/bin/env bash
# MLPerf DLRM-DCNv2 launcher (parity: keras-rs examples/ml_perf/run.sh,
# which provisions cloud VMs and runs main.py on every worker).
#
# Single host:
#   ./run.sh smoke_test
#   ./run.sh full_criteo --num_steps=1000 --num_devices=1
#   ./run.sh smoke_test --device_preprocessing   # id->COO inside the
#       jitted step: no host preprocessing threads at all
#
# Multi-host: run on every host after jax.distributed is configured
#   (keras_rs_tpu/parallel/multihost.py); the dataloader shards batches
#   per process with identical seeded shuffles (keras_rs_tpu/data/
#   criteo.py), and stats/checkpoints sync across processes.
#
# Optional env (read by main.py as config overrides; equivalently pass
# --profile or set profile_dir/checkpoint_dir in the config):
#   KRT_PROFILE_DIR=/tmp/trace   capture a jax.profiler trace there
#   KRT_CHECKPOINT_DIR=...       Orbax checkpoint/resume directory
#   JAX_COMPILATION_CACHE_DIR    compile cache (default <repo>/.jax_cache)
#
# Measurement flags:
#   --scan_timing     re-measure the train step after training, chained
#                     in one jitted scan (device ms/step without the
#                     host loader: device_step_ms / device_examples_per_sec)
#   --eval_every N    evaluate every N steps; results carry an auc_curve
#                     (convergence-to-plateau evidence; eval wall time is
#                     excluded from the throughput clock)
set -euo pipefail

CONFIG="${1:-smoke_test}"
shift || true

cd "$(dirname "$0")/../.."
exec python -m examples.ml_perf.main --config "${CONFIG}" "$@"
