"""Entry-point helpers: compile cache, optional orbax, device peaks,
timing."""

import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    from keras_rs_tpu.utils.compile_cache import enable_compile_cache
    print("DIR", enable_compile_cache())
    import jax, jax.numpy as jnp
    hits = []
    jax.monitoring.register_event_listener(
        lambda name, **kw: hits.append(name.endswith("cache_hits"))
    )
    jax.jit(lambda x: jnp.sin(x) * 3.25 + {salt})(jnp.ones(3)).block_until_ready()
    print("HITS", sum(hits))
    """
)


def _cache_run(env_dir=None, salt=17.125):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE.format(repo=REPO, salt=salt)],
        env=env, capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    fields = dict(line.split(" ", 1) for line in out.splitlines())
    return fields["DIR"], int(fields["HITS"])


def test_compile_cache_defaults_to_repo_dir_and_is_reused():
    d1, _ = _cache_run(salt=23.5)
    d2, hits = _cache_run(salt=23.5)
    assert d1 == d2 == os.path.join(REPO, ".jax_cache")
    assert hits > 0
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_env_dir_is_used_and_no_other(tmp_path):
    d1, hits1 = _cache_run(env_dir=tmp_path)
    d2, hits2 = _cache_run(env_dir=tmp_path)
    assert d1 == d2 == str(tmp_path)
    assert hits1 == 0 and hits2 > 0
    assert os.listdir(tmp_path)


_NO_ORBAX = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    sys.modules["orbax"] = None  # any import of orbax now fails
    sys.modules["orbax.checkpoint"] = None
    import keras_rs_tpu.training as training
    import examples.ml_perf.main  # noqa: F401
    try:
        training.CheckpointManager({ckpt!r})
    except ImportError as e:
        print("IMPORT_ERROR", e)
    """
)


@pytest.mark.parametrize("what", ["import", "checkpoint_error"])
def test_training_works_without_orbax(what, tmp_path):
    r = subprocess.run(
        [sys.executable, "-c",
         _NO_ORBAX.format(repo=REPO, ckpt=str(tmp_path / "ckpt"))],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300,
    )
    if what == "import":
        assert r.returncode == 0, r.stderr
    else:
        assert "IMPORT_ERROR" in r.stdout and "orbax" in r.stdout


def test_device_peaks_known_device():
    import bench

    h100 = types.SimpleNamespace(
        device_kind="NVIDIA H100 80GB HBM3", platform="gpu"
    )
    peaks = bench.device_peaks(h100)
    assert peaks["bf16_flops_per_s"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12


def test_device_peaks_unknown_device_raises():
    import bench

    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(jax.devices()[0])


def test_measure_step_time_chains_and_returns_state():
    from keras_rs_tpu.utils.timing import measure_step_time

    def step(state, batch):
        new = state + batch
        return new, jnp.sum(new)

    s, state = measure_step_time(
        step, jnp.zeros(4), jnp.ones(4), iters=3, blocks=2
    )
    assert s > 0
    # compile/warm block + 2 timed blocks, 3 steps each
    np.testing.assert_array_equal(np.asarray(state), np.full(4, 9.0))


def test_chained_call_ms_runs_every_call():
    from keras_rs_tpu.utils.timing import chained_call_ms

    ms = chained_call_ms(
        lambda a, b: a @ b,
        (jnp.ones((8, 8)), jnp.ones((8, 8))),
        lambda args, tick: (args[0] + tick, args[1]),
        lambda out: jnp.mean(out) * 1e-6,
        iters=4,
    )
    assert np.isfinite(ms) and ms > 0
