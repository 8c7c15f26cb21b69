"""chip_smoke.py: its refusal without a GPU, and each phase at toy size.

The phases take their sizes as arguments, so the same code that runs at
full size on the card runs here on the CPU at a few rows; every check a
phase returns must pass (the four-card phase's per-card memory check
needs `memory_stats()`, which the CPU backend does not report).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_alone(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd, env={**env, **(env_extra or {})},
        capture_output=True, text=True, timeout=300,
    )


def _no_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


def test_exits_nonzero_without_gpu():
    r = _run_alone(REPO)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    _no_ok_line(r.stdout)


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_alone(tmp_path)
    assert r.returncode != 0
    _no_ok_line(r.stdout)


def test_check_and_error_helpers():
    assert chip_smoke.Check("e", 1e-6, 1e-5).ok
    assert not chip_smoke.Check("e", 2e-5, 1e-5).ok
    assert not chip_smoke.Check("e", float("nan"), 1.0).ok
    assert not chip_smoke.Check("d", 0.0, 0.0, strict=True).ok
    assert chip_smoke.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert chip_smoke.rel_err([1.0, 2.5], [1.0, 2.0]) == pytest.approx(0.25)
    a = np.array([1.0, -2.0, 0.0], np.float32)
    b = np.nextafter(a, np.float32(np.inf)).astype(np.float32)
    np.testing.assert_array_equal(chip_smoke.ulp_distance(a, b), [1, 1, 1])
    np.testing.assert_array_equal(chip_smoke.ulp_distance(a, a), [0, 0, 0])


def _assert_pass(result, skip=()):
    checks, info = result
    assert checks, info
    for c in checks:
        if c.name not in skip:
            assert c.ok, str(c)
    return info


def test_phase_coo_parity():
    _assert_pass(chip_smoke.phase_coo_parity(chip_smoke.PARITY_TRIALS[:2]))


def test_phase_embedding():
    info = _assert_pass(chip_smoke.phase_embedding(
        jax.devices(), vocab_cap=30_000, batch=32
    ))
    assert info["entries"] == 32 * 172


def test_phase_dense():
    _assert_pass(chip_smoke.phase_dense(jax.devices(), batch=8))


def test_phase_train():
    # At 4 toy steps the loss trend is noise; the full-size run checks it.
    info = _assert_pass(
        chip_smoke.phase_train(
            jax.devices(), vocab_cap=30_000, batch=64, steps=4,
            host_steps=2,
        ),
        skip=("last3_mean_minus_step1",),
    )
    assert info["host_coo_backend"] in ("native", "numpy")


def test_phase_sasrec():
    _assert_pass(chip_smoke.phase_sasrec(
        jax.devices(), batch=2, seq_len=16, items=50
    ))


def test_phase_four_on_virtual_devices():
    _assert_pass(
        chip_smoke.phase_four(
            jax.devices()[:4], vocab_cap=30_000, batch=64, steps=2
        ),
        skip=("cards_without_memory_stats",),
    )
