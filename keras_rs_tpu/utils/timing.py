"""Device step timing.

`measure_step_time` chains M train steps inside ONE jitted `lax.scan`
(the carry's data dependency serializes them on the device) and reads
the host clock around the run up to `jax.block_until_ready`. Running M
steps per dispatch keeps Python dispatch out of the per-step figure.

The scan body must consume the carry in the measured op's inputs and
derive the next carry from a data-dependent value, or XLA hoists/DCEs
the body (train steps satisfy this naturally: state -> loss -> state).
"""

from __future__ import annotations

import functools
import time

import numpy as np


def make_scan_runner(step, iters: int):
    """Jit of `iters` chained `step(state, batch)` calls.

    Donates the state: without donation XLA copies the full tables+slots
    into the loop carry. The donated buffers reappear in the output (the
    final scan state), which is required for donation to engage at all.
    """
    import jax

    raw = getattr(step, "__wrapped__", step)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(state, batch):
        def body(s, _):
            s2, loss = raw(s, batch)
            return s2, loss

        s_final, losses = jax.lax.scan(body, state, None, length=iters)
        return s_final, losses[-1]

    return run


def time_block(run, state, batch):
    """One timed scan block; returns (elapsed_s, final_state)."""
    import jax

    t0 = time.perf_counter()
    state, loss = run(state, batch)
    jax.block_until_ready((state, loss))
    return time.perf_counter() - t0, state


def measure_step_time(
    step, state, batch, iters: int = 20, blocks: int = 5
):
    """Median per-step device seconds of `step` over `blocks` scan runs.

    Returns (s_per_step, final_state). The state buffers passed in are
    DONATED — use the returned state afterwards.
    """
    run = make_scan_runner(step, iters)
    _, state = time_block(run, state, batch)  # compile + warm
    ts = []
    for _ in range(blocks):
        el, state = time_block(run, state, batch)
        ts.append(el)
    return float(np.median(ts)) / iters, state


def chained_call_ms(fn, args, perturb, derive, iters=50, repeats=3):
    """Median ms per call of `fn(*args)`, `iters` calls in one jitted scan.

    `perturb(args, tick) -> args` folds the previous call's derived scalar
    into the inputs and `derive(out) -> f32 scalar` produces the next
    tick, so XLA can neither hoist the calls out of the loop nor drop
    them. Pass large arrays inside `args`: closed-over arrays become
    compile-time constants.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(args):
        def body(tick, _):
            return derive(fn(*perturb(args, tick))), None

        last, _ = jax.lax.scan(
            body, jnp.zeros((), jnp.float32), None, length=iters
        )
        return last

    jax.block_until_ready(run(args))  # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / iters * 1e3
