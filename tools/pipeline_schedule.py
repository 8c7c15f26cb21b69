"""Compiler-level proof that pipelined execution exposes hideable comm.

The one-step-stale pipelined mode (training/pipelined.py — parity with
the reference's `pipeline_execution_with_tensor_core`, reference
tensorflow/distributed_embedding.py:49-50) exists to hide the embedding
exchange collectives behind dense compute on multi-device meshes. This
tool extracts the evidence from the COMPILED 8-device SPMD program
itself:

For every collective instruction in the scheduled post-optimization HLO
of the pipelined and unpipelined train steps, it computes the
transitive fan-in/fan-out over the entry computation (following
control-predecessor edges and calls into fused computations) and counts
the dense matmuls (dot instructions) that are in NEITHER set — i.e.
dots a latency-hiding scheduler is FREE to overlap with that
collective, because no data dependency orders them.

Expected shape of the result (asserted by tests/test_pipeline_schedule.py):
  * unpipelined step: every embedding collective has ~0 overlappable
    dots — the forward exchange gates the dense stack (acts feed the
    MLPs) and the backward all-gather is gated by it (needs d_acts).
  * pipelined step: the prefetch's exchange collectives (the NEXT
    batch's id all-to-alls + activation reduce-scatter) overlap with
    ~ALL dots — the stale-activation contract removed the dependency.

Run: python tools/pipeline_schedule.py [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import deque

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

COLLECTIVES = (
    "all-to-all",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
)

_INSTR_RE = re.compile(r"^\s+(?:ROOT\s+)?%?([\w.\-]+) = ")
_OPCODE_RE = re.compile(r"[\]\})]\s([a-z][a-z0-9\-]*)\(|^([a-z][a-z0-9\-]*)\(")
_NAME_RE = re.compile(r"%([\w.\-]+)")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s+->")


def parse_hlo(text: str):
    """Scheduled-HLO text -> (entry_name, computations).

    computations: name -> list of (instr_name, opcode, operand_names,
    called_computations). Instruction order within a computation IS the
    compiled schedule (`is_scheduled=true`).
    """
    comps: dict[str, list] = {}
    entry = None
    cur = None
    for line in text.splitlines():
        if line.startswith(("HloModule",)):
            continue
        m = _COMP_RE.match(line)
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            if line.startswith("ENTRY"):
                entry = cur
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is None:
            continue
        im = _INSTR_RE.match(line)
        if not im:
            continue
        name = im.group(1)
        rest = line[im.end():]
        om = _OPCODE_RE.search(rest)
        opcode = (om.group(1) or om.group(2)) if om else "?"
        # Output bytes from the shape prefix (covers tuple shapes).
        nbytes = 0
        for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", rest[: om.start() + 1] if om else rest):
            size = {"f64": 8, "s64": 8, "u64": 8, "bf16": 2, "f16": 2,
                    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1}.get(dt, 4)
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * size
        # Operands and control deps: %names in the call parens +
        # control-predecessors; called computations via calls=/to_apply=.
        called = re.findall(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)", rest)
        # Strip metadata (contains no graph edges, may contain stray %).
        rest_nometa = re.sub(r"metadata=\{[^}]*\}", "", rest)
        ops = [
            n
            for n in _NAME_RE.findall(rest_nometa)
            if n not in called
        ]
        comps[cur].append((name, opcode, ops, called, nbytes))
    return entry, comps


def _dots_in(comp_name, comps, cache):
    """#dot instructions reachable through calls from this computation."""
    if comp_name in cache:
        return cache[comp_name]
    cache[comp_name] = 0  # cycle guard
    n = 0
    for _, opcode, _, called, _ in comps.get(comp_name, []):
        if opcode == "dot":
            n += 1
        for c in called:
            n += _dots_in(c, comps, cache)
    cache[comp_name] = n
    return n


def analyze(text: str):
    entry, comps = parse_hlo(text)
    instrs = comps[entry]
    index = {name: i for i, (name, _, _, _, _) in enumerate(instrs)}
    dot_cache: dict[str, int] = {}

    # Entry-level "dense" instructions: carry >=1 dot (directly or
    # inside their fused/called computations).
    dots = {}
    for name, opcode, _, called, _ in instrs:
        n = (1 if opcode == "dot" else 0) + sum(
            _dots_in(c, comps, dot_cache) for c in called
        )
        if n:
            dots[name] = n
    total_dots = sum(dots.values())

    # Adjacency (entry computation only; operand + control edges).
    preds = {name: set() for name, _, _, _, _ in instrs}
    succs = {name: set() for name, _, _, _, _ in instrs}
    for name, _, ops, _, _ in instrs:
        for o in ops:
            if o in preds:  # entry-local edge
                preds[name].add(o)
                succs[o].add(name)

    def reach(start, edges):
        seen = set()
        q = deque([start])
        while q:
            u = q.popleft()
            for v in edges[u]:
                if v not in seen:
                    seen.add(v)
                    q.append(v)
        return seen

    rows = []
    for name, opcode, _, _, nbytes in instrs:
        if not any(opcode.startswith(c) for c in COLLECTIVES):
            continue
        fan_in = reach(name, preds)
        fan_out = reach(name, succs)
        blocked = set(dots) & (fan_in | fan_out)
        overlappable = total_dots - sum(dots[d] for d in blocked)
        rows.append(
            {
                "collective": name,
                "opcode": opcode,
                "out_bytes": nbytes,
                "schedule_index": index[name],
                "dots_in_fan_in": sum(
                    dots[d] for d in set(dots) & fan_in
                ),
                "dots_in_fan_out": sum(
                    dots[d] for d in set(dots) & fan_out
                ),
                "overlappable_dots": overlappable,
                "overlappable_frac": (
                    overlappable / total_dots if total_dots else 0.0
                ),
            }
        )
    return {
        "entry_instructions": len(instrs),
        "total_dots": total_dots,
        "collectives": rows,
    }


def build_steps():
    """(pipelined_compiled, unpipelined_compiled) on the 8-dev CPU mesh."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import optax

    import bench
    from keras_rs_tpu import training
    from keras_rs_tpu.models.dlrm import bce_loss
    from keras_rs_tpu.parallel import mesh as mesh_lib

    mesh = mesh_lib.create_mesh()
    state, step, batch, cfg, model = bench.build(
        "sharded", mesh, batch_size=512, vocab=50_000, dim=64
    )
    un = jax.jit(step, donate_argnums=(0,)).lower(state, batch).compile()

    optimizer = optax.adagrad(cfg.learning_rate)
    embed_fn, get_pre, inject = training.dlrm_pipeline_fns()
    body = training.make_pipelined_train_step(
        bce_loss, optimizer, embed_fn, get_pre, inject, jit=False
    )

    def step_p(s, raw):
        b = s.model.preprocess_on_device(raw)
        return body(s, b, b["large_pre"])

    import jax as _jax

    first_pre = _jax.jit(
        lambda m, r: m.preprocess_on_device(r)["large_pre"]
    )(model, batch)
    state_p = training.create_pipelined_train_state(
        model, optimizer, first_pre, embed_fn
    )
    pi = (
        _jax.jit(step_p, donate_argnums=(0,))
        .lower(state_p, batch)
        .compile()
    )
    return pi, un


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    pi, un = build_steps()
    res = {
        "pipelined": analyze(pi.as_text()),
        "unpipelined": analyze(un.as_text()),
    }
    for kind in ("unpipelined", "pipelined"):
        r = res[kind]
        print(
            f"\n{kind}: {r['entry_instructions']} scheduled entry "
            f"instructions, {r['total_dots']} dots"
        )
        print(
            f"  {'collective':<34}{'opcode':<20}"
            f"{'out bytes':>12}{'ovl dots':>12}  frac"
        )
        for row in r["collectives"]:
            print(
                f"  {row['collective']:<34}{row['opcode']:<20}"
                f"{row['out_bytes']:>12}"
                f"{row['overlappable_dots']:>12}"
                f"  {row['overlappable_frac']:.2f}"
            )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
