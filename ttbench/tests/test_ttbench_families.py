"""A configuration family's counts reached through its module: on a
made-up profiled phase with prefill chunks and probed steps,
``step_mfu`` through the run's family reads what the dense counts give
computed directly."""

import json
from pathlib import Path
from types import SimpleNamespace as Run

import numpy as np
import pytest

from ttbench import harness
from ttbench.lib import flops, shapes
from ttbench.lib.peaks import F32_FLOP_S

HERE = Path(__file__).resolve().parents[1]
A0, B0 = 10.0, 11.5


def made_up_phase(family, m, seed=0, lanes=4, n_steps=40):
    """A traced run whose profiled phase (span A from ``A0`` to ``B0``)
    holds steps that emit on some lanes with some lane-segments probed,
    and ``prefill_chunk`` events of 16-row chunks, some ending a prompt;
    its cell's family is ``family``."""
    rng = np.random.default_rng(seed)
    reqs = [{"rid": r, "prompt": np.zeros(int(n), np.int32)}
            for r, n in enumerate(rng.integers(5, 300, 3 * lanes))]
    events, steps, t = [], [], A0 - 0.4
    for i in range(n_steps):
        t1 = t + float(rng.uniform(0.02, 0.06))
        rids = rng.choice(len(reqs), lanes, replace=False)
        emit = rng.random(lanes) < 0.7
        steps.append(harness.Step(
            t, t1, int(rng.integers(1, 6)), int(rng.integers(0, 9)), emit,
            np.zeros(lanes, np.int64), np.zeros(lanes, np.int64), rids,
            bool(i % 2)))
        r = int(rng.integers(len(reqs)))
        plen = len(reqs[r]["prompt"])
        start = int(rng.integers(0, plen))
        w = min(16, plen - start)
        events.append((t1, "prefill_chunk", 0, r,
                       {"width": w, "left": plen - start - w}))
        t = t1
    phase = Run(cell=Run(family=family), m=m, reqs=reqs, steps=steps,
                events=events, profile={"a": {"window_s": B0 - A0}},
                profile_a0=A0, profile_b0=B0)
    return Run(phase=phase)


def direct_step_mfu(run):
    """The whole step's share of the f32 peak with the dense counts
    called directly (the reader as it was before the family held its
    counts)."""
    run = run.phase
    a = run.profile["a"]
    inside = [i for i, s in enumerate(run.steps)
              if run.profile_a0 <= s.t0 < run.profile_b0]
    first, last = inside[0], inside[-1]
    t0, t1 = run.steps[first].t0, run.steps[last].t1
    m = run.m
    plen = {r["rid"]: len(r["prompt"]) for r in run.reqs}
    total = 0.0
    for t, kind, _, rid, data in run.events:
        if kind == "prefill_chunk" and t0 <= t <= t1:
            w, left = data["width"], data["left"]
            total += flops.prompt_flops(m, plen[rid] - left - w, w,
                                        left == 0)
    had = {}
    for i, s in enumerate(run.steps[:last + 1]):
        lanes = [int(s.rids[j]) for j in s.emit.nonzero()[0]]
        if i >= first and lanes:
            ctx = sum(plen[r] + had.get(r, 0) + 1 for r in lanes) / len(lanes)
            total += flops.probe_flops(m, s.seg_policy, ctx)
        for r in lanes:
            had[r] = had.get(r, 0) + 1
    return 100.0 * total / (a["window_s"] * F32_FLOP_S)


@pytest.mark.parametrize("arch,seed", [("paper-ee-100m", 0),
                                       ("paper-ee-100m", 1),
                                       ("granite-3-2b", 2)])
def test_step_mfu_through_the_family_equals_the_direct_count(arch, seed):
    m = shapes.dense(json.loads((HERE / "configs" / f"{arch}.json")
                                .read_text()))
    family = harness._module(HERE / "families" / "dense.py")
    reader = harness._module(HERE / "metrics" / "step_mfu.py")
    run = made_up_phase(family, m, seed)
    got = reader.read(run)
    assert got is not None and got > 0
    assert got == direct_step_mfu(run)
