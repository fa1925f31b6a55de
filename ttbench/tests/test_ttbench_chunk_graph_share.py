"""The reader of ``chunk_graph_share``: the replays that the tracer's
``counter`` events count, over the window's steps that carried a chunk
(a ``prefill_chunk`` event between a step's ``counter`` event and the
one before), in percent; None on an untraced run, on a window with no
chunk step, and on a program that writes no ``chunk_graph_replays``.
A traced CPU run leaves it out: the CPU runs the chunk pass eagerly."""

import time
from pathlib import Path
from types import SimpleNamespace as Run

import pytest
import torch

from ttbench import harness
from ttbench.tests.test_ttbench_harness import _cell_dir

HERE = Path(__file__).resolve().parents[1]


def _read(run):
    return harness._module(HERE / "metrics" / "chunk_graph_share.py").read(run)


def _counter(t, **probe):
    return (t, "counter", -1, -1, {"queue": 0, "pages_in_use": 3, **probe})


def _chunk(t, lane=0):
    return (t, "prefill_chunk", lane, 7, {"width": 8, "left": 3})


def _graph(replays, captures=0):
    return {"chunk_graph_replays": replays,
            "chunk_graph_captures": captures}


GRAPHED = Run(seconds=10.0, events=[
    _chunk(0.9), _chunk(0.95, 1),
    _counter(1.0, **_graph(1)),                 # a chunk step, replayed
    (1.5, "token", 0, 0, {"node": 0}),
    _counter(2.0, **_graph(0)),                 # decode only
    _chunk(2.5),
    _counter(3.0, **_graph(0)),                 # a chunk step, eager
    _chunk(3.5),
    _counter(4.0, **_graph(1, 1)),              # recorded, then replayed
    _chunk(11.0),
    _counter(12.0, **_graph(1)),                # after the window
])


def test_chunk_graph_share_is_replays_over_chunk_steps():
    assert _read(GRAPHED) == pytest.approx(100.0 * 2 / 3)
    assert _read(Run(seconds=2.0, events=GRAPHED.events)) == 100.0
    # untraced, no chunk step, or a program without the counter: None
    assert _read(Run(seconds=10.0, events=None)) is None
    assert _read(Run(seconds=2.5, events=GRAPHED.events[2:])) is None
    parent = [ev if ev[1] != "counter" else _counter(ev[0])
              for ev in GRAPHED.events]
    assert _read(Run(seconds=10.0, events=parent)) is None


def test_a_traced_cpu_run_leaves_the_chunk_graph_out(tmp_path):
    root = _cell_dir(tmp_path)
    out = harness.run_cell(root, "tiny-tier", 2**31 + 11, 2.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True
    assert "chunk_graph_share" not in out["metrics"]
