"""The reader of ``chunk_row_fill``: the window's prompt rows over the
rows its chunk steps launched, in percent.  From the ``counter`` events'
``chunk_rows`` / ``chunk_rows_launched`` where the program writes them;
on a program that does not, from the ``prefill_chunk`` events' widths
over ``n_lanes x prefill_chunk`` a step that carried a chunk.  None on an
untraced run and on a window with no chunk step.  A traced CPU run reads
it from the counters, at least as full as the fixed shape would be."""

import time
from pathlib import Path
from types import SimpleNamespace as Run

import pytest
import torch

from ttbench import harness
from ttbench.tests.test_ttbench_harness import _cell_dir

HERE = Path(__file__).resolve().parents[1]
CELL = Run(config={"serving": {"prefill_chunk": 8}})


def _read(run):
    return harness._module(HERE / "metrics" / "chunk_row_fill.py").read(run)


def _counter(t, **probe):
    return (t, "counter", -1, -1, {"queue": 0, "pages_in_use": 3, **probe})


def _chunk(t, width, lane=0):
    return (t, "prefill_chunk", lane, 7, {"width": width, "left": 3})


def _rows(rows, launched):
    return {"chunk_rows": rows, "chunk_rows_launched": launched}


EVENTS = [
    _chunk(0.9, 8), _chunk(0.95, 3, 1),
    _counter(1.0, **_rows(11, 16)),             # two lanes: bucket 2
    (1.5, "token", 0, 0, {"node": 0}),
    _counter(2.0, **_rows(0, 0)),               # decode only
    _chunk(2.5, 5),
    _counter(3.0, **_rows(5, 8)),               # one lane: bucket 1
    _chunk(11.0, 8),
    _counter(12.0, **_rows(8, 8)),              # after the window
]


def _run(seconds, events):
    return Run(seconds=seconds, events=events, n_lanes=4, cell=CELL)


def test_chunk_row_fill_reads_the_counters():
    assert _read(_run(10.0, EVENTS)) == pytest.approx(100.0 * 16 / 24)
    assert _read(_run(2.0, EVENTS)) == pytest.approx(100.0 * 11 / 16)
    assert _read(_run(10.0, None)) is None
    assert _read(_run(2.5, EVENTS[3:5])) is None


def test_a_program_without_the_counters_launches_every_lane():
    parent = [ev if ev[1] != "counter" else _counter(ev[0])
              for ev in EVENTS]
    # 16 prompt rows over 2 chunk steps of 4 lanes x 8 rows
    assert _read(_run(10.0, parent)) == pytest.approx(100.0 * 16 / 64)
    assert _read(_run(1.0, parent)) == pytest.approx(100.0 * 11 / 32)
    assert _read(_run(2.5, parent[2:5])) is None


def test_a_traced_cpu_run_reads_the_row_fill(tmp_path):
    root = _cell_dir(tmp_path)
    out = harness.run_cell(root, "tiny-tier", 2**31 + 13, 2.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True
    fill = out["metrics"]["chunk_row_fill"]
    assert fill["unit"] == "%" and 0.0 < fill["value"] <= 100.0
