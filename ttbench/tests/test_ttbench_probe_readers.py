"""The readers of the step probe's fields on the tracer's ``counter``
events (``serve_loop_ms``, ``stepper_plan_ms``, ``token_step_host_ms``,
``sync_wait_ms``, ``host_syncs_per_step``, ``interstep_idle_ms``): each
is the mean over the window's counter events that carry its field, and
None where none does.  A traced CPU run gives the five host readers and
leaves the device's out."""

import time
from pathlib import Path
from types import SimpleNamespace as Run

import pytest
import torch

from ttbench import harness
from ttbench.tests.test_ttbench_harness import _cell_dir

HERE = Path(__file__).resolve().parents[1]
HOST = ("serve_loop_ms", "stepper_plan_ms", "token_step_host_ms",
        "sync_wait_ms", "host_syncs_per_step")


def _reader(name):
    return harness._module(HERE / "metrics" / f"{name}.py")


def _counter(t, **probe):
    return (t, "counter", -1, -1, {"queue": 0, "pages_in_use": 3, **probe})


def _probe(loop, plan, host, sync, reads, uploads, idle=None):
    d = {"turn_s": loop + plan + host + sync, "loop_s": loop,
         "plan_s": plan, "step_host_s": host, "sync_s": sync,
         "trace_s": 0.0, "reads": reads, "uploads": uploads,
         "upload_bytes": 64 * uploads}
    if idle is not None:
        d["idle_before_s"] = idle
    return d


RUN = Run(seconds=10.0, events=[
    (0.5, "queued", -1, 0, {"plen": 9}),
    _counter(1.0, **_probe(0.001, 0.002, 0.010, 0.004, 12, 13)),
    (1.5, "token", 0, 0, {"node": 0}),
    _counter(2.0, **_probe(0.003, 0.004, 0.020, 0.006, 12, 15, 0.002)),
    _counter(3.0),                              # no probe: not read
    _counter(12.0, **_probe(9.0, 9.0, 9.0, 9.0, 99, 99, 9.0)),  # after
])

EXPECT = {"serve_loop_ms": 2.0, "stepper_plan_ms": 3.0,
          "token_step_host_ms": 15.0, "sync_wait_ms": 5.0,
          "host_syncs_per_step": 26.0, "interstep_idle_ms": 2.0}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_means_the_window_counters(name):
    read = _reader(name).read
    assert read(RUN) == pytest.approx(EXPECT[name])
    assert read(Run(seconds=10.0, events=None)) is None
    assert read(Run(seconds=10.0, events=[_counter(1.0)])) is None
    assert read(Run(seconds=0.5, events=RUN.events)) is None


def test_a_traced_cpu_run_reads_the_host_parts(tmp_path):
    root = _cell_dir(tmp_path)
    out = harness.run_cell(root, "tiny-tier", 2**31 + 7, 2.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True
    got = out["metrics"]
    for name in HOST:
        assert got[name]["value"] > 0, name
    assert "interstep_idle_ms" not in got       # CUDA events: card only
