"""The step probe (`repro_torch.serving.obs.probe`) on the card: every
operation that synchronizes the host with the card during a traced
chunked paged serve, or a stop-the-world ring serve, is one of the
probe's reads or uploads, turn by turn, and an untraced serve records
no CUDA event.  ``cuda`` marker:
skipped without a card.  It imports no JAX, so it runs there; the CPU
tests of the probe are in test_torch_obs.py."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving import runtime as rt
from repro_torch.serving.obs import Observability
from repro_torch.serving.runtime.request import Request

LANES = 4
# the warning torch.cuda.set_sync_debug_mode("warn") gives for each
# synchronizing operation (setting the mode warns too, in other words)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _stepper(dev, kv):
    cfg = get_config("paper-ee-100m", smoke=True)
    params = materialize(M.model_defs(cfg),
                         torch.Generator().manual_seed(0), dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (64, 16))
    casc = strategy.Cascade.calibrate(params, cfg, tokens, 0.5, k=8)
    bank = (strategy.make("recall_index", casc),)
    paging = {} if kv == "ring" else {"page_size": 8, "paged_kernel": True,
                                      "prefill_chunk": 8}
    stepper = rt.EngineStepper(params, cfg, bank, n_lanes=LANES,
                               cache_len=64, prompt_len=12, kv=kv,
                               **paging)
    stepper.warmup()                 # builds and loads the kernels
    return cfg, stepper


def _requests(cfg, kv):
    rng = np.random.default_rng(5)
    return [Request(rid=r, prompt=rng.integers(
                        0, cfg.vocab, 12 if kv == "ring" else 9 + 3 * r,
                        dtype=np.int32),
                    max_tokens=3 + r % 5, arrival=0.03 * r)
            for r in range(10)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["paged", "ring"])
def test_probe_counts_every_sync_on_the_card(monkeypatch, kv):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, stepper = _stepper(torch.device("cuda"), kv)
    events = []
    made = []
    event_cls = torch.cuda.Event

    class Counted(event_cls):
        def __new__(cls, *a, **k):
            made.append(1)
            return super().__new__(cls, *a, **k)

    monkeypatch.setattr(torch.cuda, "Event", Counted)
    with torch.no_grad():
        rt.Server(stepper, rt.LaneScheduler(LANES),
                  lambda r: 0).serve(_requests(cfg, kv), warmup=False)
    assert made == [], "an untraced serve recorded CUDA events"

    obs = Observability()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        obs.tracer.add_listener(
            lambda ev: ev.kind == "counter" and events.append(
                (len(caught), dict(ev.data))))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                rt.Server(stepper, rt.LaneScheduler(LANES), lambda r: 0,
                          obs=obs).serve(_requests(cfg, kv), warmup=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [i for i, w in enumerate(caught)
             if SYNC_WARNING in str(w.message)]
    assert len(events) > 5 and made
    seen = 0
    for n_caught, d in events:
        in_turn = sum(1 for i in syncs if seen <= i < n_caught)
        assert in_turn == d["reads"] + d["uploads"], d
        seen = n_caught
    assert sum(1 for i in syncs if i >= seen) == 0
    assert stepper.probe is None and obs.probe.totals["turns"] == len(events)
    idle = [d["idle_before_s"] for _, d in events if "idle_before_s" in d]
    assert idle and all(x >= 0.0 for x in idle)
