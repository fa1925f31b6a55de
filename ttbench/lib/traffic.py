"""Open-loop traffic from a data file (``traffic/<name>.json``).

A mix names its arrival process, rate, length distributions and
strategy tiers.  The work a run offers is the same for every seed: the
arrival times, the prompt and output lengths and the tiers are drawn
from the mix's own ``shape_seed``, one schedule a window length; the
run's ``--seed`` draws the prompts' tokens (and the harness the weights
from it).  So the spread between runs is the system's, not the
schedule's: with the lengths reordered a seed, which long requests fall
at the window's end moved the rate by 10% and the TTFT tail by 24%.

Keys of a mix:
  ``arrival``   ``"poisson"`` (exponential gaps) or ``"onoff"`` (Poisson
                during ``on_s`` seconds, silence for ``off_s``, the ON rate
                scaled so the mean stays ``rate``)
  ``rate``      mean arrivals a second (absolute, found by a sweep)
  ``prompt`` / ``output``  ``{"median", "sigma", "min", "max"}``: a
                lognormal length, rounded and clipped
  ``tiers``     ``[{"strategy", "share"}, ...]``: each request's strategy
  ``shape_seed`` the seed of the fixed multiset
  ``who``       one line: which users send this traffic
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["load", "poisson_arrivals", "lengths", "make_requests"]


def load(path) -> dict:
    with open(path) as f:
        mix = json.load(f)
    for key in ("arrival", "rate", "prompt", "output", "tiers",
                "shape_seed"):
        if key not in mix:
            raise ValueError(f"traffic {path}: no {key!r}")
    if not mix["rate"] > 0:
        raise ValueError(f"traffic {path}: rate must be > 0")
    shares = sum(t["share"] for t in mix["tiers"])
    if abs(shares - 1.0) > 1e-9:
        raise ValueError(f"traffic {path}: tier shares sum to {shares}")
    return mix


def poisson_arrivals(rate: float, t0: float, t1: float,
                     rng: np.random.Generator) -> list[float]:
    """Poisson arrivals in ``[t0, t1)`` (a copy of the program's
    ``serving.runtime.workload._poisson_arrivals``)."""
    out, t = [], t0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= t1:
            return out
        out.append(t)


def _arrival_times(mix: dict, seconds: float,
                   rng: np.random.Generator) -> np.ndarray:
    if mix["arrival"] == "poisson":
        return np.asarray(poisson_arrivals(mix["rate"], 0.0, seconds, rng))
    if mix["arrival"] == "onoff":
        on, off = float(mix["on_s"]), float(mix["off_s"])
        rate_on = mix["rate"] * (on + off) / on
        out, t = [], 0.0
        while t < seconds:
            out += poisson_arrivals(rate_on, t, min(t + on, seconds), rng)
            t += on + off
        return np.asarray(out)
    raise ValueError(f"unknown arrival process {mix['arrival']!r}")


def lengths(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lognormal lengths: ``median * exp(sigma * z)``, rounded and
    clipped to ``[min, max]``."""
    z = rng.standard_normal(n)
    raw = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(raw, dist["min"], dist["max"]).astype(np.int64)


def _tiers(mix: dict, n: int) -> list:
    """Exactly ``round(share * n)`` requests a tier (the first tier takes
    what rounding leaves), in tier order."""
    counts = [int(round(t["share"] * n)) for t in mix["tiers"]]
    counts[0] = n - sum(counts[1:])
    return [t["strategy"] for t, c in zip(mix["tiers"], counts)
            for _ in range(c)]


def make_requests(mix: dict, seconds: float, seed: int,
                  vocab: int) -> list[dict]:
    """The requests due in ``[0, seconds)``: dicts with ``rid``,
    ``arrival``, ``prompt`` (int32 ids), ``max_tokens`` and
    ``strategy``, by arrival.  The schedule (arrivals, lengths, tiers)
    comes from the mix's ``shape_seed`` alone; ``seed`` draws the
    prompts' tokens."""
    shape = np.random.default_rng(mix["shape_seed"])
    times = _arrival_times(mix, seconds, shape)
    n = len(times)
    plen = lengths(mix["prompt"], n, shape)
    olen = lengths(mix["output"], n, shape)
    tiers = _tiers(mix, n)
    tiers = [tiers[i] for i in shape.permutation(n)]
    rng = np.random.default_rng(seed)
    return [{"rid": rid, "arrival": float(times[rid]),
             "prompt": rng.integers(0, vocab, int(plen[rid]),
                                    dtype=np.int64).astype(np.int32),
             "max_tokens": int(olen[rid]), "strategy": tiers[rid]}
            for rid in range(n)]
