"""Synthetic open-loop traffic generators (DESIGN.md §7).

Three arrival processes cover the serving regimes the scheduler must
survive:

  * ``poisson``  — memoryless steady load (the queueing-theory default).
  * ``bursty``   — ON/OFF modulated Poisson: silence, then bursts at a
    multiple of the mean rate (tests lane recycling under backlog).
  * ``diurnal``  — a sin^2 ramp from zero up to the peak rate and back
    (tests admission under slowly drifting load).

Every generator is seeded and fully deterministic: the same
``(name, rate, duration, seed)`` produces byte-identical requests, and
each request's prompt / token budget derive from its own draw order, so
workloads replay exactly across runs and schedulers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.runtime.request import Request

__all__ = ["WorkloadSpec", "make_workload", "available_workloads",
           "inflection_times"]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Shared knobs for all generators."""

    rate: float                    # mean arrivals/sec (diurnal: peak)
    duration: float                # arrival window [0, duration)
    prompt_len: int = 32           # fixed prompt bucket (static shapes)
    vocab: int = 512
    max_tokens: tuple = (4, 32)    # inclusive uniform decode budget
    seed: int = 0
    lam: float | None = None       # stamped on every request
    strategy: str | None = None    # stamped on every request

    def __post_init__(self):
        if not self.rate > 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if not self.duration > 0:
            raise ValueError(f"duration must be > 0, got {self.duration}")
        lo, hi = self.max_tokens
        if not 1 <= lo <= hi:
            raise ValueError(f"bad max_tokens range {self.max_tokens}")


def _finish(arrivals: np.ndarray, spec: WorkloadSpec,
            rng: np.random.Generator) -> list[Request]:
    lo, hi = spec.max_tokens
    reqs = []
    for rid, t in enumerate(np.sort(arrivals)):
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, spec.vocab, size=(spec.prompt_len,),
                                dtype=np.int32),
            max_tokens=int(rng.integers(lo, hi + 1)),
            arrival=float(t),
            lam=spec.lam,
            strategy=spec.strategy,
        ))
    return reqs


def _poisson_arrivals(rate: float, t0: float, t1: float,
                      rng: np.random.Generator) -> list[float]:
    out, t = [], t0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= t1:
            return out
        out.append(t)


def poisson(spec: WorkloadSpec) -> list[Request]:
    """Homogeneous Poisson arrivals at ``spec.rate``."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.asarray(
        _poisson_arrivals(spec.rate, 0.0, spec.duration, rng))
    return _finish(arrivals, spec, rng)


def bursty(spec: WorkloadSpec, *, on: float = 1.0,
           off: float = 3.0) -> list[Request]:
    """ON/OFF traffic: Poisson bursts during ``on``-second windows
    separated by ``off`` seconds of silence; the ON rate is scaled so the
    long-run mean is still ``spec.rate``."""
    rng = np.random.default_rng(spec.seed)
    rate_on = spec.rate * (on + off) / on
    arrivals, t = [], 0.0
    while t < spec.duration:
        arrivals += _poisson_arrivals(rate_on, t,
                                      min(t + on, spec.duration), rng)
        t += on + off
    return _finish(np.asarray(arrivals), spec, rng)


def diurnal(spec: WorkloadSpec, *, period: float | None = None,
            phase: float = 0.0, amplitude: float = 1.0) -> list[Request]:
    """Inhomogeneous Poisson with
    ``rate(t) = peak * amplitude * sin^2(pi (t - phase) / period)``
    (thinning construction).  The defaults — one period spanning the
    window, zero phase, full amplitude — reproduce the classic
    zero→peak→zero ramp bit-for-bit; shorter periods stack several
    day/night cycles into one serve, which is what the adaptive-control
    tests ride.
    """
    if period is None:
        period = spec.duration
    if not period > 0:
        raise ValueError(f"period must be > 0, got {period}")
    if not 0.0 < amplitude <= 1.0:
        raise ValueError(f"amplitude must be in (0, 1], got {amplitude}")
    rng = np.random.default_rng(spec.seed)
    cand = np.asarray(
        _poisson_arrivals(spec.rate, 0.0, spec.duration, rng))
    accept = rng.random(cand.shape) < amplitude * \
        np.sin(np.pi * (cand - phase) / period) ** 2
    return _finish(cand[accept], spec, rng)


def inflection_times(spec: WorkloadSpec, *, period: float | None = None,
                     phase: float = 0.0, amplitude: float = 1.0,
                     threshold: float = 0.5) -> list[tuple[float, str]]:
    """Analytic crossings of the diurnal rate curve with
    ``threshold * spec.rate`` inside ``[0, duration)``.

    Returns ``[(t, "rising" | "falling"), ...]`` sorted by time — the
    exact instants a load-indexed controller with that gear threshold
    SHOULD switch, so tests can assert observed gear switches land at
    known traffic inflections.  With ``threshold = 0.5 * amplitude``'s
    midpoint the crossing sits where ``|d rate/dt|`` is maximal (the
    sin^2 curve is steepest at half its peak), which is the "steepest
    traffic inflection" the adaptive smoke gate measures at.  An empty
    list means the curve never reaches the threshold.
    """
    if period is None:
        period = spec.duration
    peak = spec.rate * amplitude
    if not 0.0 < threshold:
        raise ValueError(f"threshold must be > 0, got {threshold}")
    level = threshold * spec.rate / peak   # sin^2 value at the crossing
    if level >= 1.0:
        return []
    a = float(np.arcsin(np.sqrt(level)))   # in [0, pi/2)
    out = []
    # sin^2(u) crosses `level` rising at u = k*pi + a and falling at
    # u = k*pi + (pi - a); map u back through t = phase + period * u / pi
    k = int(np.floor(-phase / period)) - 1
    while True:
        base = phase + k * period
        if base >= spec.duration:
            break
        rising = base + period * a / np.pi
        falling = base + period * (np.pi - a) / np.pi
        for t, kind in ((rising, "rising"), (falling, "falling")):
            if 0.0 <= t < spec.duration:
                out.append((float(t), kind))
        k += 1
    return sorted(out)


_WORKLOADS = {"poisson": poisson, "bursty": bursty, "diurnal": diurnal}


def available_workloads() -> tuple:
    return tuple(sorted(_WORKLOADS))


def make_workload(name: str, spec: WorkloadSpec, **kwargs) -> list[Request]:
    """Build the named arrival process from a `WorkloadSpec`."""
    try:
        gen = _WORKLOADS[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; available: "
                       f"{', '.join(available_workloads())}") from None
    return gen(spec, **kwargs)
