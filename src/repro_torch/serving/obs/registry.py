"""`MetricsRegistry` — counters / gauges / histograms with labels,
one ``snapshot()`` / Prometheus-text / JSON surface (DESIGN.md §12).

The serving subsystems each keep their own stats dicts
(`RuntimeMetrics.summary()`, `KVPool.stats()`, `CascadeStats`,
chunk-planner counters, controller switch logs).  Rather than rewrite
those hot paths, the registry *absorbs* them: `absorb()` walks a
nested mapping and lands every numeric leaf as a labelled gauge, so
one snapshot carries the whole serve regardless of which subsystems
ran.  Live counters/histograms are there for code that wants to emit
directly (the flight recorder, future burn-in harness).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Mapping

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed cumulative buckets + sum + count (Prometheus semantics)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0)

    def __init__(self, buckets: Iterable[float] | None = None) -> None:
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1

    @property
    def value(self) -> dict[str, Any]:
        return {"buckets": {str(le): c for le, c
                            in zip(self.buckets, self.counts)},
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Registry keyed by (name, labelset); one instance per serve."""

    def __init__(self) -> None:
        self._metrics: dict[tuple[str, tuple], Any] = {}
        self._help: dict[str, str] = {}

    # ------------------------------------------------------- factories
    def _get(self, cls, name: str, labels: Mapping[str, str], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(**kw)
        elif not isinstance(m, cls):
            raise TypeError(f"{name} already registered as {m.kind}")
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Iterable[float] | None = None,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    # -------------------------------------------------------- absorb
    def absorb(self, prefix: str, stats: Mapping[str, Any] | None,
               **labels: str) -> None:
        """Flatten every numeric leaf of ``stats`` into gauges named
        ``prefix_<path>`` carrying ``labels``.  Non-numeric leaves and
        None are skipped; nested mappings recurse with ``_``-joined
        paths; lists of scalars land as ``_n``-indexed gauges only when
        short (<= 8) — long lists are summarised by their length."""
        if not stats:
            return
        for k, v in stats.items():
            name = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                self.absorb(name, v, **labels)
            elif isinstance(v, bool):
                self.gauge(name, **labels).set(float(v))
            elif isinstance(v, (int, float)):
                self.gauge(name, **labels).set(float(v))
            elif isinstance(v, (list, tuple)):
                if len(v) <= 8 and all(
                        isinstance(x, (int, float)) for x in v):
                    for i, x in enumerate(v):
                        self.gauge(f"{name}_{i}", **labels).set(float(x))
                else:
                    self.gauge(f"{name}_len", **labels).set(float(len(v)))
            # strings / None / objects: not a metric

    # -------------------------------------------------------- queries
    def value(self, name: str, default: float | None = None,
              **labels: str) -> Any:
        m = self._metrics.get((name, _label_key(labels)))
        return default if m is None else m.value

    def labelsets(self, name: str) -> list[dict[str, str]]:
        return [dict(ls) for (n, ls) in self._metrics if n == name]

    # -------------------------------------------------------- surfaces
    def snapshot(self) -> dict[str, Any]:
        """Flat ``{name{labels}: value}`` mapping — the one structure
        the reporter, ``--metrics-out`` and tests all read."""
        out: dict[str, Any] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            out[name + _label_str(labels)] = m.value
        return out

    def prometheus_text(self) -> str:
        lines: list[str] = []
        seen_type: set[str] = set()
        for (name, labels), m in sorted(self._metrics.items()):
            if name not in seen_type:
                seen_type.add(name)
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for le, c in zip(m.buckets, m.counts):
                    ls = _label_str(labels + (("le", str(le)),))
                    lines.append(f"{name}_bucket{ls} {c}")
                ls = _label_str(labels)
                lines.append(f"{name}_bucket"
                             f"{_label_str(labels + (('le', '+Inf'),))} "
                             f"{m.count}")
                lines.append(f"{name}_sum{ls} {m.sum}")
                lines.append(f"{name}_count{ls} {m.count}")
            else:
                lines.append(f"{name}{_label_str(labels)} {m.value}")
        return "\n".join(lines) + "\n"

    def to_json(self, path: str, *, extra: Mapping[str, Any] | None = None,
                ) -> dict[str, Any]:
        payload: dict[str, Any] = {"schema": "obs_metrics/v1",
                                   "metrics": self.snapshot()}
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=float)
        return payload
