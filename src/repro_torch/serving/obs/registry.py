"""`MetricsRegistry` — the gauges behind the serve report (DESIGN.md §12).

The serving subsystems each keep their own stats dicts
(`RuntimeMetrics.summary()`, `KVPool.stats()`, chunk-planner counters).
Rather than rewrite those hot paths, the registry *absorbs* them:
`absorb()` walks a nested mapping and lands every numeric leaf as a
gauge, which the report reads back with `value()`.  A gauge is keyed by
its name and its labels (the cascade's per-model series carry a
``model`` label).
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = ["Gauge", "MetricsRegistry"]


class Gauge:
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def _label_key(labels: Mapping[str, str]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Registry keyed by (name, labels); one instance per serve."""

    def __init__(self) -> None:
        self._metrics: dict[tuple, Gauge] = {}

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._metrics.setdefault((name, _label_key(labels)),
                                        Gauge())

    def absorb(self, prefix: str, stats: Mapping[str, Any] | None,
               **labels: str) -> None:
        """Flatten every numeric leaf of ``stats`` into gauges named
        ``prefix_<path>`` carrying ``labels``.  Non-numeric leaves and None are skipped;
        nested mappings recurse with ``_``-joined paths; lists of scalars
        land as ``_n``-indexed gauges only when short (<= 8) — long lists
        are summarised by their length."""
        if not stats:
            return
        for k, v in stats.items():
            name = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                self.absorb(name, v, **labels)
            elif isinstance(v, (bool, int, float)):
                self.gauge(name, **labels).set(float(v))
            elif isinstance(v, (list, tuple)):
                if len(v) <= 8 and all(
                        isinstance(x, (int, float)) for x in v):
                    for i, x in enumerate(v):
                        self.gauge(f"{name}_{i}", **labels).set(float(x))
                else:
                    self.gauge(f"{name}_len", **labels).set(float(len(v)))
            # strings / None / objects: not a metric

    def value(self, name: str, default: float | None = None,
              **labels: str) -> Any:
        m = self._metrics.get((name, _label_key(labels)))
        return default if m is None else m.value
