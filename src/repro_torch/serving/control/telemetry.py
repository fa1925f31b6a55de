"""`TelemetryWindow` — the control plane's sensor.

Folds the per-step emissions the server already produces (TTFT and
goodput-under-SLO via `RuntimeMetrics`' sliding window, served losses
via the stepper's ``row_tap``, arrivals, queue depth / pages-in-use /
escalation gauges) into trailing-window estimates, and derives the two
signals gear selection runs on:

  * **load level** — the arrival rate quantized against the gear bank's
    capacity thresholds;
  * **inflection detection** — the rate's finite-difference slope over
    the window's two halves, so the controller can tell a sustained
    diurnal ramp from noise and react while the ramp is still climbing
    instead of after the queue has already exploded.

Everything is bounded (`SlidingWindow` rings) and host-side; reading a
snapshot never touches the device.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serving.runtime.metrics import RuntimeMetrics, SlidingWindow

__all__ = ["TelemetryWindow", "TelemetrySnapshot"]

GAUGES = ("queue_depth", "pages_in_use", "escalations", "recalls")


@dataclasses.dataclass
class TelemetrySnapshot:
    """One window-consistent read of the serving state."""

    now: float
    arrival_rate: float        # requests/sec over the trailing window
    rate_slope: float          # d(rate)/dt between the window's halves
    mean_served_loss: float | None
    goodput_tok_s: float | None
    throughput_tok_s: float | None
    mean_served_node: float | None
    ttft_p95: float | None
    queue_depth: int = 0
    pages_in_use: int = 0
    escalations: int = 0
    recalls: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class TelemetryWindow:
    """Sliding-window fold of the server's emissions."""

    def __init__(self, span: float, *, slo: float | None = None,
                 maxlen: int = 4096):
        if not span > 0:
            raise ValueError(f"telemetry span must be > 0, got {span}")
        self.span = float(span)
        self.slo = slo
        self._arr = SlidingWindow(span, maxlen)     # arrival timestamps
        self._loss = SlidingWindow(span, maxlen)    # served losses
        self.gauges = {g: 0 for g in GAUGES}
        self.metrics: RuntimeMetrics | None = None
        self.t0 = 0.0

    def bind(self, metrics: RuntimeMetrics) -> None:
        """Attach to a serve run's metrics: turns on its bounded window
        (satellite fix) and anchors the rate clock at its start."""
        metrics.enable_window(self.span)
        self.metrics = metrics
        self.t0 = metrics.t_start

    # ---- feeds -------------------------------------------------------

    def on_arrival(self, t: float) -> None:
        self._arr.push(t, 1.0)

    def on_arrivals(self, times) -> None:
        for t in times:
            self._arr.push(float(t), 1.0)

    def on_losses(self, t: float, losses) -> None:
        for v in losses:
            self._loss.push(t, float(v))

    def on_gauges(self, **kv) -> None:
        for name, value in kv.items():
            if name not in self.gauges:
                raise KeyError(f"unknown gauge {name!r}; "
                               f"known: {GAUGES}")
            self.gauges[name] = int(value)

    # ---- derived signals ---------------------------------------------

    def _span_eff(self, now: float) -> float:
        """Trailing span actually covered (short right after start)."""
        return min(self.span, max(float(now) - self.t0, 1e-9))

    def arrival_rate(self, now: float) -> float:
        """Requests/sec over the trailing window (0.0 when empty —
        explicit, never NaN)."""
        return len(self._arr.items(now)) / self._span_eff(now)

    def rate_slope(self, now: float) -> float:
        """Finite-difference slope of the arrival rate: late-half rate
        minus early-half rate, per unit time.  Positive on a diurnal
        ramp-up, negative on the way down, ~0 in steady state — the
        inflection signal."""
        items = self._arr.items(now)
        half = self._span_eff(now) / 2.0
        if half <= 0 or not items:
            return 0.0
        mid = float(now) - half
        early = sum(1 for t, _ in items if t < mid)
        late = len(items) - early
        return (late - early) / half / half

    def inflecting(self, now: float, eps: float) -> bool:
        """Is the load moving fast enough to act on (|slope| > eps)?"""
        return abs(self.rate_slope(now)) > float(eps)

    def mean_served_loss(self, now: float) -> float | None:
        vals = self._loss.values(now)
        if not vals:
            return None
        return sum(vals) / len(vals)

    def load_level(self, now: float, thresholds) -> int:
        """Quantize the arrival rate against ascending rate thresholds:
        returns how many the current rate meets or exceeds (0 = idle
        regime, len(thresholds) = beyond the last)."""
        rate = self.arrival_rate(now)
        return sum(1 for th in thresholds if rate >= float(th))

    def snapshot(self, now: float) -> TelemetrySnapshot:
        win = {}
        if self.metrics is not None:
            win = self.metrics.window_summary(now, slo=self.slo)
        ttft = win.get("ttft") or {}
        return TelemetrySnapshot(
            now=float(now),
            arrival_rate=self.arrival_rate(now),
            rate_slope=self.rate_slope(now),
            mean_served_loss=self.mean_served_loss(now),
            goodput_tok_s=win.get("goodput_tok_s"),
            throughput_tok_s=win.get("throughput_tok_s"),
            mean_served_node=win.get("mean_served_node"),
            ttft_p95=ttft.get("p95"),
            **{g: self.gauges[g] for g in GAUGES},
        )
