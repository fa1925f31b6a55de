"""`ServeReport` — the one serve report (DESIGN.md §12).

The report builds a `MetricsRegistry` first — every number it shows
lands as a labelled gauge — and renders its lines *from the registry*.
The port keeps the sections its launcher fills (runtime, segments,
cascade, kv pool — one per cascade rung —, chunked prefill), with the
reference's wording; the control and observability sections come with
the slices that port their producers.

Sections are added for whatever subsystems actually ran; `lines()`
renders only what was added, in a stable order.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.serving.obs.registry import MetricsRegistry

__all__ = ["ServeReport", "segments_saved_line"]


def _ms(v: Any) -> str:
    return "n/a" if v is None else f"{1e3 * v:.0f}ms"


def segments_saved_line(seg_batch: int, seg_policy: int, *, steps: int,
                        n_seg: int, lane_steps: int) -> str:
    """One consistent line for every serving mode: each saving is a
    percentage of ITS OWN full-depth reference — batch-level counts
    segment launches (``steps * n_seg``), lane-level counts per-lane
    probes (``lane_steps * n_seg``)."""
    save_b = 100.0 * (1.0 - seg_batch / max(steps * n_seg, 1))
    save_l = 100.0 * (1.0 - seg_policy / max(lane_steps * n_seg, 1))
    return (f"segments saved: batch {save_b:.0f}% "
            f"({seg_batch}/{steps * n_seg} launches) / "
            f"lane {save_l:.0f}% ({seg_policy}/{lane_steps * n_seg} "
            f"per-lane probes)")


class ServeReport:
    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self._sections: list[str] = []
        self._models: list[str] = []        # cascade rung names, in order
        self._pool_models: list[str | None] = []

    # -------------------------------------------------------- sections
    def add_runtime(self, summary: Mapping[str, Any], *,
                    slo_ms: float | None = None) -> None:
        self.registry.absorb("runtime", summary)
        if slo_ms is not None:
            self.registry.gauge("runtime_slo_ms").set(slo_ms)
        self._sections.append("runtime")

    def add_segments(self, seg_batch: int, seg_policy: int, *, steps: int,
                     n_seg: int, lane_steps: int) -> None:
        self.registry.absorb("segments", {
            "run_batch": seg_batch, "run_policy": seg_policy,
            "steps": steps, "n_seg": n_seg, "lane_steps": lane_steps})
        self._sections.append("segments")

    def add_pool(self, stats: Mapping[str, Any],
                 model: str | None = None) -> None:
        labels = {"model": model} if model is not None else {}
        self.registry.absorb("kv_pool", stats, **labels)
        self._pool_models.append(model)
        if "pool" not in self._sections:
            self._sections.append("pool")

    def add_cascade(self, cs: Mapping[str, Any]) -> None:
        self._models = list(cs.get("models", ()))
        for key in ("escalations", "recalls", "deescalations", "commits",
                    "repin_tokens"):
            if key in cs:
                self.registry.gauge(f"cascade_{key}").set(float(cs[key]))
        for m, n in zip(self._models, cs.get("tokens_served", ())):
            self.registry.gauge("cascade_tokens_served", model=m).set(n)
        for m, pool in cs.get("pools", {}).items():
            self.add_pool(pool, model=m)
        self._sections.append("cascade")

    def add_chunked_prefill(self, cs: Mapping[str, Any]) -> None:
        self.registry.absorb("chunked_prefill", cs)
        self._sections.append("chunk")

    # -------------------------------------------------------- renderers
    def _v(self, name: str, default=None, **labels):
        return self.registry.value(name, default, **labels)

    def _runtime_lines(self) -> list[str]:
        v = self._v
        head = (f"completed {v('runtime_completed', 0):.0f}/"
                f"{v('runtime_requests', 0):.0f} requests, "
                f"{v('runtime_tokens', 0):.0f} tokens in "
                f"{v('runtime_duration', 0.0):.2f}s")
        lines = [
            head,
            (f"throughput: {v('runtime_throughput_tok_s', 0.0):.1f} tok/s "
             f"({v('runtime_throughput_req_s', 0.0):.2f} req/s)"),
            (f"latency: ttft p50 {_ms(v('runtime_ttft_p50'))} "
             f"p95 {_ms(v('runtime_ttft_p95'))} "
             f"p99 {_ms(v('runtime_ttft_p99'))}; "
             f"token p50 {_ms(v('runtime_token_latency_p50'))} "
             f"p95 {_ms(v('runtime_token_latency_p95'))} "
             f"p99 {_ms(v('runtime_token_latency_p99'))}"),
        ]
        att = v("runtime_slo_attainment")
        slo_ms = v("runtime_slo_ms")
        if att is not None and slo_ms is not None:
            lines.append(f"goodput (ttft<={slo_ms:.0f}ms): "
                         f"{v('runtime_goodput_tok_s', 0.0):.1f} tok/s "
                         f"(attainment {100 * att:.0f}%)")
        else:
            lines.append("goodput: n/a")
        return lines

    def _segments_lines(self) -> list[str]:
        v = self._v
        return [segments_saved_line(
            int(v("segments_run_batch", 0)), int(v("segments_run_policy", 0)),
            steps=int(v("segments_steps", 0)),
            n_seg=int(v("segments_n_seg", 1)),
            lane_steps=int(v("segments_lane_steps", 0)))]

    def _pool_lines(self) -> list[str]:
        lines = []
        for model in self._pool_models:
            labels = {"model": model} if model is not None else {}
            v = lambda name, d=0: self._v(name, d, **labels)  # noqa: E731
            tag = f" [{model}]" if model is not None else ""
            lines.append(
                f"kv pool{tag}: peak {v('kv_pool_pages_peak'):.0f}/"
                f"{v('kv_pool_n_pages', 1) - 1:.0f} pages, "
                f"prefix hit rate "
                f"{100 * v('kv_pool_prefix_hit_rate', 0.0):.0f}% "
                f"({v('kv_pool_shared_tokens'):.0f} shared tokens), "
                f"{v('kv_pool_cow_splits'):.0f} COW splits, "
                f"{v('kv_pool_evictions'):.0f} evictions, "
                f"{v('kv_pool_grows'):.0f} grows, "
                f"{v('kv_pool_reserve_failures'):.0f} blocked admissions")
        return lines

    def _cascade_lines(self) -> list[str]:
        v = self._v
        served = [int(v("cascade_tokens_served", 0, model=m))
                  for m in self._models]
        total = max(sum(served), 1)
        return [
            "cascade: " + ", ".join(
                f"{m} served {n} tokens ({100 * n / total:.0f}%)"
                for m, n in zip(self._models, served)),
            (f"escalations {v('cascade_escalations', 0):.0f}, "
             f"recalls {v('cascade_recalls', 0):.0f}, "
             f"de-escalations {v('cascade_deescalations', 0):.0f}, "
             f"commits {v('cascade_commits', 0):.0f}, "
             f"re-pinned catch-up tokens "
             f"{v('cascade_repin_tokens', 0):.0f}"),
        ]

    def _chunk_lines(self) -> list[str]:
        v = self._v
        computed = v("chunked_prefill_tokens_computed", 0)
        skipped = v("chunked_prefill_tokens_skipped", 0)
        total = computed + skipped
        return [(f"chunked prefill: {computed:.0f} prompt tokens computed "
                 f"over {v('chunked_prefill_chunk_steps', 0):.0f} "
                 f"co-scheduled chunk steps, {skipped:.0f}/"
                 f"{max(total, 1):.0f} skipped via prefix cache "
                 f"({v('chunked_prefill_prefills', 0):.0f} admissions)")]

    def lines(self) -> list[str]:
        render = {"runtime": self._runtime_lines,
                  "segments": self._segments_lines,
                  "cascade": self._cascade_lines,
                  "pool": self._pool_lines,
                  "chunk": self._chunk_lines}
        out: list[str] = []
        for section in render:
            if section in self._sections:
                out.extend(render[section]())
        return out

    def print(self) -> None:
        for line in self.lines():
            print(line)
