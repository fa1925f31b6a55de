"""`ServeReport` — the one serve report (DESIGN.md §12).

`launch/serve.py` used to stitch each serve's closing report out of
bespoke ``print()`` blocks, three of which had drifted into near-
copies (the latency block, and two flavours of the "kv pool: peak …"
line).  The report now builds a `MetricsRegistry` first — every
number the old prints showed lands as a labelled gauge — and renders
its lines *from the registry*, so ``--metrics-out`` and the console
report can never disagree.

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
        self._switches: list[dict] = []     # human log, not a metric
        self._gear: str | None = None

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

    def add_step_probe(self, totals: Mapping[str, Any]) -> None:
        """A traced wall-clock serve's running totals of its turns' parts
        and transfers (`StepProbe.totals`)."""
        self.registry.absorb("probe", totals)
        self._sections.append("probe")

    def add_adaptive(self, st: Mapping[str, Any]) -> None:
        self._gear = st.get("gear")
        self._switches = list(st.get("switches", ()))
        self.registry.absorb("adaptive", {
            k: v for k, v in st.items()
            if k not in ("switches", "gear")})
        self._sections.append("adaptive")

    def add_trace(self, tracer, flight=None) -> None:
        self.registry.absorb("trace", tracer.stats())
        if flight is not None:
            self.registry.absorb("flight", flight.stats())
        self._sections.append("trace")

    def add_ledger(self, report: Mapping[str, Any]) -> None:
        """Invariant-ledger verdicts (audit.py's ``ledger_report/v1``)."""
        self._ledger = dict(report)
        self.registry.absorb("ledger", {
            "events_seen": report.get("events_seen", 0),
            "total_violations": report.get("total_violations", 0),
            "checks": sum(c.get("checks", 0) for c in
                          report.get("contracts", {}).values()),
        })
        self._sections.append("ledger")

    def add_lossmap(self, lm: Mapping[str, Any]) -> None:
        """Goodput-loss attribution (lossmap.py's ``obs_lossmap/v1``)."""
        self._lossmap = dict(lm)
        self.registry.absorb("lossmap", {
            k: v for k, v in lm.items()
            if k not in ("schema", "stalls_s")})
        self._sections.append("lossmap")

    def add_regret(self, doc: Mapping[str, Any]) -> None:
        """Decision-quality regret (regret.py's ``obs_regret/v1``)."""
        self._regret = dict(doc)
        self.registry.absorb("regret", {
            k: v for k, v in doc.items()
            if k in ("requests", "tokens", "regret_mean", "regret_p99",
                     "regret_max", "regret_total") and v is not None})
        self._sections.append("regret")

    def add_pareto(self, doc: Mapping[str, Any]) -> None:
        """Streaming frontier (pareto.py's ``obs_pareto/v1``)."""
        self._pareto = dict(doc)
        self.registry.absorb("pareto", {
            "points": doc.get("points", 0),
            "frontier_size": doc.get("frontier_size", 0)})
        self._sections.append("pareto")

    # -------------------------------------------------------- renderers
    def _v(self, name: str, default=None, **labels):
        return self.registry.value(name, default, **labels)

    def _runtime_lines(self) -> list[str]:
        v = self._v
        head = (f"completed {v('runtime_completed', 0):.0f}/"
                f"{v('runtime_requests', 0):.0f} requests, "
                f"{v('runtime_tokens', 0):.0f} tokens in "
                f"{v('runtime_duration', 0.0):.2f}s")
        ncan = v("runtime_cancelled", 0)
        nmiss = v("runtime_timed_out", 0)
        if ncan or nmiss:
            head += (f" (cancelled {ncan:.0f}, "
                     f"deadline-missed {nmiss:.0f})")
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
        slack50 = v("runtime_deadline_slack_p50")
        if slack50 is not None:
            lines.append(f"deadline slack: p50 {_ms(slack50)} "
                         f"p95 {_ms(v('runtime_deadline_slack_p95'))} "
                         f"p99 {_ms(v('runtime_deadline_slack_p99'))}")
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

    def _probe_lines(self) -> list[str]:
        v = self._v
        n = max(v("probe_turns", 0), 1)
        ms = {p: 1e3 * v(f"probe_{p}_s", 0.0) / n
              for p in ("turn", "loop", "plan", "step_host", "sync",
                        "trace")}
        line = (f"step host time: {v('probe_turns', 0):.0f} turns of "
                f"{ms['turn']:.2f}ms = loop {ms['loop']:.2f} + plan "
                f"{ms['plan']:.2f} + step {ms['step_host']:.2f} + sync "
                f"{ms['sync']:.2f} + trace {ms['trace']:.2f}; "
                f"{v('probe_reads', 0) / n:.1f} reads + "
                f"{v('probe_uploads', 0) / n:.1f} uploads "
                f"({v('probe_upload_bytes', 0) / n:.0f} B) a turn")
        idle = v("probe_idle_steps", 0)
        if idle:
            line += (f"; device idle between steps "
                     f"{1e3 * v('probe_idle_before_s', 0.0) / idle:.2f}ms")
        if "cascade" in self._sections:
            # the cascade's own uploads between rungs go around the probe
            line += "; the cascade's handoff uploads not counted"
        return [line]

    def _adaptive_lines(self) -> list[str]:
        v = self._v
        lines = [(f"adaptive: final gear {self._gear}, "
                  f"{v('adaptive_gear_switches', 0):.0f} gear switches, "
                  f"{v('adaptive_recalibrations', 0):.0f} online "
                  f"recalibrations")]
        for sw in self._switches:
            lines.append(f"  t={sw['t']:6.2f}s  {sw['from']} -> {sw['to']}")
        return lines

    def _trace_lines(self) -> list[str]:
        v = self._v
        line = (f"trace: {v('trace_events', 0):.0f} events buffered "
                f"({v('trace_emitted', 0):.0f} emitted, "
                f"{v('trace_dropped', 0):.0f} dropped)")
        bundles = v("flight_bundles")
        if bundles is not None:
            line += f"; flight recorder bundles: {bundles:.0f}"
        return [line]

    def _ledger_lines(self) -> list[str]:
        rep = getattr(self, "_ledger", {})
        contracts = rep.get("contracts", {})
        total = rep.get("total_violations", 0)
        checks = sum(c.get("checks", 0) for c in contracts.values())
        verdict = "PASS" if total == 0 else "VIOLATED"
        if any(c.get("verdict") == "unverifiable"
               for c in contracts.values()):
            verdict = "UNVERIFIABLE"
        lines = [f"ledger: {len(contracts)} contracts, {checks} checks, "
                 f"{total} violations ({verdict})"]
        for v in rep.get("violations", ())[:5]:
            lines.append(f"  {v['contract']} @ t={v['t']:.2f}s: "
                         f"{v['detail']}")
        return lines

    def _lossmap_lines(self) -> list[str]:
        lm = getattr(self, "_lossmap", {})
        loss = lm.get("loss_tok_s", {})
        gap = lm.get("loss_total_tok_s", 0.0)
        head = (f"lossmap: ceiling {lm.get('ceiling_tok_s', 0.0):.1f} "
                f"tok/s, goodput {lm.get('goodput_tok_s', 0.0):.1f} "
                f"tok/s (gap {gap:.1f})")
        parts = [f"{c} {v:.2f}" for c, v in sorted(
            loss.items(), key=lambda kv: -kv[1]) if v > 0]
        if parts:
            head += ": " + ", ".join(parts)
        return [head]

    def _regret_lines(self) -> list[str]:
        rep = getattr(self, "_regret", {})
        verdict = rep.get("verdict", "exact")
        if verdict == "unverifiable":
            return [(f"regret: UNVERIFIABLE over "
                     f"{rep.get('requests', 0)} requests "
                     f"(ring dropped events; numbers demoted)")]
        mean = rep.get("regret_mean") or 0.0
        p99 = rep.get("regret_p99") or 0.0
        head = (f"regret: mean {mean:.4f} p99 {p99:.4f} over "
                f"{rep.get('requests', 0)} requests ({verdict})")
        parts = [f"{c} {v:.4f}" for c, v in sorted(
            rep.get("causes", {}).items(), key=lambda kv: -kv[1])
            if v > 0]
        if parts:
            head += ": " + ", ".join(parts)
        return [head]

    def _pareto_lines(self) -> list[str]:
        rep = getattr(self, "_pareto", {})
        head = (f"pareto: {rep.get('frontier_size', 0)} frontier points "
                f"/ {rep.get('points', 0)} served")
        parts = [f"{g} {s['frontier']}/{s['points']}"
                 for g, s in sorted(rep.get("by_gear", {}).items())
                 if s.get("frontier")]
        if parts:
            head += " (" + ", ".join(parts) + ")"
        return [head]

    def lines(self) -> list[str]:
        order = ("runtime", "adaptive", "segments", "cascade", "pool",
                 "chunk", "probe", "trace", "ledger", "lossmap", "regret",
                 "pareto")
        render = {"runtime": self._runtime_lines,
                  "adaptive": self._adaptive_lines,
                  "segments": self._segments_lines,
                  "cascade": self._cascade_lines,
                  "pool": self._pool_lines,
                  "chunk": self._chunk_lines,
                  "probe": self._probe_lines,
                  "trace": self._trace_lines,
                  "ledger": self._ledger_lines,
                  "lossmap": self._lossmap_lines,
                  "regret": self._regret_lines,
                  "pareto": self._pareto_lines}
        out: list[str] = []
        for section in order:
            if section in self._sections:
                out.extend(render[section]())
        return out

    def print(self) -> None:
        for line in self.lines():
            print(line)
