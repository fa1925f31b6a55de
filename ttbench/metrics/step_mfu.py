"""Device, the whole step: useful model FLOPs done in the profiled span A
over its length times the card's f32 peak, in percent.  Useful: the
prompt rows prefilled there (every layer, each row against the keys up
to it, the head's readout of a prompt's last row) and the lane-segments
the strategies probed (``seg_policy``: a segment's layers for one token
against the lane's context, and its readout).  Lane slots computed and
not probed, and pad rows of a chunk, are not useful.  The counts are the
run's configuration family's (``prompt_flops``, ``probe_flops`` of
``families/<family>.py``)."""

from ttbench.lib.layer import profile
from ttbench.lib.peaks import F32_FLOP_S


def read(run):
    run = profile(run)
    a = run.profile.get("a") if run else None
    if a is None or not run.events or a["window_s"] <= 0:
        return None
    # the steps span A profiled: they started inside it
    inside = [i for i, s in enumerate(run.steps)
              if run.profile_a0 <= s.t0 < run.profile_b0]
    if not inside:
        return None
    first, last = inside[0], inside[-1]
    t0, t1 = run.steps[first].t0, run.steps[last].t1
    m, fam = run.m, run.cell.family
    plen = {r["rid"]: len(r["prompt"]) for r in run.reqs}
    flops = 0.0
    for t, kind, _, rid, data in run.events:
        if kind == "prefill_chunk" and t0 <= t <= t1:
            w, left = data["width"], data["left"]
            flops += fam.prompt_flops(m, plen[rid] - left - w, w, left == 0)
    # each lane's context: its prompt and the tokens it has had
    had = {}
    for i, s in enumerate(run.steps[:last + 1]):
        lanes = [int(s.rids[j]) for j in s.emit.nonzero()[0]]
        if i >= first and lanes:
            ctx = sum(plen[r] + had.get(r, 0) + 1 for r in lanes) / len(lanes)
            flops += fam.probe_flops(m, s.seg_policy, ctx)
        for r in lanes:
            had[r] = had.get(r, 0) + 1
    return 100.0 * flops / (a["window_s"] * F32_FLOP_S)
