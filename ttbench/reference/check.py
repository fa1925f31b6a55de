"""The comparison that decides ``correct``.

For each sampled request the reference runs its prompt as the serve
feeds it, then replays the served tokens one by one, walking the
segments as its own tables decide.  At every judged position it reads
one number, the served logit gap: the widest of

- how far the served token's logit lies below the reference's best, at
  the node the reference serves (the first token, the head's choice
  after the prompt, is judged by this alone);
- how far the served logits lie from the reference's at that node, on
  ``cols`` (vocabulary entries drawn from the run's seed) and at the
  served token.

``Model`` is the configuration family's plain reference (its family
module's ``Model``, `ttbench.families`); this module imports none.

The program's side is what its timed path produced: its tokens, and the
rows of the served node's logits the harness read back from the step.
With ``control=True`` the reference computed on TF32-rounded operands
takes the program's place at the same positions, fed the same prompts
and tokens: its first choice and its logits at the node the reference
serves are judged by the same function.

A configuration may state a routing tie band (``check.routing_tie``,
``tie`` here): then, and only then, the reference is handed a `Pick` at
each decoded token.  Where its own top-k boundary lies within the band
(`ttbench.reference.ties`), a MoE family computes a branch for each
expert set the program could have rounded its way to, and the `Pick`
keeps the branch whose gap against the program's row is least (the
reference's own on equal gaps); that gap is the one recorded.  The
prompt's rows and the calibration follow the reference's own routing.
With ``control=True`` the control's row takes the program's place in the
`Pick`: the control decodes the token, with its own routing, through as
many segments as the deepest branch probes, so it has a row at every
branch's served node; where the branches' depths differ it does so on a
copy of its cache, and then decodes the token again on its own cache
through the kept branch's segments, so its cache holds what the kept
branch's walk wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from ttbench.reference.tables import calibrate
from ttbench.reference.ties import MAX_BRANCHES

__all__ = ["tables_of", "served_gap", "Pick"]


def _f32_only() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tables_of(Model, m, params, calib_tokens: np.ndarray, lam: float,
              k: int, block: int = 32):
    """The reference's own calibration: node losses of the calibration
    prompts, in blocks of ``block`` prompts, then the tables."""
    _f32_only()
    model = Model(m, params, chunk=1)
    dev = model.device
    out = []
    with torch.no_grad():
        for i in range(0, len(calib_tokens), block):
            toks = torch.as_tensor(calib_tokens[i:i + block], device=dev)
            out.append(model.node_losses(toks).cpu().numpy())
    return calibrate(np.concatenate(out), lam, k)


def _clone(tree):
    """A copy of a reference's cache: its tensors cloned, its lists,
    tuples and dicts rebuilt, anything else shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _gap(want, tok, row, top, cols) -> float:
    """The served logit gap of one position: ``want`` the reference's
    logits at its served node; ``tok``, ``row`` (on ``cols``) and ``top``
    what the judged side served there."""
    return float(torch.stack([want.max() - want[tok],
                              (top - want[tok]).abs(),
                              (row - want[cols]).abs().max()]).max())


class _Served:
    """The program's side at one decoded position: what it served there,
    whichever branch it is held against."""

    def __init__(self, tok, row, top):
        self.seen = (tok, row, top)

    def read(self, branches) -> list:
        return [self.seen] * len(branches)

    def keep(self, j: int, branches) -> None:
        pass


class _Controlled:
    """The control's side at one decoded position (``at``: the token,
    its position, the strategy and the tables): it decodes through the
    deepest branch's segments and serves, at each branch's node, its own
    first choice; `keep` leaves its cache as the kept branch's walk
    would."""

    def __init__(self, ctl, kvc, at, cols):
        self.ctl, self.kvc, self.at, self.cols = ctl, kvc, at, cols
        self.redo = False

    def read(self, branches) -> list:
        tok, pos, strategy, tables = self.at
        depths = [b[2] for b in branches]
        self.redo = min(depths) != max(depths)
        kvc = _clone(self.kvc) if self.redo else self.kvc
        _, lc, _ = self.ctl.decode(tok, pos, kvc, strategy, tables,
                                   depth=max(depths))
        out = []
        for served, _, _ in branches:
            row = lc[served]
            out.append((int(row.argmax()), row[self.cols], row.max()))
        return out

    def keep(self, j: int, branches) -> None:
        if self.redo:
            tok, pos, strategy, tables = self.at
            self.ctl.decode(tok, pos, self.kvc, strategy, tables,
                            depth=branches[j][2])


class Pick:
    """What a family's ``Model.decode`` is handed under a routing tie
    band: ``tau`` (router-logit units) and ``max_branches``; called with
    the token's branches (``(served node, {node: logits}, depth)``, the
    reference's own first), it returns the index of the branch whose gap
    against the judged side's row is least, the first on equal gaps, and
    keeps that gap in ``gap``."""

    def __init__(self, tau: float, side, cols):
        self.tau, self.max_branches = float(tau), MAX_BRANCHES
        self.side, self.cols = side, cols
        self.gap = None

    def __call__(self, branches) -> int:
        seen = self.side.read(branches)
        gaps = [_gap(logits[served], *s, self.cols)
                for (served, logits, _), s in zip(branches, seen)]
        j = min(range(len(gaps)), key=lambda i: (gaps[i], i))
        self.side.keep(j, branches)
        self.gap = gaps[j]
        return j


def served_gap(Model, m, params, chunk: int, tables, sample, cols,
               control: bool = False, tie: float | None = None) -> dict:
    """The widest served logit gap over ``sample``.  Each entry has
    ``prompt`` (int ids), ``first`` (the first token, fed but not
    emitted), ``tokens`` (the emitted tokens), ``strategy``, and for
    the program ``rows`` ((tokens, len(cols)) served logits on
    ``cols``), ``top`` (each served row's largest logit) and ``nodes``
    (the served nodes).  With ``tie`` (the configuration's routing tie
    band) the reference follows the judged side's expert choice where
    its own top-k ties within it; ``ties``, ``followed`` and ``capped``
    are the reference's counts of that (`ttbench.families`)."""
    _f32_only()
    ref = Model(m, params, chunk)
    ctl = Model(m, params, chunk, control=True) if control else None
    dev = ref.device
    cols_t = torch.as_tensor(np.asarray(cols), device=dev).long()
    worst, n, nodes, other_node = 0.0, 0, [], 0
    with torch.no_grad():
        for req in sample:
            prompt = torch.as_tensor(np.asarray(req["prompt"]), device=dev)
            toks = [int(t) for t in req["tokens"]]
            x, kv = ref.prompt(prompt, room=len(toks))
            head = ref.readout(m.n_nodes - 1, x[-1])
            if control:
                xc, kvc = ctl.prompt(prompt, room=len(toks))
                first = int(ctl.readout(m.n_nodes - 1, xc[-1]).argmax())
            else:
                first = int(req["first"])
                rows = torch.as_tensor(np.asarray(req["rows"]), device=dev)
                tops = torch.as_tensor(np.asarray(req["top"]), device=dev)
            worst = max(worst, float(head.max() - head[first]))
            n += 1
            feed = [int(req["first"])] + toks[:-1]
            lp = prompt.shape[0]
            for i, inp in enumerate(feed):
                at = (inp, lp + i, req["strategy"], tables)
                side = (_Controlled(ctl, kvc, at, cols_t) if control else
                        _Served(toks[i], rows[i], tops[i]))
                pick = None if tie is None else Pick(tie, side, cols_t)
                served, logits, depth = ref.decode(
                    inp, lp + i, kv, req["strategy"], tables, pick=pick)
                if pick is not None and pick.gap is not None:
                    gap = pick.gap
                else:           # a family that routes nothing never picks
                    seen = side.read([(served, logits, depth)])[0]
                    gap = _gap(logits[served], *seen, cols_t)
                if not control:
                    other_node += int(req["nodes"][i]) != served
                worst = max(worst, gap)
                nodes.append(served)
                n += 1
    return {"served_gap": worst, "tokens": n, "other_node": other_node,
            "nodes": np.bincount(nodes, minlength=m.n_nodes).tolist(),
            "ties": ref.ties, "followed": ref.followed,
            "capped": ref.capped}
