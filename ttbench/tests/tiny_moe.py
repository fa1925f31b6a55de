"""A tiny MoE configuration family for the judge's tests, found by file
like any other (copied into a test bench's ``families/``): the dense
reference with each layer's MLP replaced by routed experts, top-k over
softmax gates that are not renormalised (each chosen expert weighs in by
its own softmax probability over all experts).

Its reference routes a decoded token through
`ttbench.reference.ties.topk_candidates` and, handed a ``pick``, computes
a branch for each expert set within the band, as the family contract
says (`ttbench.families`).  No program serves it: the tests' "program"
is this reference with some of its decisions forced (`Model.route`,
`Model.gates`).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
import torch.nn.functional as F

from ttbench.lib.shapes import Dense, dense
from ttbench.reference import dense as dense_ref
from ttbench.reference.dense import bf16
from ttbench.reference.tables import walker
from ttbench.reference.ties import topk_candidates

__all__ = ["shapes", "make_weights", "program_config", "Model",
           "prompt_flops", "probe_flops"]


@dataclasses.dataclass(frozen=True)
class TinyMoe(Dense):
    n_experts: int
    top_k: int


def shapes(cfg: dict) -> TinyMoe:
    return TinyMoe(**dataclasses.asdict(dense(cfg)),
                   n_experts=cfg["n_routed_experts"],
                   top_k=cfg["num_experts_per_tok"])


def make_weights(m: TinyMoe, seed: int, device) -> dict:
    """The dense weights, each layer's MLP replaced by a router (d, E)
    and experts ``w_up`` (E, d, d_ff), ``w_down`` (E, d_ff, d), drawn
    from ``seed`` on ``device`` (1/sqrt(fan-in))."""
    params = dense_ref.make_weights(m, seed, device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    e, d, f = m.n_experts, m.d, m.d_ff
    for si, nl in enumerate(m.seg_layers):
        def draw(*shape, fan):
            return torch.randn((nl,) + shape, generator=gen,
                               device=device) / math.sqrt(fan)
        params["segments"][si]["blocks"]["mlp"] = {
            "router": draw(d, e, fan=d), "w_up": draw(e, d, f, fan=d),
            "w_down": draw(e, f, d, fan=f)}
    return params


def program_config(cfg: dict):
    raise NotImplementedError("no program serves the tiny MoE family")


def prompt_flops(m, start, width, last):
    raise NotImplementedError("the tiny MoE family is judged, not timed")


def probe_flops(m, probes, ctx):
    raise NotImplementedError("the tiny MoE family is judged, not timed")


class _Branch:
    """One way a decoded token goes: its hidden row, walk, probed
    nodes' logits and new KV rows (by layer)."""

    def __init__(self, x, walk):
        self.x, self.walk, self.logits, self.rows = x, walk, {}, {}
        self.depth, self.live, self.experts = 0, True, None

    def fork(self, experts) -> "_Branch":
        child = _Branch(self.x, copy.copy(self.walk))
        child.logits, child.rows = dict(self.logits), dict(self.rows)
        child.depth, child.experts = self.depth, experts
        child.h, child.xn, child.z = self.h, self.xn, self.z
        return child


class Model(dense_ref.Model):
    """The plain reference of the tiny MoE decoder (`dense.Model`'s
    attention, norms, readouts and walk; routed experts for the MLP)."""

    def __init__(self, m, params, chunk, control=False):
        super().__init__(m, params, chunk, control=control)
        self.ties = self.followed = self.capped = 0

    # ---- routing ---------------------------------------------------------
    def route(self, si, li, pos, z, tau, max_alt):
        """The expert sets of a decoded row at position ``pos`` (router
        logits ``z`` (E,)), its own first."""
        return topk_candidates(z, self.m.top_k, tau, max_alt)

    def gates(self, z, sets):
        """(rows, E): each expert's softmax probability over all experts
        where its row's set holds it, else 0."""
        p = torch.softmax(z, dim=-1)
        mask = torch.zeros_like(p)
        for r, experts in enumerate(sets):
            mask[r, list(experts)] = 1.0
        return p * mask

    def experts(self, si, li, xn, g):
        w = self.p["segments"][si]["blocks"]["mlp"]
        out = torch.zeros_like(xn)
        for e in range(self.m.n_experts):
            h = F.gelu(self.mm(xn, w["w_up"][li, e]), approximate="tanh")
            out = out + g[:, e:e + 1] * self.mm(h, w["w_down"][li, e])
        return out

    def router(self, si, li, x):
        xn = self.rms(x, self.w(si, li, "norm2", "scale"))
        return xn, self.mm(xn, self.w(si, li, "mlp", "router"))

    def mlp(self, si, li, x):
        """Rows of a prompt (any leading shape), each by its own top-k."""
        shape = x.shape
        xn, z = self.router(si, li, x.reshape(-1, shape[-1]))
        own = torch.sort(z, dim=-1, descending=True, stable=True)[1]
        sets = own[:, :self.m.top_k].tolist()
        y = self.experts(si, li, xn, self.gates(z, sets))
        return x + y.reshape(shape)

    # ---- one decoded token -------------------------------------------------
    def decode(self, tok: int, pos: int, kv, strategy, tables,
               depth: int | None = None, pick=None):
        m = self.m
        # past the cap a token's further sets are only counted: one more
        # than fits is asked for, to see that some were left out
        tau = 0.0 if pick is None else pick.tau
        cap = 1 if pick is None else pick.max_branches
        asked = 0 if pick is None else cap
        p = torch.tensor([pos], device=self.device)
        branches = [_Branch(self.p["embed"]["table"][tok][None, :],
                            walker(strategy, tables, m.n_nodes))]
        capped, layer = False, 0
        for si, nl in enumerate(m.seg_layers):
            if depth is not None and si >= depth:
                break
            for li in range(nl):
                kbuf, vbuf, n = kv[layer]
                ok = torch.ones((1, n + 1), dtype=torch.bool,
                                device=self.device)
                alts = []
                for bi, b in enumerate(branches):
                    if not b.live:
                        continue
                    q, k, v = self.qkv(si, li, b.x, p)
                    kb, vb = bf16(k), bf16(v)
                    b.rows[layer] = (kb[0], vb[0])
                    a = self.attend(q, [torch.cat([kbuf[:n], kb])],
                                    [torch.cat([vbuf[:n], vb])], [ok])
                    b.h = b.x + self.mm(a, self.w(si, li, "attn", "wo"))
                    b.xn, b.z = self.router(si, li, b.h)
                    cands = self.route(si, li, pos, b.z[0], tau, asked)
                    b.experts = cands[0].experts
                    alts += [(c.margin, bi, c.experts) for c in cands[1:]]
                alts.sort(key=lambda a: a[0])
                room = cap - len(branches)
                capped |= len(alts) > room
                branches += [branches[bi].fork(experts)
                             for _, bi, experts in alts[:max(room, 0)]]
                for b in branches:
                    if b.live:
                        b.x = b.h + self.experts(
                            si, li, b.xn, self.gates(b.z, [b.experts]))
                layer += 1
            for b in branches:
                if not b.live:
                    continue
                b.depth += 1
                b.logits[si] = self.readout(si, b.x)[0]
                go = b.walk.observe(si, float(self.ell(b.logits[si])))
                if depth is None and not go:
                    b.live = False
        kept = 0
        if pick is not None:
            kept = pick([(b.walk.serve(), b.logits, b.depth)
                         for b in branches])
            self.ties += len(branches) > 1
            self.followed += kept != 0
            self.capped += capped
        b = branches[kept]
        for at, (kb, vb) in b.rows.items():
            n = kv[at][2]
            kv[at][0][n], kv[at][1][n] = kb, vb
            kv[at][2] = n + 1
        return b.walk.serve(), b.logits, b.depth
