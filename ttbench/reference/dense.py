"""Plain reference of the dense early-exit decoder (GPT-2 / Granite
style: pre-norm RMSNorm blocks, rotary GQA attention, a GELU or SwiGLU
MLP, a ramp readout after every segment but the last and the head after
the last, tied unembedding), in float32 with TF32 off.

It reads the benchmark's weights by the layout of `make_weights` and
holds the serve's stated numerics: keys and values are stored in
bfloat16 (the KV pool's type) and read back from it, except that the
rows of one prefill chunk see each other's keys and values in float32,
as a chunk computes them before it writes them.  A token that exited
early never wrote the deeper layers' keys, so a later token's deeper
layers do not see it.

``control=True`` computes every matrix product on operands rounded to
TF32 (10 mantissa bits, round to nearest even): the next precision below
the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ttbench.lib.shapes import Dense
from ttbench.reference.tables import walker

__all__ = ["make_weights", "Model", "tf32_round", "bf16"]

_QUERY_BLOCK = 512      # prompt rows attended at once (memory only)


def make_weights(m: Dense, seed: int, device) -> dict:
    """The benchmark's weights of configuration ``m`` from ``seed``: one
    normal draw on ``device`` for all of them (a ``torch.Generator`` on
    that device), cut into leaves and scaled (1/sqrt(fan-in); the
    embedding 0.02); norm scales 1.  The layout is the program's
    parameter tree: layers stacked per segment."""
    d, hq, hk = m.d, m.heads * m.head_dim, m.kv_heads * m.head_dim
    mlp = {"w_up": (d, m.d_ff), "w_down": (m.d_ff, d)}
    if m.act == "swiglu":
        mlp["w_gate"] = (d, m.d_ff)
    attn = {"wq": (d, hq), "wk": (d, hk), "wv": (d, hk), "wo": (hq, d)}
    shapes = [("embed", (m.vocab, d))]
    for si, nl in enumerate(m.seg_layers):
        shapes += [((si, "attn", k), (nl,) + s) for k, s in attn.items()]
        shapes += [((si, "mlp", k), (nl,) + s) for k, s in mlp.items()]
    align = 64          # every leaf starts on 256 bytes
    sizes = [-(-math.prod(s) // align) * align for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    leaves, off = {}, 0
    for (key, shape), n in zip(shapes, sizes):
        t = flat[off:off + math.prod(shape)].view(shape)
        t.mul_(0.02 if key == "embed" else 1.0 / math.sqrt(shape[1]))
        leaves[key] = t
        off += n

    def ones(*shape):
        return torch.ones(shape, device=device)

    segs = []
    for si, nl in enumerate(m.seg_layers):
        blocks = {"norm1": {"scale": ones(nl, d)},
                  "attn": {k: leaves[(si, "attn", k)] for k in attn},
                  "norm2": {"scale": ones(nl, d)},
                  "mlp": {k: leaves[(si, "mlp", k)] for k in mlp}}
        seg = {"blocks": blocks}
        if si < len(m.seg_layers) - 1:
            seg["ramp"] = {"norm": {"scale": ones(d)}}
        segs.append(seg)
    return {"embed": {"table": leaves["embed"]}, "segments": segs,
            "final_norm": {"scale": ones(d)}}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -8192
    return i.view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Model:
    """The reference model over the benchmark's weights ``params``.

    ``chunk`` is the serve's prefill chunk: prompt rows are computed in
    blocks of ``chunk`` positions from 0, as the serve feeds them;
    ``device`` is the weights' device.  A dense decoder routes nothing,
    so it never branches: ``ties``, ``followed`` and ``capped`` stay 0."""

    ties = followed = capped = 0

    def __init__(self, m: Dense, params: dict, chunk: int,
                 control: bool = False):
        self.m, self.p, self.chunk, self.control = m, params, chunk, control
        self.scale = 1.0 / math.sqrt(m.head_dim)
        half = m.head_dim // 2
        dev = self.device = params["embed"]["table"].device
        exps = torch.arange(half, dtype=torch.float32, device=dev) / half
        self.freqs = 1.0 / torch.pow(torch.full((), m.rope_theta,
                                                dtype=torch.float32,
                                                device=dev), exps)
        # (segment, layer in it) of every layer, in order
        self.layers = [(si, li) for si, nl in enumerate(m.seg_layers)
                       for li in range(nl)]

    # ---- pieces -------------------------------------------------------
    def mm(self, a, b):
        if self.control:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def rms(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m.eps) * scale

    def rope(self, x, pos):
        """x (S, heads, hd), pos (S,): the half-split rotary form."""
        ang = pos.float()[:, None] * self.freqs
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    def w(self, si, li, *path):
        t = self.p["segments"][si]["blocks"]
        for k in path:
            t = t[k]
        return t[li]

    def mlp(self, si, li, x):
        xn = self.rms(x, self.w(si, li, "norm2", "scale"))
        up = self.mm(xn, self.w(si, li, "mlp", "w_up"))
        if self.m.act == "swiglu":
            h = F.silu(self.mm(xn, self.w(si, li, "mlp", "w_gate"))) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return x + self.mm(h, self.w(si, li, "mlp", "w_down"))

    def qkv(self, si, li, x, pos):
        m = self.m
        xn = self.rms(x, self.w(si, li, "norm1", "scale"))
        q = self.mm(xn, self.w(si, li, "attn", "wq")).view(
            -1, m.heads, m.head_dim)
        k = self.mm(xn, self.w(si, li, "attn", "wk")).view(
            -1, m.kv_heads, m.head_dim)
        v = self.mm(xn, self.w(si, li, "attn", "wv")).view(
            -1, m.kv_heads, m.head_dim)
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, ks, vs, masks):
        """Softmax over the union of key sets: q (S, H, hd); ks / vs
        lists of (T_i, Hkv, hd); masks of (S, T_i) (True = attend)."""
        m = self.m
        s, g = q.shape[0], m.heads // m.kv_heads
        qg = q.view(s, m.kv_heads, g, m.head_dim).permute(1, 2, 0, 3)
        qg = qg.reshape(m.kv_heads, g * s, m.head_dim)
        scores = []
        for k, mask in zip(ks, masks):
            sc = self.mm(qg, k.permute(1, 2, 0)) * self.scale
            sc = sc.view(m.kv_heads, g, s, -1)
            scores.append(sc.masked_fill(~mask, -math.inf))
        w = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
        out, off = 0.0, 0
        for v in vs:
            t = v.shape[0]
            wi = w[..., off:off + t].reshape(m.kv_heads, g * s, t)
            out = out + self.mm(wi, v.permute(1, 0, 2))
            off += t
        out = out.view(m.kv_heads, g, s, m.head_dim).permute(2, 0, 1, 3)
        return out.reshape(s, m.heads * m.head_dim)

    def readout(self, si, h):
        """Node ``si``'s logits of hidden rows ``h`` (..., d)."""
        last = si == len(self.m.seg_layers) - 1
        scale = (self.p["final_norm"]["scale"] if last else
                 self.p["segments"][si]["ramp"]["norm"]["scale"])
        return self.mm(self.rms(h, scale), self.p["embed"]["table"].T)

    @staticmethod
    def ell(logits):
        """The loss proxy 1 - max softmax."""
        return 1.0 - torch.softmax(logits, dim=-1).max(dim=-1).values

    # ---- whole prompts (calibration) ------------------------------------
    def node_losses(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) prompts -> (B, n) losses of every node at the last
        position, everything in float32 (the calibration's prefill)."""
        b, s = tokens.shape
        m = self.m
        g = m.heads // m.kv_heads
        pos = torch.arange(s, device=tokens.device)
        causal = pos[None, :] <= pos[:, None]
        x = self.p["embed"]["table"][tokens.long()]
        out = []
        for si, li in self.layers:
            q, k, v = self.qkv(si, li, x.reshape(b * s, -1), pos.repeat(b))
            q = q.view(b, s, m.kv_heads, g, m.head_dim)
            k, v = k.view(b, s, m.kv_heads, -1), v.view(b, s, m.kv_heads, -1)
            sc = torch.einsum("bskgd,btkd->bkgst", q, k) * self.scale
            w = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
            a = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, -1)
            x = x + self.mm(a, self.w(si, li, "attn", "wo"))
            x = self.mlp(si, li, x)
            if li == m.seg_layers[si] - 1:
                out.append(self.ell(self.readout(si, x[:, -1])))
        return torch.stack(out, dim=1)

    # ---- one request as the serve feeds it ------------------------------
    def prompt(self, prompt: torch.Tensor, room: int):
        """The prompt through every layer in chunks: returns the final
        hidden rows (S, d) and per layer the bf16 keys and values kept,
        in buffers with ``room`` more rows, and their fill."""
        m, c = self.m, self.chunk
        s = prompt.shape[0]
        dev = prompt.device
        pos = torch.arange(s, device=dev)
        x = self.p["embed"]["table"][prompt.long()]
        blk = torch.div(pos, c, rounding_mode="floor")
        causal = pos[None, :] <= pos[:, None]
        same = (blk[None, :] == blk[:, None]) & causal
        older = (blk[None, :] < blk[:, None])
        kv = []
        for si, li in self.layers:
            q, k, v = self.qkv(si, li, x, pos)
            kb, vb = bf16(k), bf16(v)
            rows = []
            for q0 in range(0, s, _QUERY_BLOCK):
                q1 = min(s, q0 + _QUERY_BLOCK)
                rows.append(self.attend(
                    q[q0:q1], [k[:q1], kb[:q1]], [v[:q1], vb[:q1]],
                    [same[q0:q1, :q1], older[q0:q1, :q1]]))
            a = torch.cat(rows)
            x = x + self.mm(a, self.w(si, li, "attn", "wo"))
            x = self.mlp(si, li, x)
            kbuf = torch.empty((s + room, m.kv_heads, m.head_dim),
                               device=dev)
            vbuf = torch.empty_like(kbuf)
            kbuf[:s], vbuf[:s] = kb, vb
            kv.append([kbuf, vbuf, s])
        return x, kv

    def decode(self, tok: int, pos: int, kv, strategy, tables,
               depth: int | None = None, pick=None):
        """One token through the segments its walk probes (``depth``
        segments when given, else as the walk decides); each probed
        layer appends its bf16 key and value.  Returns (the walk's
        served node, every probed node's logits, probed segments).
        ``pick`` is taken and never called: there is no routing to
        tie."""
        m = self.m
        dev = self.p["embed"]["table"].device
        x = self.p["embed"]["table"][tok][None, :]
        p = torch.tensor([pos], device=dev)
        walk = walker(strategy, tables, m.n_nodes)
        logits, li_all = {}, 0
        probed = 0
        for si, nl in enumerate(m.seg_layers):
            if depth is not None and si >= depth:
                break
            for li in range(nl):
                q, k, v = self.qkv(si, li, x, p)
                kbuf, vbuf, n = kv[li_all + li]
                kbuf[n], vbuf[n] = bf16(k[0]), bf16(v[0])
                kv[li_all + li][2] = n + 1
                ok = torch.ones((1, n + 1), dtype=torch.bool, device=dev)
                a = self.attend(q, [kbuf[:n + 1]], [vbuf[:n + 1]], [ok])
                x = x + self.mm(a, self.w(si, li, "attn", "wo"))
                x = self.mlp(si, li, x)
            li_all += nl
            probed += 1
            logits[si] = self.readout(si, x)[0]
            go = walk.observe(si, float(self.ell(logits[si])))
            if depth is None and not go:
                break
        return walk.serve(), logits, probed
