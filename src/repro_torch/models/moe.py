"""Mixture-of-Experts layer: top-k routing with grouped, capacity-bounded,
sort-based dispatch; shared experts (DeepSeek-V2); the load-balance and
router-z aux losses.

Tokens are routed within groups: one group per sequence for a
full-sequence pass, one group of all lanes for decode (S == 1), as the
JAX package routes them.  Per group:

  router -> top-k -> stable sort by expert -> position within the
  expert -> capacity drop -> (E, G, C) token-id buffer -> gather
  (E, G*C, D) -> per-expert batched products -> weighted combine.

Ties in the router's top-k go to the lower expert id (a stable
descending sort), as ``jax.lax.top_k`` breaks them.  The combine sums a
token's k expert outputs in ascending buffer order (expert id, then
position), the order the JAX package's scatter-add adds them, with no
float atomics, so runs on the card repeat bit for bit.  A dropped
assignment adds nothing; a pad row of a chunk sits after the chunk's
real rows, so the stable sort drops it first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.mlp import mlp_defs, mlp_forward
from repro_torch.models.param import ParamDef
from repro_torch.sharding.ctx import constrain_batch

__all__ = ["moe_defs", "moe_forward", "route", "capacity"]


def moe_defs(cfg: MoEConfig, d_model: int, act: str) -> dict:
    e, f = cfg.num_experts, cfg.d_ff_expert
    defs = {
        "router": ParamDef((d_model, e), ("embed", None), scale=0.1),
        "w_up": ParamDef((e, d_model, f), ("experts", "embed", "mlp"),
                         fan_axis=1),
        "w_down": ParamDef((e, f, d_model), ("experts", "mlp", "embed"),
                           fan_axis=1),
    }
    if act == "swiglu":
        defs["w_gate"] = ParamDef((e, d_model, f),
                                  ("experts", "embed", "mlp"), fan_axis=1)
    if cfg.num_shared > 0:
        shared_ff = cfg.d_ff_shared or cfg.num_shared * f
        defs["shared"] = mlp_defs(d_model, shared_ff, act)
    return defs


def _group_shape(b: int, s: int) -> tuple[int, int]:
    """One routing group per sequence; a single group for decode."""
    if s == 1:
        return 1, b
    return b, s


def capacity(cfg: MoEConfig, ng: int) -> int:
    """Slots an expert has in a group of ``ng`` tokens (the JAX package's
    formula, computed in Python as it computes it)."""
    return max(8, min(int(cfg.capacity_factor * cfg.top_k * ng
                          / cfg.num_experts), ng * cfg.top_k))


def route(p: dict, xg: torch.Tensor, cfg: MoEConfig):
    """The router of grouped tokens xg (G, Ng, D): (logits, probs) in
    f32 (G, Ng, E) and the top-k (gate values renormalised over the k,
    expert ids), each (G, Ng, k), best first."""
    logits = (xg @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, assign = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gate_vals, assign = gate_vals[..., :cfg.top_k], assign[..., :cfg.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, assign


def _act(up, gate, act: str):
    """`mlp.mlp_forward`'s activation, on operands the caller frees next
    (the dense MLP keeps its gate projection a temporary instead)."""
    if act == "swiglu":
        return F.silu(gate) * up
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(up, approximate="tanh")


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
                with_aux: bool = True):
    """x: (B, S, D) -> (y, aux).  ``aux`` holds the weighted
    ``moe_load_balance`` and ``moe_router_z`` losses (0-dim tensors);
    without ``with_aux`` (the serving paths, which discard them) it is
    empty and they are not computed."""
    b, s, d = x.shape
    g, ng = _group_shape(b, s)
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, ng)
    xg = x.reshape(g, ng, d)

    logits, probs, gate_vals, assign = route(p, xg, cfg)

    # ---- grouped sort-based dispatch -------------------------------------
    flat_e = assign.reshape(g, ng * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)        # (G, Ng*k)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(e, device=x.device).expand(g, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)            # (G, E)
    rank = torch.arange(ng * k, device=x.device)[None, :]
    pos = rank - torch.gather(starts, -1, sorted_e)
    keep = pos < cap
    # expert-major buffer (E, G, C), so each expert's rows are one
    # operand of a batched product; a dropped assignment goes to the
    # extra slot E * G * C, which holds nothing
    gidx = torch.arange(g, device=x.device)[:, None]
    slot = torch.where(keep, (sorted_e * g + gidx) * cap + pos, e * g * cap)
    tok = gidx * ng + order // k                  # source row of xg's rows
    slot_gate = torch.gather(gate_vals.reshape(g, ng * k), -1, order)

    buf_tok = torch.full((e * g * cap + 1,), g * ng, dtype=torch.long,
                         device=x.device)
    buf_tok.scatter_(0, slot.reshape(-1),
                     torch.where(keep, tok, g * ng).reshape(-1))
    buf_gate = torch.zeros((e * g * cap + 1,), dtype=x.dtype,
                           device=x.device)
    buf_gate.scatter_(0, slot.reshape(-1),
                      torch.where(keep, slot_gate.to(x.dtype), 0.0)
                      .reshape(-1))
    # token row g * ng is the zero row an empty slot reads
    x_pad = torch.cat([xg.reshape(g * ng, d), xg.new_zeros((1, d))])
    xe = x_pad[buf_tok[:-1]].reshape(e, g * cap, d)
    # anchor the (G * C) buffer dim, group-major, on the batch mesh axes
    xe = constrain_batch(xe, batch_dim=1)

    # ---- per-expert batched products (the transients dropped early) -------
    up = torch.bmm(xe, p["w_up"])
    gate = torch.bmm(xe, p["w_gate"]) if act == "swiglu" else None
    del xe
    h = constrain_batch(_act(up, gate, act), batch_dim=1)
    del up, gate
    ye = torch.bmm(h, p["w_down"])                            # (E, G*C, D)
    del h
    ye = constrain_batch(ye, batch_dim=1)
    ye = ye * buf_gate[:-1].reshape(e, g * cap, 1)

    # ---- combine: each token's k outputs in ascending buffer order (expert
    # id, then position: the JAX package's scatter-add order) --------------
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    slot_of = torch.sort(slot_of.reshape(g, ng, k), dim=-1).values
    dropped = slot_of == e * g * cap
    parts = ye.reshape(e * g * cap, d)[slot_of.clamp(max=e * g * cap - 1)]
    parts.masked_fill_(dropped[..., None], 0.0)               # (G, Ng, k, D)
    del ye
    y = constrain_batch(torch.zeros_like(xg), batch_dim=0)
    for j in range(k):
        y = y + parts[:, :, j]
    y = constrain_batch(y, batch_dim=0).reshape(b, s, d)

    if cfg.num_shared > 0:
        y = y + mlp_forward(p["shared"], x, act)
    if not with_aux:
        return y, {}

    # ---- aux losses (GShard load balance + router z) ----------------------
    me = probs.mean(dim=(0, 1))                               # (E,)
    # integer counts (no host sync to size them, no float atomics)
    counts = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, assign.reshape(-1), torch.ones_like(assign.reshape(-1)))
    ce = counts.float() / (g * ng * k)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"moe_load_balance": cfg.router_aux_weight * lb,
               "moe_router_z": cfg.router_z_weight * z}
