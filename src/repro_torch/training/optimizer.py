"""AdamW with decoupled weight decay and global-norm clipping, over the
port's nested-dict parameter trees (the JAX package's
``training/optimizer.py``).

The update runs in place under ``torch.no_grad()``: the f32 moments
``mu`` / ``nu`` and the parameters are overwritten, and ``step`` (a
0-dim int32 tensor on the parameters' device) is incremented, so a step
makes no host sync.  The learning rate and the bias corrections are
computed on the device from the incremented step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.param import tree_leaves as leaves

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "cosine_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to a tenth of it
    at ``total_steps``.  ``step`` is a tensor; the result is f32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init_opt_state(params) -> dict:
    """Zero f32 moments shaped like ``params`` and step 0."""
    device = leaves(params)[0].device
    return {"mu": _zeros_like(params), "nu": _zeros_like(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: list) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads])))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place.  ``grads`` has the structure of
    ``params``.  Weight decay applies to leaves of two or more dims
    only.  Returns (params, state, {"grad_norm", "lr"}) — the same
    params and state objects, updated."""
    state["step"].add_(1)
    step = state["step"]
    flat_g = leaves(grads)
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    sf = step.float()
    b1c = 1 - cfg.b1 ** sf
    b2c = 1 - cfg.b2 ** sf
    for p, g, mu, nu in zip(leaves(params), flat_g, leaves(state["mu"]),
                            leaves(state["nu"])):
        g32 = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g32)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g32 * g32)
        upd = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p32 = p.float()
        if p.dim() >= 2:
            upd = upd + cfg.weight_decay * p32
        p.copy_(p32 - lr * upd)
    return params, state, {"grad_norm": gnorm, "lr": lr}
