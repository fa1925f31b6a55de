"""Dense MLPs (SwiGLU / GeLU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef

__all__ = ["mlp_defs", "mlp_forward"]


def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    defs = {
        "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }
    if act == "swiglu":
        defs["w_gate"] = ParamDef((d_model, d_ff), ("embed", "mlp"))
    return defs


def mlp_forward(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation: match it
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p["w_down"]
