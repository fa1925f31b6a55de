"""Mamba2 (SSD, state-space duality) mixer: the chunked scan for a
whole-prompt prefill and the O(1)-state recurrence for decode.

Chunked SSD (arXiv:2405.21060 §6): the sequence is split into chunks of
Q tokens.  Within a chunk the output is a masked attention-like
quadratic form (the "dual" form), which ``ssd_chunked(use_kernel=True)``
sends through the ``ssd_chunk`` kernel together with each chunk's end
state; the chunk-boundary states are carried by a linear recurrence, a
Python loop over the chunks (the JAX package's ``lax.scan``).  Decode
carries a ``conv`` window (the last ``d_conv - 1`` pre-conv rows, bf16)
and an ``ssm`` state (f32) per lane.

Layout as in the JAX package: ``xh (B, S, H, P)``, ``dt (B, S, H)``,
``bb``/``cc (B, S, H, N)``.  With one group the port hands ``bb``/``cc``
to the chunk as a stride-0 ``expand`` over H, where the JAX package
repeats them (same numbers, no copy).  Prefix sums of the decay go
through `kernels.prefix_sum` (f64 accumulation, f32 result), so the
CPU and the card see the same segment sums.  The causal conv is
written as ``d_conv`` shifted multiply-adds, so no convolution library
(and no TF32 convolution) is involved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import prefix_sum, ssd_chunk
from repro_torch.models.common import rms_norm
from repro_torch.models.config import SSMConfig
from repro_torch.sharding.ctx import (dtensor_mesh, local_shard,
                                     reduce_partial, split_heads)
from repro_torch.models.param import ParamDef

__all__ = ["ssm_defs", "ssm_forward", "ssm_decode", "ssm_state_defs",
           "ssd_chunked"]


def _dims(cfg: SSMConfig, d_model: int):
    di = cfg.d_inner(d_model)
    h = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    conv_dim = di + 2 * gn
    return di, h, gn, conv_dim


def ssm_defs(cfg: SSMConfig, d_model: int) -> dict:
    di, h, gn, conv_dim = _dims(cfg, d_model)
    return {
        "in_proj": ParamDef((d_model, 2 * di + 2 * gn + h),
                            ("embed", "heads")),
        "conv_w": ParamDef((cfg.d_conv, conv_dim), (None, "heads"),
                           init="normal", scale=0.1),
        "conv_b": ParamDef((conv_dim,), ("heads",), init="zeros"),
        "a_log": ParamDef((h,), ("heads",), init="ones"),
        "d_skip": ParamDef((h,), ("heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("heads",), init="zeros"),
        "norm": ParamDef((di,), ("heads",), init="ones"),
        "out_proj": ParamDef((di, d_model), ("heads", "embed")),
    }


def ssm_state_defs(cfg: SSMConfig, d_model: int, batch: int) -> dict:
    """(shape, dtype) spec of one layer's decode state."""
    di, h, gn, conv_dim = _dims(cfg, d_model)
    return {
        "conv": ((batch, cfg.d_conv - 1, conv_dim), torch.bfloat16),
        "ssm": ((batch, h, cfg.head_dim, cfg.d_state), torch.float32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then SiLU.  x (B,S,C), w (K,C),
    b (C): out[t] = sum_k x[t + k - (K-1)] * w[k].  A DTensor x whose
    seq dim is whole convolves each device's own rows and channels
    (`_conv_shard`)."""
    if dtensor_mesh(x) is not None:
        return _conv_shard(x, w, b)
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b)


def _conv_shard(x, w, b):
    """`_causal_conv` of a DTensor x on its local tensor: the conv mixes
    no channels, so a device needs the weights of its own channels only
    (w and b are redistributed to x's channel placements) and, its seq
    dim whole, no other device's rows; the result keeps x's
    placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    x = reduce_partial(x)
    if any(p.is_shard(1) for p in x.placements):
        x = x.redistribute(mesh, tuple(Replicate() if p.is_shard(1) else p
                                       for p in x.placements))
    chan = [Shard(1) if p.is_shard(2) else Replicate() for p in x.placements]
    wl = local_shard(w, mesh, chan)
    bl = local_shard(b, mesh, [Shard(0) if p.is_shard(1) else Replicate()
                               for p in chan])
    out = _causal_conv(x.to_local(), wl, bl)
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum_{t=j+1..i} a_t for i >= j, -inf otherwise."""
    q = a.shape[-1]
    cs = prefix_sum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(xh, dt, a, bb, cc, chunk: int, *, use_kernel: bool = False,
                q_valid: int | None = None):
    """Chunked SSD core.

    Args:
      xh: (B, S, H, P) inputs per head.
      dt: (B, S, H) positive step sizes (already softplus'ed).
      a:  (H,) negative state decay rates.
      bb: (B, S, H, N) input projections (groups already broadcast).
      cc: (B, S, H, N) output projections.
      chunk: chunk length Q (S % Q == 0 after padding by the caller).
      use_kernel: the within-chunk part through `kernels.ssd_chunk`
        (its plain version on CPU tensors); off, the einsum path of the
        JAX package's own ``ssd_chunked``, kept apart from the kernel's
        plain version so that it witnesses the kernel on the card.
      q_valid: rows of the last chunk that are not padding (None: all);
        the rows after them must have x = B = C = dt = 0, and the kernel
        route skips them (`kernels.ssd_chunk`).  The einsum path
        computes them (they add exactly nothing).

    Returns: y (B, S, H, P), final_state (B, H, P, N).
    """
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    q = chunk
    nc = s // q

    def r(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    xh_, dt_, bb_, cc_ = r(xh), r(dt), r(bb), r(cc)
    da = dt_ * a[None, None, None, :]                    # (B,nc,Q,H)

    if use_kernel:
        y_diag, states = ssd_chunk(xh_, dt_, da, bb_, cc_, q_valid=q_valid)
    else:
        seg = _segsum(da.transpose(-1, -2))              # (B,nc,H,Q,Q)
        l = torch.exp(seg)
        scores = torch.einsum("bcqhn,bckhn->bchqk", cc_, bb_)
        m = scores * l * dt_.transpose(-1, -2)[..., None, :]
        y_diag = torch.einsum("bchqk,bckhp->bcqhp", m, xh_)
        # chunk states: sum_j exp(sum_{t>j} da) dt_j B_j x_j^T
        cum = prefix_sum(da, 2)
        w = torch.exp(cum[:, :, -1:, :] - cum) * dt_      # (B,nc,Q,H)
        states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bb_, xh_)

    # inter-chunk recurrence, emitting each chunk's PREVIOUS state
    cum = prefix_sum(da, 2)                              # (B,nc,Q,H)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nc,H)
    carry = torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    inner_decay = torch.exp(cum)                         # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc_, prev_states,
                         inner_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def _heads(t: torch.Tensor, cfg: SSMConfig, h: int) -> torch.Tensor:
    """(..., G*N) group projections -> (..., H, N), head j reading group
    j // (H/G); a stride-0 view when there is one group."""
    g, n = cfg.n_groups, cfg.d_state
    t = split_heads(t, g, n)[..., None, :]
    t = t.expand(*t.shape[:-2], h // g, n)
    return t.reshape(*t.shape[:-3], h, n)


def ssm_forward(p: dict, x: torch.Tensor, cfg: SSMConfig,
                eps: float = 1e-5, use_kernel: bool = False):
    """Full-sequence SSD pass.  Returns (y, {"conv", "ssm"}): the decode
    state after the last position."""
    b, s, d = x.shape
    di, h, gn, conv_dim = _dims(cfg, d)
    proj = x @ p["in_proj"]
    z, xbc_pre, dt = torch.split(proj, [di, di + 2 * gn, h], dim=-1)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"].float()).to(x.dtype)

    # pad S to a multiple of the chunk after the softplus: padded rows
    # have x = B = C = 0 and dt = 0, so they add nothing, decay nothing
    # (the kernel route skips them: q_valid = chunk - pad)
    pad = (-s) % cfg.chunk
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    sp = s + pad
    xs, bb, cc = torch.split(xbc, [di, gn, gn], dim=-1)
    xh = split_heads(xs, h, cfg.head_dim)
    y, final = ssd_chunked(xh, dt, a, _heads(bb, cfg, h), _heads(cc, cfg, h),
                           cfg.chunk, use_kernel=use_kernel,
                           q_valid=cfg.chunk - pad if pad else None)
    y = y[:, :s] + xh[:, :s] * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di)
    y = rms_norm({"scale": p["norm"]}, y * F.silu(z), eps)
    out = y @ p["out_proj"]
    # decode conv state = the last d_conv-1 PRE-conv rows, left-padded
    kc = cfg.d_conv - 1
    tail = xbc_pre[:, -kc:, :]
    if tail.shape[1] < kc:
        tail = F.pad(tail, (0, 0, kc - tail.shape[1], 0))
    return out, {"conv": tail.to(torch.bfloat16),
                 "ssm": final.to(torch.float32)}


def ssm_decode(p: dict, x: torch.Tensor, state: dict, cfg: SSMConfig,
               eps: float = 1e-5):
    """Single-token recurrent step.  x (B,1,D); state {"conv", "ssm"}.
    Returns (y (B,1,D), new state) — new tensors; the caller decides
    which lanes' state to keep."""
    b, _, d = x.shape
    di, h, gn, conv_dim = _dims(cfg, d)
    proj = x[:, 0] @ p["in_proj"]                        # (B, ...)
    z, xbc, dt = torch.split(proj, [di, di + 2 * gn, h], dim=-1)
    # conv over the stored window + the current token
    win = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None, :]],
                    dim=1)                               # (B, d_conv, C)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv_out)
    new_conv = win[:, 1:, :].to(torch.bfloat16)

    xs, bb, cc = torch.split(xbc, [di, gn, gn], dim=-1)
    xh = xs.reshape(b, h, cfg.head_dim)
    bb, cc = _heads(bb, cfg, h), _heads(cc, cfg, h)      # (B,H,N)
    dt = F.softplus(dt + p["dt_bias"])                   # (B,H)
    a = -torch.exp(p["a_log"].float())

    ssm = state["ssm"]                                   # (B,H,P,N) f32
    decay = torch.exp(dt.float() * a[None, :])           # (B,H)
    upd = (dt.float()[..., None, None] * xh.float()[..., :, None]
           * bb.float()[..., None, :])                   # (B,H,P,N)
    new_ssm = ssm * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, cc.float()).to(x.dtype)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, di)
    y = rms_norm({"scale": p["norm"]}, y * F.silu(z[:, None, :]), eps)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": new_ssm}
