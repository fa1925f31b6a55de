"""int8 KV cache: K/V (or MLA's ``c_kv`` latent and rope key) stored as
int8 with one bf16 scale per (position, head) row, which halves the
bytes a decode reads from the cache.  Rows are dequantized where the
attention reads them.

Switched on by the `cache_int8` context, read when a cache layout is
made (`attention.init_cache_defs`, `blocks.build_ring_cache`); the
attention paths then choose their int8 branch from the layout itself
(the ``"k_s"`` / ``"c_kv_s"`` leaves), as the JAX package does.  The
arithmetic is the JAX package's: amax in f32, ``scale = max(amax /
127, 1e-8)``, the f32 quotient rounded half to even and clipped to
±127.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["cache_int8", "int8_enabled", "quantize_rows", "dequantize_rows"]

_INT8 = contextvars.ContextVar("repro_torch_cache_int8", default=False)


@contextlib.contextmanager
def cache_int8(on: bool = True):
    """Make the cache layouts built inside the block int8 (``on``)."""
    tok = _INT8.set(on)
    try:
        yield
    finally:
        _INT8.reset(tok)


def int8_enabled() -> bool:
    return _INT8.get()


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the LAST axis: x (..., d) -> (q (..., d)
    int8, scale (...) bf16)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """int8 rows times their scales, in ``dtype`` (bf16 by default)."""
    return (q.float() * scale.float()[..., None]).to(dtype)
