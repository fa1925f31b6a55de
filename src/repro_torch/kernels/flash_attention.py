"""Causal GQA flash attention (forward): the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
`repro.kernels.flash_attention.flash_attention_kernel`.  Both functions
here take the model layout `models.attention.attn_forward` computes:

  q (B, S, H, hd) f32 with H = G * Hkv; k/v (B, S, Hkv, hd) f32; query
  head h reads kv head h // G.  Key t is visible to row s when t <= s
  and, with a sliding ``window``, t > s - window.  Returns (B, S, H, hd)
  f32.

Unlike the TPU wrapper (``repro.kernels.ops.flash_attention``), nothing
is transposed or padded: the kernel reads q, k and v in place through
their strides and masks the ragged tail of S itself.  It copies rows in
16-byte pieces, so each of q, k and v must start on 16 bytes and have
(batch, seq, head) strides that are multiples of 4 elements (a stride
of an axis of length 1 is never used); the wrapper raises otherwise
and never copies to make them so.

`flash_attention` runs the plain version for CPU tensors and the kernel
for CUDA tensors — there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "kernel_info"]

HEAD_DIMS = (24, 32, 48, 64, 96, 128)   # the kernel's template instances

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _I, _P]


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("flash_attention").repro_flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int | None = None):
    """The kernel's contract in plain PyTorch: f32 logits, masked scores
    at -1e30 and masked probabilities at 0, as the TPU kernel does (the
    CPU path and the card's reference)."""
    if not causal:
        raise ValueError("only causal attention is exposed")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.float().reshape(b, s, hkv, g, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    w = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    w = w.masked_fill(~mask, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _check(q, k, v):
    b, s, h, hd = q.shape
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention kernel takes f32 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, hd) or v.shape != k.shape or hkv == 0 \
            or h % hkv or hd not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention shapes: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} (hd in {HEAD_DIMS}, "
            "H a multiple of Hkv)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention tensors span devices {devs}")
    build.check_rows_aligned("flash_attention", q=q, k=k, v=v)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: int | None = None):
    """Causal flash attention: plain PyTorch on the CPU, the CUDA kernel
    on the card (raises on what the kernel does not take)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    build.refuse_autograd("flash_attention", q, k, v)
    if not causal:
        raise ValueError("only causal attention is exposed")
    _check(q, k, v)
    b, s, h, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    build.report_launch("flash_attention", (q, k, v), (out,))
    return out


flash_attention.launches = 0


def kernel_info(hd: int, s: int) -> dict:
    """The kernel's resources at head dim ``hd`` and length ``s``, as the
    CUDA runtime reports them: registers a thread, shared memory a block
    (bytes), blocks an SM holds, local (spill) bytes a thread."""
    out = (ctypes.c_int * 4)()
    rc = build.library("flash_attention").repro_flash_attention_info(
        ctypes.c_int(hd), ctypes.c_int(s), out)
    if rc != 0:
        raise RuntimeError(f"flash_attention info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), out))
