"""Paged single-token decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
`repro.kernels.paged_attention.paged_attention_kernel`.  Both functions
here take the model layout the decode path scatters into:

  q (B, H, hd) f32 with H = G * Hkv; k/v_pages (P, ps, Hkv, hd) — the
  bf16 pool, read in place through its strides; pos_pages (P, ps) i32
  (-1 = empty slot); page_table (B, maxp) i32, garbage-page padded;
  q_pos (B,) i32.  Returns (B, H, hd) f32.

A lane visits the pages ``j < min(q_pos // ps + 1, maxp)``; a slot is
attended when its stored position is >= 0, <= q_pos and inside the
sliding window.  A lane with nothing attendable returns zeros.

`paged_attention` runs the plain version for CPU tensors and the
kernel for CUDA tensors — there is no fallback between them.  The
kernel copies pool rows in 16-byte pieces, so the pool must start on 16
bytes and have (page, slot, head) strides that are multiples of 8
elements; the wrapper raises otherwise.  For long contexts it splits a
lane's pages over several blocks (`build.split_count`) whose partial
sums the last block to finish merges, counted by integer tickets that
the wrapper allocates once per device and the kernel leaves at zero:
calls of one kernel on one device must not overlap on two streams.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["paged_attention", "paged_attention_plain", "kernel_info"]

HEAD_DIMS = (32, 64, 96, 128)      # the kernel's template instances
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 9 + [_I] * 7 + [_L] * 8 + [_F, _I, _P]


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("paged_attention").repro_paged_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def paged_attention_plain(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                          *, scale: float, window: int | None = None):
    """The kernel's contract in plain PyTorch: gather the lane's pages,
    mask, softmax in f32 (the CPU path and the card's reference)."""
    b, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    maxp = page_table.shape[1]
    table = page_table.long()
    k = k_pages[table].float().reshape(b, maxp * ps, hkv, hd)
    v = v_pages[table].float().reshape(b, maxp * ps, hkv, hd)
    kpos = pos_pages[table].reshape(b, maxp * ps)
    q_pos = q_pos.long()
    n_used = torch.clamp(torch.div(q_pos, ps, rounding_mode="floor") + 1,
                         max=maxp)
    page = torch.arange(maxp * ps, device=q.device) // ps
    valid = (kpos >= 0) & (kpos <= q_pos[:, None]) \
        & (page[None, :] < n_used[:, None])
    if window is not None:
        valid &= kpos > q_pos[:, None] - window
    logits = torch.einsum("bkgd,btkd->bkgt",
                          q.float().reshape(b, hkv, g, hd), k) * scale
    mask = valid[:, None, None, :]
    # -1e30 (not -inf) keeps all-masked lanes NaN-free; the second mask
    # turns their uniform weights into zeros
    w = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    w = w.masked_fill(~mask, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, k_pages, v_pages, pos_pages, page_table, q_pos):
    b, h, hd = q.shape
    p, ps, hkv, hd_k = k_pages.shape
    if q.dtype != torch.float32 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError("paged_attention kernel takes an f32 q and a bf16 "
                        f"pool, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    for name, t in (("pos_pages", pos_pages), ("page_table", page_table),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if hd_k != hd or v_pages.shape != k_pages.shape \
            or pos_pages.shape != (p, ps) or page_table.shape[0] != b \
            or q_pos.shape != (b,) or h % hkv or h // hkv > 32 \
            or hd not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention shapes: q {tuple(q.shape)}, pool "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, pos "
            f"{tuple(pos_pages.shape)}, table {tuple(page_table.shape)}, "
            f"q_pos {tuple(q_pos.shape)} (hd 32/64/96/128, H/Hkv <= 32)")
    if k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError("the pool's head_dim axis must be contiguous")
    if b >= 2 ** 31 or hkv > 65535:
        raise ValueError(f"paged_attention grid: B {b} must be < 2^31 and "
                         f"Hkv {hkv} <= 65535")
    devs = {t.device for t in (q, k_pages, v_pages, pos_pages, page_table,
                               q_pos)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention tensors span devices {devs}")
    build.check_rows_aligned("paged_attention", k_pages=k_pages,
                             v_pages=v_pages)


def paged_attention(q, k_pages, v_pages, pos_pages, page_table, q_pos, *,
                    scale: float, window: int | None = None):
    """Paged decode attention: plain PyTorch on the CPU, the CUDA kernel
    on the card (raises on what the kernel does not take)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, pos_pages,
                                     page_table, q_pos, scale=scale,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    build.refuse_autograd("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, pos_pages, page_table, q_pos)
    q = q.contiguous()
    page_table = page_table.contiguous()
    q_pos = q_pos.contiguous()
    b, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    s = build.split_count(b * hkv, maxp, ps, q.device)
    part = tickets = None
    if s > 1:
        part = torch.empty(b * hkv * s * (h // hkv) * (hd + 2),
                           dtype=torch.float32, device=q.device)
        tickets = build.ticket_buffer("paged_attention", b * hkv, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), page_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, h, hkv, hd, ps,
        maxp, s, *k_pages.stride()[:3], *v_pages.stride()[:3],
        *pos_pages.stride(), float(scale), int(window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    build.report_launch("paged_attention", (q, k_pages, v_pages, pos_pages,
                                            page_table, q_pos), (out,))
    return out


paged_attention.launches = 0


def kernel_info(b: int, h: int, hkv: int, hd: int, ps: int, maxp: int,
                device="cuda") -> dict:
    """The kernel's resources for a call on (b, h, hd) queries over
    (ps, hkv, hd) pages and a ``maxp``-wide table, as the CUDA runtime
    reports them: registers a thread, shared memory a block (bytes),
    blocks an SM holds, local (spill) bytes a thread; and the splits of
    a lane's pages the wrapper picks."""
    s = build.split_count(b * hkv, maxp, ps, torch.device(device))
    out = (ctypes.c_int * 4)()
    rc = build.library("paged_attention").repro_paged_attention_info(
        ctypes.c_int(hd), ctypes.c_int(h // hkv), ctypes.c_int(maxp),
        ctypes.c_int(ps), ctypes.c_int(s), out)
    if rc != 0:
        raise RuntimeError(f"paged_attention info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), out), splits=s)
