"""Chunked-prefill attention over the paged KV pool: the CUDA kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/paged_prefill.cu``) replaces the Pallas TPU kernel
`repro.kernels.paged_prefill.paged_prefill_kernel`.  Both functions
here take the model layout:

  q (B, C, H, hd) f32 chunk queries with H = G * Hkv; k/v_pages
  (P, ps, Hkv, hd) — the bf16 pool, read in place through its strides;
  pos_pages (P, ps) i32; page_table (B, maxp) i32; q_pos (B, C) i32
  (-1 = padded row); chunk_start (B,) i32; ck/cv (B, C, Hkv, hd) f32,
  the chunk's own in-flight keys/values, at positions c_pos (B, C) i32.
  Returns (B, C, H, hd) f32.

Each row attends to the lane's page history clipped to
``0 <= kpos < chunk_start`` (pages ``j < clip(ceil(start / ps), 0,
maxp)``) and to the in-flight keys causally; a sliding window applies
to both, and rows at position -1 return zeros.

`paged_prefill` runs the plain version for CPU tensors and the kernel
for CUDA tensors — there is no fallback between them.  The kernel
copies rows in 16-byte pieces: q, ck and cv must start on 16 bytes (the
wrapper makes them contiguous, and raises on a contiguous view off 16
bytes) and the pool as `paged_attention` takes it.  A block takes 16
rows (c, g) of a (lane, kv head), so the grid has B * Hkv * ceil(C * G /
16) blocks, at most 2^31 - 1; long histories split over blocks as in
`paged_attention` (same tickets, same rule for streams).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["paged_prefill", "paged_prefill_plain", "kernel_info"]

HEAD_DIMS = (32, 64, 96, 128)      # the kernel's template instances
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 8 + [_L] * 8 + [_F, _I, _P]


_ROWS = 16               # rows (c, g) a block
# a block's share of a long history, and blocks an SM to aim for (4 of
# its blocks fit an SM, and its 16 rows x 64 keys do more work a key)
_SPLIT = dict(keys_a_block=256, blocks_an_sm=4)


def _row_tiles(c: int, g: int) -> int:
    """Blocks a (lane, kv head) needs for its c * g rows."""
    return -(-c * g // _ROWS)


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("paged_prefill").repro_paged_prefill
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def paged_prefill_plain(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                        chunk_start, ck, cv, c_pos, *, scale: float,
                        window: int | None = None):
    """The kernel's contract in plain PyTorch: gather the lane's history
    pages, append the in-flight block, mask, softmax in f32."""
    b, c, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    maxp = page_table.shape[1]
    table = page_table.long()
    t = maxp * ps
    kh = k_pages[table].float().reshape(b, t, hkv, hd)
    vh = v_pages[table].float().reshape(b, t, hkv, hd)
    kpos = pos_pages[table].reshape(b, t).long()
    start = chunk_start.long()
    n_hist = torch.clamp(-torch.div(-start, ps, rounding_mode="floor"),
                         0, maxp)
    page = torch.arange(t, device=q.device) // ps
    hist_ok = (kpos >= 0) & (kpos < start[:, None]) \
        & (page[None, :] < n_hist[:, None])
    c_pos = c_pos.long()
    k_all = torch.cat([kh, ck.float()], dim=1)
    v_all = torch.cat([vh, cv.float()], dim=1)
    pos_all = torch.cat([kpos, c_pos], dim=1)              # (B, T)
    ok_all = torch.cat([hist_ok, c_pos >= 0], dim=1)
    qp = q_pos.long()[:, :, None]
    valid = ok_all[:, None, :] & (pos_all[:, None, :] <= qp) & (qp >= 0)
    if window is not None:
        valid &= pos_all[:, None, :] > qp - window
    qg = q.float().reshape(b, c, hkv, g, hd)
    logits = torch.einsum("bckgd,btkd->bkcgt", qg, k_all) * scale
    mask = valid[:, None, :, None, :]
    w = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    w = w.masked_fill(~mask, 0.0)
    out = torch.einsum("bkcgt,btkd->bckgd", w, v_all)
    return out.reshape(b, c, h, hd).to(q.dtype)


def _check(q, k_pages, v_pages, pos_pages, page_table, q_pos, chunk_start,
           ck, cv, c_pos):
    b, c, h, hd = q.shape
    p, ps, hkv, hd_k = k_pages.shape
    if q.dtype != torch.float32 or ck.dtype != torch.float32 \
            or cv.dtype != torch.float32 \
            or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError("paged_prefill kernel takes f32 q/ck/cv and a bf16 "
                        f"pool, got {q.dtype}/{ck.dtype}/{cv.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}")
    for name, t in (("pos_pages", pos_pages), ("page_table", page_table),
                    ("q_pos", q_pos), ("chunk_start", chunk_start),
                    ("c_pos", c_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if hd_k != hd or v_pages.shape != k_pages.shape \
            or pos_pages.shape != (p, ps) or page_table.shape[0] != b \
            or q_pos.shape != (b, c) or c_pos.shape != (b, c) \
            or chunk_start.shape != (b,) \
            or ck.shape != (b, c, hkv, hd) or cv.shape != ck.shape \
            or h % hkv or h // hkv > 32 or hd not in HEAD_DIMS:
        raise ValueError(
            f"paged_prefill shapes: q {tuple(q.shape)}, pool "
            f"{tuple(k_pages.shape)}, pos {tuple(pos_pages.shape)}, table "
            f"{tuple(page_table.shape)}, q_pos {tuple(q_pos.shape)}, start "
            f"{tuple(chunk_start.shape)}, ck/cv {tuple(ck.shape)}/"
            f"{tuple(cv.shape)}, c_pos {tuple(c_pos.shape)} "
            "(hd 32/64/96/128, H/Hkv <= 32)")
    if k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError("the pool's head_dim axis must be contiguous")
    if b * hkv * _row_tiles(c, h // hkv) >= 2 ** 31:
        raise ValueError(f"paged_prefill grid: B * Hkv * ceil(C * G / 16) "
                         f"= {b} * {hkv} * {_row_tiles(c, h // hkv)} must "
                         "be < 2^31")
    devs = {t.device for t in (q, k_pages, v_pages, pos_pages, page_table,
                               q_pos, chunk_start, ck, cv, c_pos)}
    if len(devs) != 1:
        raise ValueError(f"paged_prefill tensors span devices {devs}")
    build.check_rows_aligned("paged_prefill", q=q, ck=ck, cv=cv,
                             k_pages=k_pages, v_pages=v_pages)


def paged_prefill(q, k_pages, v_pages, pos_pages, page_table, q_pos,
                  chunk_start, ck, cv, c_pos, *, scale: float,
                  window: int | None = None):
    """Chunked-prefill attention: plain PyTorch on the CPU, the CUDA
    kernel on the card (raises on what the kernel does not take)."""
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, pos_pages,
                                   page_table, q_pos, chunk_start, ck, cv,
                                   c_pos, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill runs on cpu or cuda, not "
                         f"{q.device}")
    build.refuse_autograd("paged_prefill", q, k_pages, v_pages, ck, cv)
    q, ck, cv = q.contiguous(), ck.contiguous(), cv.contiguous()
    _check(q, k_pages, v_pages, pos_pages, page_table, q_pos, chunk_start,
           ck, cv, c_pos)
    page_table, q_pos = page_table.contiguous(), q_pos.contiguous()
    chunk_start, c_pos = chunk_start.contiguous(), c_pos.contiguous()
    b, c, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = page_table.shape[1]
    units = b * hkv * _row_tiles(c, h // hkv)
    out = torch.empty_like(q)
    s = build.split_count(units, maxp, ps, q.device, **_SPLIT)
    part = tickets = None
    if s > 1:
        part = torch.empty(units * s * _ROWS * (hd + 2),
                           dtype=torch.float32, device=q.device)
        tickets = build.ticket_buffer("paged_prefill", units, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(
        q.data_ptr(), q_pos.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), pos_pages.data_ptr(), page_table.data_ptr(),
        chunk_start.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        c_pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, c, h, hkv, hd,
        ps, maxp, s, *k_pages.stride()[:3], *v_pages.stride()[:3],
        *pos_pages.stride(), float(scale), int(window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA "
                           f"error {rc}")
    paged_prefill.launches += 1
    build.report_launch("paged_prefill", (q, k_pages, v_pages, pos_pages,
                                          page_table, q_pos), (out,))
    return out


paged_prefill.launches = 0


def kernel_info(b: int, c: int, h: int, hkv: int, hd: int, ps: int,
                maxp: int, device="cuda") -> dict:
    """The kernel's resources for a call on (b, c, h, hd) chunk queries
    over (ps, hkv, hd) pages and a ``maxp``-wide table, as the CUDA
    runtime reports them: registers a thread, shared memory a block
    (bytes), blocks an SM holds, local (spill) bytes a thread; and the
    splits of a lane's history the wrapper picks."""
    s = build.split_count(b * hkv * _row_tiles(c, h // hkv), maxp, ps,
                          torch.device(device), **_SPLIT)
    out = (ctypes.c_int * 4)()
    rc = build.library("paged_prefill").repro_paged_prefill_info(
        ctypes.c_int(hd), ctypes.c_int(c), ctypes.c_int(maxp),
        ctypes.c_int(ps), ctypes.c_int(s), out)
    if rc != 0:
        raise RuntimeError(f"paged_prefill info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), out), splits=s)
