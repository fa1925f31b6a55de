"""Bytes and operations one call of each paged kernel needs on its
inputs (the arithmetic of ``chip_smoke.py``'s ``decode_bound`` and
``prefill_bound``, copied, and computed on the device so a traced run
reads it without a host sync a launch).

The count follows the call's tensors, whatever implements it: every
input byte the call must read once, every output byte written once; of
the pool, the positions and table entries of the pages the lane uses and
the K and V rows of the keys some query of the lane sees.
"""

from __future__ import annotations

import torch

__all__ = ["decode_cost", "prefill_cost", "visible"]


def visible(kpos, qp, window):
    """Keys at ``kpos`` a query at ``qp`` attends to (-1 = empty)."""
    ok = (kpos >= 0) & (kpos <= qp)
    if window is not None:
        ok &= kpos > qp - window
    return ok


def decode_cost(q, k_pages, pos_pages, page_table, q_pos, window=None):
    """``(bytes, flops)`` as 0-d f64 device tensors for one paged decode
    call: q (B, H, hd) f32, pools (P, ps, Hkv, hd) bf16, pos (P, ps),
    table (B, maxp), q_pos (B,)."""
    b, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = page_table.shape[1]
    qp = q_pos.long()
    n_used = torch.clamp(torch.div(qp, ps, rounding_mode="floor") + 1,
                         min=0, max=maxp)
    used = torch.arange(maxp, device=qp.device)[None, :] < n_used[:, None]
    kp = pos_pages[page_table.long()]                    # (B, maxp, ps)
    vis = visible(kp, qp[:, None, None], window) & used[:, :, None]
    keys = vis.sum(dtype=torch.float64)
    pages = n_used.sum(dtype=torch.float64)
    live = (qp >= 0).sum(dtype=torch.float64)
    nbytes = (live * h * hd * 4 + q.numel() * 4 + keys * hkv * hd * 2 * 2
              + pages * ps * 4 + pages * 4 + b * 4)
    return nbytes, keys * h * 4 * hd


def prefill_cost(q, k_pages, pos_pages, page_table, q_pos, window=None):
    """``(bytes, flops)`` for one paged prefill-chunk call: q (B, C, H,
    hd) f32, q_pos (B, C) (-1 = pad row; a lane's rows run up from its
    chunk start), the in-flight k and v f32 beside q.  The history is
    what the pool holds below the chunk start."""
    b, c, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    maxp = page_table.shape[1]
    qp = q_pos.long()                                    # (B, C)
    row = qp >= 0
    start = torch.where(row[:, 0], qp[:, 0], torch.zeros_like(qp[:, 0]))
    n_hist = torch.clamp(-torch.div(-start, ps, rounding_mode="floor"),
                         min=0, max=maxp)
    used = torch.arange(maxp, device=qp.device)[None, :] < n_hist[:, None]
    kp = pos_pages[page_table.long()].reshape(b, maxp * ps)
    hist = (kp >= 0) & (kp < start[:, None]) \
        & used.repeat_interleave(ps, dim=1)
    # a history key is seen by some row iff the first row sees it
    seen = hist & visible(kp, start[:, None], window)
    hist_rows = seen.sum(dtype=torch.float64)
    # (row, key) pairs: history keys a row sees, then in-flight keys
    pairs_hist = (hist[:, None, :] & visible(kp[:, None, :], qp[:, :, None],
                                             window)
                  & row[:, :, None]).sum(dtype=torch.float64)
    pairs_own = (visible(qp[:, None, :], qp[:, :, None], window)
                 & row[:, :, None] & row[:, None, :]).sum(
                     dtype=torch.float64)
    rows = row.sum(dtype=torch.float64)
    pages = n_hist.sum(dtype=torch.float64)
    nbytes = (rows * h * hd * 4 + q.numel() * 4 + rows * hkv * hd * 4 * 2
              + hist_rows * hkv * hd * 2 * 2 + pages * ps * 4 + pages * 4
              + q_pos.numel() * 4 + b * 4)
    return nbytes, (pairs_hist + pairs_own) * h * 4 * hd
