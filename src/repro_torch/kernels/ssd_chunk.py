"""Mamba2 SSD within-chunk dual form: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/ssd_chunk.cu``) replaces the Pallas TPU kernel
`repro.kernels.ssd_chunk.ssd_chunk_kernel`.  Both functions here take
the model layout `models.ssm.ssd_chunked` gives them:

  xh (B, C, Q, H, P), dt/da (B, C, Q, H), bb/cc (B, C, Q, H, N), all
  f32.  Per (batch, chunk, head), with seg = cumsum(da) over Q and
  L[i, j] = exp(seg_i - seg_j) for i >= j (0 above the diagonal):
    y_diag[i]  = sum_j (C_i . B_j) L[i, j] dt_j X_j        (B,C,Q,H,P)
    states     = sum_j exp(seg_{Q-1} - seg_j) dt_j X_j B_j^T (B,C,H,P,N)
  both f32.

The kernel reads every input in place through its strides (``bb``/``cc``
may be a stride-0 broadcast over H); nothing is copied or padded.  It
copies rows of xh, bb and cc in 16-byte pieces, so each must start on
16 bytes and have (batch, chunk, row, head) strides that are multiples
of 4 elements (a stride of an axis of length 1 is never used); the
wrapper raises otherwise.

``q_valid`` (both functions; None means Q) is the number of leading rows
of the LAST chunk that are not the caller's padding.  The contract:
rows at or past ``q_valid`` of the last chunk have x = B = C = dt = da =
0.  On such inputs those y rows are exactly 0 (C = 0), they add exactly
0 to every other row and to the states (B = x = dt = 0), and seg is flat
across them (da = 0), so skipping them changes no number.  The kernel
never reads or multiplies them and writes exact zeros to their y rows;
the plain version computes as before and then zeroes those rows.

seg is accumulated in f64 and each prefix rounded to f32 (`prefix_sum`,
what PyTorch's CPU cumsum does for f32 on its own), in both versions
and on every device.  With the model's decay (da about -2 a row) seg
reaches -500 within a 256-row chunk, where an f32 accumulator's rounding
depends on its order by several ulp (6.1e-5 each at 500), and L =
exp(seg_i - seg_j) inherits that as a relative error: CUDA's f32 cumsum
(a parallel scan) and a serial f32 loop gave late rows of y that missed
atol = rtol = 2e-4.

`ssd_chunk` runs the plain version for CPU tensors and the kernel for
CUDA tensors — there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["ssd_chunk", "ssd_chunk_plain", "prefix_sum", "MAX_P", "MAX_Q",
           "kernel_info"]

MAX_P = 128          # head_dim the kernel's register tile holds
MAX_Q = 1024         # chunk length whose cumsum fits its shared memory

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_L] * 20 + [_I, _P]


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("ssd_chunk").repro_ssd_chunk
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def prefix_sum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum along ``dim``, accumulated in f64 and rounded to
    ``a``'s dtype: the same f32 values on the CPU and on the card."""
    return torch.cumsum(a.double(), dim=dim).to(a.dtype)


def _q_valid(q_valid, q: int) -> int:
    if q_valid is None:
        return q
    if not 1 <= q_valid <= q:
        raise ValueError(f"ssd_chunk: q_valid {q_valid} outside 1..{q}")
    return int(q_valid)


def ssd_chunk_plain(xh, dt, da, bb, cc, *, q_valid=None):
    """The kernel's contract in plain PyTorch, as the JAX package's
    ``ref.ssd_chunk_ref`` computes it (the CPU path and the card's
    reference).  The upper triangle of L is selected away before the
    exponential could overflow into it.  y rows at or past ``q_valid``
    of the last chunk are zeroed (see the module docstring)."""
    qv = _q_valid(q_valid, da.shape[2])
    seg_a = da.transpose(-1, -2)                         # (B,C,H,Q)
    cs = prefix_sum(seg_a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    q = da.shape[2]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da.device))
    l = torch.where(mask, torch.exp(diff), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bb)
    m = scores * l * dt.transpose(-1, -2)[..., None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", m, xh)
    cum = prefix_sum(da, 2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bb, xh)
    if qv < q:
        y_diag[:, -1, qv:] = 0.0
    return y_diag, states


def _check(xh, dt, da, bb, cc):
    b, c, q, h, p = xh.shape
    n = bb.shape[-1]
    ts = (xh, dt, da, bb, cc)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_chunk kernel takes f32 inputs, got "
                        f"{[str(t.dtype) for t in ts]}")
    if dt.shape != (b, c, q, h) or da.shape != dt.shape \
            or bb.shape != (b, c, q, h, n) or cc.shape != bb.shape:
        raise ValueError(
            f"ssd_chunk shapes: xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
            f"da {tuple(da.shape)}, bb {tuple(bb.shape)}, cc "
            f"{tuple(cc.shape)}")
    if p > MAX_P or q > MAX_Q or p % 4 or n % 4 or min(b, c, q, h) < 1:
        raise ValueError(f"ssd_chunk: P {p} (<= {MAX_P}) and N {n} must be "
                         f"multiples of 4, Q {q} in 1..{MAX_Q}")
    if any(t.stride(-1) != 1 for t in (xh, bb, cc)):
        raise ValueError("ssd_chunk: the last axis of xh, bb and cc must "
                         "be contiguous")
    build.check_rows_aligned("ssd_chunk", xh=xh, bb=bb, cc=cc)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"ssd_chunk tensors span devices {devs}")


def ssd_chunk(xh, dt, da, bb, cc, *, q_valid=None):
    """Within-chunk SSD: plain PyTorch on the CPU, the CUDA kernel on the
    card (raises on what the kernel does not take).  ``q_valid``: the
    leading rows of the last chunk that are not padding (None: all; see
    the module docstring for what the rows past it must hold).  Returns
    (y_diag (B,C,Q,H,P), states (B,C,H,P,N)), f32."""
    if xh.device.type == "cpu":
        return ssd_chunk_plain(xh, dt, da, bb, cc, q_valid=q_valid)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cpu or cuda, not {xh.device}")
    build.refuse_autograd("ssd_chunk", xh, dt, da, bb, cc)
    _check(xh, dt, da, bb, cc)
    b, c, q, h, p = xh.shape
    qv = _q_valid(q_valid, q)
    n = bb.shape[-1]
    y = torch.empty((b, c, q, h, p), dtype=torch.float32, device=xh.device)
    st = torch.empty((b, c, h, p, n), dtype=torch.float32, device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    rc = _kernel()(
        xh.data_ptr(), dt.data_ptr(), da.data_ptr(), bb.data_ptr(),
        cc.data_ptr(), y.data_ptr(), st.data_ptr(), b, c, q, h, p, n,
        *xh.stride()[:4], *dt.stride(), *da.stride(), *bb.stride()[:4],
        *cc.stride()[:4], qv, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{rc}")
    ssd_chunk.launches += 1
    build.report_launch("ssd_chunk", (xh, dt, da, bb, cc), (y, st))
    return y, st


ssd_chunk.launches = 0


def kernel_info(q: int, p: int, n: int) -> dict:
    """The kernel's resources at chunk length ``q``, head dim ``p`` and
    state ``n``, as the CUDA runtime reports them: registers a thread,
    shared memory a block (bytes), blocks an SM holds, local (spill)
    bytes a thread."""
    out = (ctypes.c_int * 4)()
    rc = build.library("ssd_chunk").repro_ssd_chunk_info(
        ctypes.c_int(q), ctypes.c_int(p), ctypes.c_int(n), out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes"), out))
