"""The fused T-Tamer exit decision: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (``csrc/ramp_exit.cu``) replaces the Pallas TPU kernel
`repro.kernels.ramp_exit.ramp_exit_kernel` behind the JAX op
``repro.kernels.ops.ramp_exit``.  Both functions here compute, for
logits (B, V), support edges (K-1,) f32, an if-stop table (K, X) (bool,
as `LineTables.stop[node + 1]` holds it, or integers, > 0 = stop),
and the lanes' state s_bin / x_idx (B,) int32:

    conf  = max softmax(logits)      loss  = lam * (1 - conf)
    bin   = searchsorted(edges, loss)   (the number of edges < loss)
    new_x = min(x_idx, bin + 1)      stop  = table[bin, new_x] > 0

and return (loss f32, bin i32, new_x i32, stop bool), each (B,) — one
`RecallIndexStrategy.observe` of a readout, whose ``lam * ell`` is this
loss.  ``s_bin`` is part of the contract because the TPU kernel takes it
(it reads it and never uses it); neither version here uses it either.

Unlike the TPU op, nothing is padded (the kernel bounds-checks the V
tail and any B) and the logits are read through their row stride, so a
sliced (B, V) view costs no copy.  The kernel splits each row over the
blocks of one thread-block cluster (`exit_splits`), so it needs a
Hopper card (sm_90a).  `ramp_exit` runs the plain version for CPU
tensors and the kernel for CUDA tensors — there is no fallback between
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["ramp_exit", "ramp_exit_plain", "exit_splits", "kernel_info"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, ctypes.c_longlong, _I, _I, _I, _I, _P, _I, _P, _I, _P,
             ctypes.c_float, _P, _P, _P, _P, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPLITS = 8                 # the portable thread-block cluster size


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("ramp_exit").repro_ramp_exit
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def exit_splits(b: int, v: int, dtype: torch.dtype, device) -> int:
    """Blocks (one cluster) that share a row: enough that the ``b`` rows
    cover twice the SMs, at most 8, and no more than the row has 16-byte
    words."""
    want = min(-(-2 * build.sm_count(device) // b),
               -(-v // (16 // dtype.itemsize)))
    return max(1, min(_MAX_SPLITS, want))


def kernel_info(b: int, v: int) -> dict:
    """The kernel's resources for ``b`` rows of ``v`` f32 logits, as the
    CUDA runtime reports them: registers a thread, static shared memory
    a block (bytes), blocks an SM, local (spill) bytes a thread, the
    cluster size (splits a row) and the clusters the card holds at
    once."""
    splits = exit_splits(b, v, torch.float32, torch.device("cuda"))
    out = (ctypes.c_int * 5)()
    rc = build.library("ramp_exit").repro_ramp_exit_info(
        ctypes.c_int(b), ctypes.c_int(splits), out)
    if rc != 0:
        raise RuntimeError(f"ramp_exit info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm",
                     "local_bytes", "active_clusters"), out),
                cluster_size=splits)


def ramp_exit_plain(logits, edges, stop_table, s_bin, x_idx, *,
                    lam: float):
    """The kernel's contract in plain PyTorch (the JAX package's
    ``ramp_exit_ref``: exp(max - logsumexp), searchsorted, gather)."""
    x = logits.float()
    conf = torch.exp(x.amax(dim=-1) - torch.logsumexp(x, dim=-1))
    loss = lam * (1.0 - conf)
    b = torch.searchsorted(edges, loss).to(torch.int32)
    new_x = torch.minimum(x_idx.to(torch.int32), b + 1)
    stop = stop_table[b.long(), new_x.long()] > 0
    return loss, b, new_x, stop


def _table_bytes(stop_table) -> torch.Tensor:
    """The table as contiguous uint8, 1 = stop: a bool table (the line
    DP's) is viewed as its bytes, an integer one is converted once."""
    if stop_table.dtype == torch.bool:
        return stop_table.contiguous().view(torch.uint8)
    return (stop_table > 0).to(torch.uint8).contiguous()


def _check(logits, edges, table, s_bin, x_idx):
    if logits.dim() != 2 or logits.dtype not in _DTYPES \
            or logits.stride(1) != 1:
        raise ValueError(
            "ramp_exit kernel takes (B, V) f32 or bf16 logits with unit "
            f"stride along V, got {tuple(logits.shape)} {logits.dtype} "
            f"strides {logits.stride()}")
    b = logits.shape[0]
    if edges.dtype != torch.float32 or edges.dim() != 1 \
            or not edges.is_contiguous():
        raise ValueError(f"ramp_exit: edges must be contiguous (E,) f32, "
                         f"got {tuple(edges.shape)} {edges.dtype}")
    if table.dim() != 2 or table.shape[0] != edges.shape[0] + 1:
        raise ValueError(f"ramp_exit: table {tuple(table.shape)} does not "
                         f"have K = {edges.shape[0] + 1} rows")
    if x_idx.dtype != torch.int32 or x_idx.shape != (b,) \
            or not x_idx.is_contiguous() or s_bin.shape != (b,):
        raise ValueError(f"ramp_exit: s_bin / x_idx must be ({b},), x_idx "
                         f"contiguous int32; got {tuple(s_bin.shape)} / "
                         f"{tuple(x_idx.shape)} {x_idx.dtype}")
    devs = {t.device for t in (logits, edges, table, s_bin, x_idx)}
    if len(devs) != 1:
        raise ValueError(f"ramp_exit tensors span devices {devs}")


def ramp_exit(logits, edges, stop_table, s_bin, x_idx, *, lam: float):
    """The exit decision: plain PyTorch on the CPU, the CUDA kernel on
    the card (raises on what the kernel does not take)."""
    if logits.device.type == "cpu":
        return ramp_exit_plain(logits, edges, stop_table, s_bin, x_idx,
                               lam=lam)
    if logits.device.type != "cuda":
        raise ValueError(f"ramp_exit runs on cpu or cuda, not "
                         f"{logits.device}")
    build.refuse_autograd("ramp_exit", logits, edges)
    table = _table_bytes(stop_table)
    _check(logits, edges, table, s_bin, x_idx)
    b, v = logits.shape
    dev = logits.device
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    bins = torch.empty((b,), dtype=torch.int32, device=dev)
    new_x = torch.empty((b,), dtype=torch.int32, device=dev)
    stop = torch.empty((b,), dtype=torch.bool, device=dev)
    splits = exit_splits(b, v, logits.dtype, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(logits.data_ptr(), logits.stride(0), b, v, splits,
                   _DTYPES[logits.dtype], edges.data_ptr(), edges.shape[0],
                   table.data_ptr(), table.shape[1], x_idx.data_ptr(),
                   float(lam), loss.data_ptr(), bins.data_ptr(),
                   new_x.data_ptr(), stop.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ramp_exit kernel launch failed: CUDA error "
                           f"{rc}")
    ramp_exit.launches += 1
    build.report_launch("ramp_exit", (logits, edges, stop_table, s_bin,
                                      x_idx), (loss, bins, new_x, stop))
    return loss, bins, new_x, stop


ramp_exit.launches = 0
