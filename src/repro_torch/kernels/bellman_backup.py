"""One Bellman backup of the T-Tamer line DP: the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (``csrc/bellman_backup.cu``) replaces the Pallas TPU kernel
`repro.kernels.bellman_backup.bellman_backup_kernel`.  Both functions
here compute

  cont (K, X) = cost + trans (K, K) @ M,  M[y, x] = phi_next[y, mi_t[y, x]]

for phi_next (K, X) f32, trans (K, K) f32, mi_t (K, X) int32 and a
scalar cost (a Python float or a one-element f32 tensor).  On the
solve's path X = K + 2.

Unlike the TPU wrapper (``repro.kernels.ops.bellman_backup``), X is not
padded to 128: the kernel masks its ragged edge itself.

`bellman_backup` runs the plain version for CPU tensors and the kernel
for CUDA tensors — there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["bellman_backup", "bellman_backup_plain"]

_SMEM_BYTES = 232_448          # shared memory one block may use (H100)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 2 + [_P]


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("bellman_backup").repro_bellman_backup
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bellman_backup_plain(phi_next, trans, cost, mi_t):
    """The kernel's contract in plain PyTorch: gather, then matmul."""
    m = torch.gather(phi_next, 1, mi_t.long())             # (K, X)
    return cost + trans @ m


def _check(phi_next, trans, cost, mi_t):
    k, x = phi_next.shape
    if phi_next.dtype != torch.float32 or trans.dtype != torch.float32 \
            or cost.dtype != torch.float32 or mi_t.dtype != torch.int32:
        raise TypeError(
            "bellman_backup kernel takes f32 phi/trans/cost and int32 "
            f"mi_t, got {phi_next.dtype}/{trans.dtype}/{cost.dtype}/"
            f"{mi_t.dtype}")
    if trans.shape != (k, k) or mi_t.shape != (k, x) or cost.numel() != 1 \
            or 4 * k * x > _SMEM_BYTES:
        raise ValueError(
            f"bellman_backup shapes: phi {tuple(phi_next.shape)}, trans "
            f"{tuple(trans.shape)}, mi_t {tuple(mi_t.shape)}, cost "
            f"{tuple(cost.shape)} (K * X floats must fit shared memory)")
    if not all(t.is_contiguous() for t in (phi_next, trans, mi_t)):
        raise ValueError("bellman_backup: phi_next, trans and mi_t must be "
                         "contiguous")
    devs = {t.device for t in (phi_next, trans, cost, mi_t)}
    if len(devs) != 1:
        raise ValueError(f"bellman_backup tensors span devices {devs}")


def bellman_backup(phi_next, trans, cost, mi_t):
    """One backup: plain PyTorch on the CPU, the CUDA kernel on the card
    (raises on what the kernel does not take)."""
    if phi_next.device.type == "cpu":
        return bellman_backup_plain(phi_next, trans, cost, mi_t)
    if phi_next.device.type != "cuda":
        raise ValueError(f"bellman_backup runs on cpu or cuda, not "
                         f"{phi_next.device}")
    cost = torch.as_tensor(cost, dtype=torch.float32,
                           device=phi_next.device)
    _check(phi_next, trans, cost, mi_t)
    k, x = phi_next.shape
    out = torch.empty((k, x), dtype=torch.float32, device=phi_next.device)
    stream = torch.cuda.current_stream(phi_next.device).cuda_stream
    rc = _kernel()(phi_next.data_ptr(), trans.data_ptr(), mi_t.data_ptr(),
                   cost.data_ptr(), out.data_ptr(), k, x, stream)
    if rc != 0:
        raise RuntimeError(f"bellman_backup kernel launch failed: CUDA "
                           f"error {rc}")
    bellman_backup.launches += 1
    return out


bellman_backup.launches = 0
