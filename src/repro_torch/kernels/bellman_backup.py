"""The Bellman backups of the T-Tamer line DP: the CUDA kernel's wrappers
and their plain PyTorch versions.

The kernel (``csrc/bellman_backup.cu``) replaces the Pallas TPU kernel
`repro.kernels.bellman_backup.bellman_backup_kernel`, one backup

  cont (K, X) = cost + trans (K, K) @ M,  M[y, x] = phi_next[y, mi_t[y, x]]

for phi_next (K, X) f32, trans (K, K) f32, mi_t (K, X) int32 and a
scalar cost (a Python float or a one-element f32 tensor), and with it
the loop of the JAX solve that calls it once a node: `bellman_solve`
runs the n backups of a backward line solve in one launch,

  for i = n-1 .. 0:  cont[i] = costs[i] + trans[i] @ M(phi),
                     phi = phi[i] = min(xvals, cont[i])

from phi = phi[n] = base.  `bellman_backup` is its n = 1 launch, with
no minimum.  On the solve's path X = K + 2.

Unlike the TPU wrapper (``repro.kernels.ops.bellman_backup``), X is not
padded to 128: the kernel masks its ragged edge itself.

Both wrappers run the plain version for CPU tensors and the kernel for
CUDA tensors — there is no fallback between them.  ``bellman_backup.
launches`` counts the kernel's launches, by either wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["bellman_backup", "bellman_backup_plain", "bellman_solve",
           "bellman_solve_plain", "kernel_info"]

_SMEM_BYTES = 232_448          # shared memory one block may use (H100)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 3 + [_P]


@functools.cache
def _kernel():
    """The built library's entry point, its C signature declared once."""
    fn = build.library("bellman_backup").repro_bellman_solve
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _pad4(w: int) -> int:
    return -(-w // 4) * 4


def _smem_bytes(n: int, k: int, x: int) -> int:
    """The kernel's shared memory (its ``Layout``): the n transitions in
    rows of pad4(K) words, or two taking turns where n do not fit; phi
    in two buffers; M and the gather offsets (K x X each); xvals and the
    costs; each region 16-byte aligned, 4 bytes a word."""
    def words(bufs):
        m = _pad4(bufs * k * _pad4(k) + 2 * k * x)
        return _pad4(_pad4(_pad4(m + k * x) + k * x) + x) + n

    w = words(n)
    return 4 * (w if 4 * w <= _SMEM_BYTES or n <= 2 else words(2))


def bellman_backup_plain(phi_next, trans, cost, mi_t):
    """The kernel's contract in plain PyTorch: gather, then matmul."""
    m = torch.gather(phi_next, 1, mi_t.long())             # (K, X)
    return cost + trans @ m


def bellman_solve_plain(base, trans_full, costs, xvals, mi_t):
    """The backward solve in plain PyTorch: `bellman_backup_plain` and a
    minimum a node, from the last node to the first.  Returns cont
    (n, K, X) and phi (n + 1, K, X), phi[n] = base."""
    n = trans_full.shape[0]
    mi = mi_t.long()                                        # once
    conts, phis = [None] * n, [None] * n
    phi_next = base
    for i in reversed(range(n)):
        conts[i] = bellman_backup_plain(phi_next, trans_full[i], costs[i], mi)
        phis[i] = phi_next = torch.minimum(xvals[None, :], conts[i])
    return torch.stack(conts), torch.stack(phis + [base])


def _check(base, trans_full, costs, xvals, mi_t):
    n = trans_full.shape[0] if trans_full.dim() == 3 else -1
    k, x = base.shape
    if base.dtype != torch.float32 or trans_full.dtype != torch.float32 \
            or costs.dtype != torch.float32 or mi_t.dtype != torch.int32 \
            or (xvals is not None and xvals.dtype != torch.float32):
        raise TypeError(
            "the Bellman kernel takes f32 phi/trans/costs/xvals and int32 "
            f"mi_t, got {base.dtype}/{trans_full.dtype}/{costs.dtype}/"
            f"{None if xvals is None else xvals.dtype}/{mi_t.dtype}")
    if trans_full.shape != (n, k, k) or n < 1 or mi_t.shape != (k, x) \
            or costs.shape != (n,) \
            or (xvals is not None and xvals.shape != (x,)) \
            or _smem_bytes(n, k, x) > _SMEM_BYTES:
        raise ValueError(
            f"Bellman kernel shapes: phi {tuple(base.shape)}, trans "
            f"{tuple(trans_full.shape)}, mi_t {tuple(mi_t.shape)}, costs "
            f"{tuple(costs.shape)} (with two transitions, about 4 (2 K "
            f"pad4(K) + 4 K X + X + n) bytes must fit a block's "
            f"{_SMEM_BYTES})")
    ts = [base, trans_full, costs, mi_t] + ([] if xvals is None else [xvals])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the Bellman kernel's tensors must be contiguous")
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"Bellman kernel tensors span devices {devs}")


def _launch(base, trans_full, costs, xvals, mi_t, cont, phi):
    n, k, _ = trans_full.shape
    stream = torch.cuda.current_stream(base.device).cuda_stream
    rc = _kernel()(base.data_ptr(), trans_full.data_ptr(), costs.data_ptr(),
                   None if xvals is None else xvals.data_ptr(),
                   mi_t.data_ptr(), cont.data_ptr(),
                   None if phi is None else phi.data_ptr(), n, k,
                   base.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"Bellman kernel launch failed: CUDA error {rc}")
    bellman_backup.launches += 1
    build.report_launch("bellman_backup", (base, trans_full, costs, xvals,
                                           mi_t), (cont, phi))


def _on_card(name, t, *inputs) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    build.refuse_autograd(name, t, *inputs)


def bellman_backup(phi_next, trans, cost, mi_t):
    """One backup: plain PyTorch on the CPU, the kernel's n = 1 launch on
    the card (raises on what the kernel does not take)."""
    if phi_next.device.type == "cpu":
        return bellman_backup_plain(phi_next, trans, cost, mi_t)
    _on_card("bellman_backup", phi_next, trans, cost)
    cost = torch.as_tensor(cost, dtype=torch.float32,
                           device=phi_next.device).reshape(1)
    _check(phi_next, trans[None], cost, None, mi_t)
    out = torch.empty_like(phi_next)
    _launch(phi_next, trans[None], cost, None, mi_t, out, None)
    return out


def bellman_solve(base, trans_full, costs, xvals, mi_t):
    """The backward solve (see the module docstring): plain PyTorch on
    the CPU, one launch of the kernel on the card (raises on what the
    kernel does not take).  Returns cont (n, K, X), phi (n + 1, K, X)."""
    if base.device.type == "cpu":
        return bellman_solve_plain(base, trans_full, costs, xvals, mi_t)
    _on_card("bellman_solve", base, trans_full, costs, xvals)
    _check(base, trans_full, costs, xvals, mi_t)
    n, (k, x) = trans_full.shape[0], base.shape
    cont = torch.empty((n, k, x), dtype=torch.float32, device=base.device)
    phi = torch.empty((n + 1, k, x), dtype=torch.float32, device=base.device)
    _launch(base, trans_full, costs, xvals, mi_t, cont, phi)
    return cont, phi


def kernel_info(n: int, k: int, x: int) -> dict:
    """The kernel's resources for an n-node solve at K, X, as the CUDA
    runtime reports them: registers a thread, shared memory a block
    (bytes), threads of the block, local (spill) bytes a thread, and the
    transitions it holds in shared memory at once."""
    out = (ctypes.c_int * 5)()
    rc = build.library("bellman_backup").repro_bellman_solve_info(
        ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(x), out)
    if rc != 0:
        raise RuntimeError(f"Bellman kernel info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem_bytes", "threads", "local_bytes",
                     "transitions_held"), out))


bellman_backup.launches = 0
