"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which the kernel's
wrapper loads with ``ctypes``.  Libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, keyed by a
hash of the sources and flags, so an unchanged tree never rebuilds and
a changed one never loads a stale library.  `build_all` starts one
``nvcc`` per source, all at once.

It also holds what the wrappers share around a launch: the check that
rows copied in 16-byte pieces start on 16 bytes, and the split of a
long key range over blocks whose partial sums the last block to finish
merges (`split_count`, and the integer tickets of `ticket_buffer`); and
`report_launch`, by which each wrapper tells the active launch
recorders (`LAUNCH_RECORDERS`: a cost model's, such as
`repro_torch.launch.op_cost.analyze`) of a launch, which no dispatch
mode sees.  A CUDA graph's capture launches nothing: `held_launches`
holds back what the wrappers report while it records, and
`replay_launches` reports it again, and counts it, at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "library", "check_rows_aligned",
           "sm_count", "split_count", "ticket_buffer", "ticket_buffers",
           "LAUNCH_RECORDERS", "report_launch", "held_launches",
           "replay_launches"]

SOURCES = ("paged_attention", "paged_prefill", "flash_attention",
           "bellman_backup", "ssd_chunk", "ramp_exit")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_tickets: dict = {}
_MAX_KEYS_A_BLOCK = 1024
# objects with a ``kernel(name, inputs, outputs)`` method, told of every
# launch while they are in the list
LAUNCH_RECORDERS: list = []


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: {"path", "seconds", "log"}}`` (seconds 0 and an empty log
    for a library that was already there); raises with the compiler's
    output if any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": target, "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)     # atomic: readers never see a partial
        out[name] = {"path": target, "seconds": time.perf_counter() - t0,
                     "log": log}
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use (the
    first call builds every kernel of `SOURCES` in parallel)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            built = build_all(SOURCES if name in SOURCES else (name,))
            for n, info in built.items():
                _loaded.setdefault(n, ctypes.CDLL(str(info["path"])))
            lib = _loaded[name]
        return lib


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when gradients are being recorded and an input requires
    one: the kernels have no backward (nor have the JAX package's), so
    a launch would silently cut the gradient.  Non-tensors are
    ignored."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the kernel has no backward; an input requires "
            "grad under autograd (call it under torch.no_grad(), or take "
            "the plain path)")


def check_rows_aligned(kernel: str, **tensors) -> None:
    """Raise unless every row of each tensor starts on 16 bytes, for a
    kernel that copies rows in 16-byte pieces: the base pointer 16-byte
    aligned and every stride but the last a multiple of 16 bytes (4 f32
    or 8 bf16 elements; a stride of an axis of length 1 is never used).
    The wrappers raise; they never copy to make a tensor so."""
    for name, t in tensors.items():
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % per for st, n in zip(
                t.stride()[:-1], t.shape[:-1]) if n > 1):
            raise ValueError(
                f"{kernel}: {name} must start on 16 bytes and have strides "
                f"that are multiples of {per} elements (data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())})")


@functools.cache
def sm_count(device) -> int:
    """The SMs of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(units: int, maxp: int, ps: int, device, *,
                keys_a_block: int = 128, blocks_an_sm: int = 8) -> int:
    """Blocks that share one unit's (a lane and kv head's, with its row
    tile for prefill) ``maxp`` pages of ``ps`` slots: one up to
    ``keys_a_block`` slots; for longer contexts one per
    ``keys_a_block``, at most about ``blocks_an_sm`` blocks an SM in
    all, and never fewer than one per 1024 slots (a split's slot list
    lives in shared memory).  The defaults are the decode kernel's (6 of
    its blocks fit an SM)."""
    keys = maxp * ps
    want = min(-(-keys // keys_a_block),
               max(1, -(-blocks_an_sm * sm_count(device) // units)))
    return min(maxp, max(1, want, -(-keys // _MAX_KEYS_A_BLOCK)))


def ticket_buffer(kernel: str, n: int, device) -> torch.Tensor:
    """``n`` zero int32 tickets of ``kernel`` on ``device``, allocated at
    the first call that needs them (every launch leaves them at zero, so
    calls of one kernel on one device must not overlap on two
    streams)."""
    t = _tickets.get((kernel, device))
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: a call with {n} split units must "
                               "run once before CUDA graph capture")
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets[(kernel, device)] = t
    return t


def ticket_buffers() -> tuple:
    """Every ticket buffer allocated so far.  A CUDA graph that recorded
    a split launch holds its tickets' address, so it keeps these alive
    while a later, larger call of the kernel allocates new ones."""
    return tuple(_tickets.values())


def report_launch(name: str, inputs, outputs) -> None:
    """Tell every recorder of `LAUNCH_RECORDERS` of one launch of kernel
    ``name``: its operand and result tensors."""
    for rec in LAUNCH_RECORDERS:
        rec.kernel(name, inputs, outputs)


@functools.cache
def _wrapper(name: str):
    """Kernel ``name``'s wrapper: the function of that name in the
    module of that name, which counts its launches on ``launches``."""
    module = importlib.import_module(f"{__name__.rpartition('.')[0]}.{name}")
    return getattr(module, name)


class _Holder:
    def __init__(self, held: list):
        self.held = held

    def kernel(self, name, inputs, outputs):
        self.held.append((name, tuple(inputs), tuple(outputs)))


@contextlib.contextmanager
def held_launches():
    """Hold back the launches the wrappers report inside the block: no
    recorder of `LAUNCH_RECORDERS` is told of them, and each kernel's
    ``launches`` counter ends the block where it began.  Yields the list
    of held ``(name, inputs, outputs)``, which a CUDA graph that
    recorded those launches hands to `replay_launches` at each
    replay."""
    held: list = []
    saved = LAUNCH_RECORDERS[:]
    LAUNCH_RECORDERS[:] = [_Holder(held)]
    try:
        yield held
    finally:
        LAUNCH_RECORDERS[:] = saved
        for name, _, _ in held:
            _wrapper(name).launches -= 1


def replay_launches(held) -> None:
    """Count and report the launches ``held`` (`held_launches`) as a
    CUDA graph that recorded them replays: each one adds one to its
    kernel's ``launches`` and is told to every recorder, with the
    tensors the graph reads and writes, as the wrapper would have."""
    for name, inputs, outputs in held:
        _wrapper(name).launches += 1
        report_launch(name, inputs, outputs)
