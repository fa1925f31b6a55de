"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which the kernel's
wrapper loads with ``ctypes``.  Libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, keyed by a
hash of the sources and flags, so an unchanged tree never rebuilds and
a changed one never loads a stale library.  `build_all` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "check_rows_aligned"]

SOURCES = ("paged_attention", "paged_prefill", "flash_attention",
           "bellman_backup", "ssd_chunk", "ramp_exit")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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


def check_rows_aligned(kernel: str, **tensors) -> None:
    """Raise unless every row of each tensor starts on 16 bytes, for a
    kernel that copies rows in 16-byte pieces: the base pointer 16-byte
    aligned and every stride but the last a multiple of 4 elements (a
    stride of an axis of length 1 is never used).  The wrappers raise;
    they never copy to make a tensor so."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 4 for st, n in zip(
                t.stride()[:-1], t.shape[:-1]) if n > 1):
            raise ValueError(
                f"{kernel}: {name} must start on 16 bytes and have strides "
                f"that are multiples of 4 elements (data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())})")
