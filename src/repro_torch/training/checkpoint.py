"""Checkpoints in the JAX package's file format (its
``training/checkpoint.py``): a msgpack map ``{"step", "arrays": {path:
{"dtype", "shape", "data"}}}`` over flat ``/``-key paths (``#i`` for a
list item), in a zstd frame — or, where ``zstandard`` does not import,
the JAX package's own ``ZLB0`` zlib frame.  Each package reads the
other's files.

The msgpack subset the format uses (map, array, str, bin, int, nil,
float) is encoded and decoded here, so the port needs no msgpack
module; its bytes are ``msgpack.packb(payload, use_bin_type=True)``'s.
``load`` returns numpy arrays, except for ``bfloat16`` leaves, which
numpy has no dtype for: they come back as CPU ``torch.bfloat16``
tensors (stored, as the JAX package stores them, as their 16-bit
patterns).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

try:
    import zstandard
except ImportError:          # optional: fall back to stdlib zlib frames
    zstandard = None

__all__ = ["save", "load", "latest_step", "codec", "packb", "unpackb"]

_ZLIB_MAGIC = b"ZLB0"        # zlib frames; zstd frames self-identify


def codec() -> str:
    """The frame ``save`` writes here: ``zstd`` or ``zlib (ZLB0)``."""
    return "zstd" if zstandard is not None else "zlib (ZLB0)"


def _compress(raw: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(raw)
    return _ZLIB_MAGIC + zlib.compress(raw, 6)


def _decompress(buf: bytes) -> bytes:
    if buf[:4] == _ZLIB_MAGIC:
        return zlib.decompress(buf[4:])
    if zstandard is None:
        raise ImportError("checkpoint was written with zstd but the "
                          "zstandard module is not installed")
    return zstandard.ZstdDecompressor().decompress(buf)


# ---- msgpack: the subset the format uses --------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int] | tuple[int, int]) -> None:
    """A length header: the fix form, then 8/16/32-bit (``codes`` has
    no 8-bit entry for arrays and maps)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    widths = ((0xff, ">B"), (0xffff, ">H"), (0xffffffff, ">I"))
    for code, (lim, fmt) in zip(codes, widths[3 - len(codes):]):
        if n <= lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for code, lim, fmt in ((0xcc, 0xff, ">B"), (0xcd, 0xffff, ">H"),
                               (0xce, 0xffffffff, ">I"),
                               (0xcf, 0xffffffffffffffff, ">Q")):
            if x <= lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"msgpack: int {x} too large")
    else:
        for code, lim, fmt in ((0xd0, 0x80, ">b"), (0xd1, 0x8000, ">h"),
                               (0xd2, 0x80000000, ">i"),
                               (0xd3, 0x8000000000000000, ">q")):
            if x >= -lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"msgpack: int {x} too small")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), None, -1, (0xc4, 0xc5, 0xc6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for maps, arrays, str,
    bytes, int, bool, None and float."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LENS = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
         0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def _unpack(buf: memoryview, i: int):
    """(object, next offset) of the msgpack value at ``buf[i]``."""
    c = buf[i]
    i += 1
    if c <= 0x7f:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if c == 0xc0:
        return None, i
    if c in (0xc2, 0xc3):
        return c == 0xc3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if 0xa0 <= c <= 0xbf or 0x90 <= c <= 0x9f or 0x80 <= c <= 0x8f:
        n, kind = c & (0x1f if c >= 0xa0 else 0x0f), c & 0xf0
        kind = {0xa0: "str", 0xb0: "str", 0x90: "array", 0x80: "map"}[kind]
    elif c in _LENS:
        fmt = _LENS[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        kind = ("str" if c in (0xd9, 0xda, 0xdb) else
                "bin" if c in (0xc4, 0xc5, 0xc6) else
                "array" if c in (0xdc, 0xdd) else "map")
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")
    if kind in ("str", "bin"):
        raw = bytes(buf[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for what `packb` writes."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} trailing bytes")
    return obj


# ---- trees -------------------------------------------------------------

def _leaf_record(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(x.shape),
                    "data": x.contiguous().view(torch.int16).numpy()
                    .tobytes()}
        x = x.numpy()
    a = np.asarray(x)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
    else:
        out[prefix] = _leaf_record(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, val in flat.items():
        keys = path.strip("/").split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            idx = sorted(node, key=lambda s: int(s[1:]))
            return [rebuild(node[i]) for i in idx]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def save(path: str, tree, step: int | None = None) -> str:
    """Write ``tree`` (nested dicts / lists of tensors or numpy arrays)
    and ``step`` to ``path``; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"step": step, "arrays": _flatten(tree)}
    with open(path, "wb") as f:
        f.write(_compress(packb(payload)))
    return path


def _array(meta: dict):
    shape = meta["shape"]
    if meta["dtype"] == "bfloat16":
        bits = np.frombuffer(meta["data"], np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(meta["data"], np.dtype(meta["dtype"])) \
        .reshape(shape)


def load(path: str):
    """(tree, step) of a checkpoint either package wrote."""
    with open(path, "rb") as f:
        payload = unpackb(_decompress(f.read()))
    flat = {k: _array(meta) for k, meta in payload["arrays"].items()}
    return _unflatten(flat), payload.get("step")


def latest_step(ckpt_dir: str) -> str | None:
    """The path of the highest-numbered ``*_N.ckpt`` in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    cks = [f for f in os.listdir(ckpt_dir) if f.endswith(".ckpt")]
    if not cks:
        return None
    cks.sort(key=lambda f: int(f.split("_")[-1].split(".")[0]))
    return os.path.join(ckpt_dir, cks[-1])
