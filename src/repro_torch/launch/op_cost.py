"""Per-device cost model of one step, taken from the ops it dispatches
(the JAX package's ``launch/hlo_cost.py``; PyTorch has no HLO to walk).

`analyze` runs a function under a recording dispatch mode and tallies,
for every op that reaches a device's tensors:

  * FLOPs: matmul, bmm, convolution and scaled-dot-product attention by
    ``torch.utils.flop_counter``'s formulas; pure data movement (copies,
    views, gathers, scatters, concatenation, factories, sorts, ...) 0;
    every other op 1 flop an output element;
  * HBM bytes: operand bytes plus result bytes of every op that moves
    data (views and metadata ops move none; an expanded operand counts
    the elements it addresses);
  * collectives: result bytes by kind, times the ring factor
    (all-reduce 2.0, the others 1.0) for the wire bytes; the subset
    whose group spans both pods (``pod_axis``) is the pod-crossing wire;
  * hand-written kernels: a kernel's wrapper reports each launch
    (``kernels.build.report_launch``), which counts its operand and
    result bytes and no flops, as the reference counts a ``custom-call``;
  * per-op records (op, result shape, count, and the bytes and flops
    of all those calls) for `repro_torch.launch.diagnose`;
  * temp bytes: the peak of live op results created during the call.

Counts are per device: on a DTensor step the mode lets DTensor lower
each op to its local op first and sees only that (and the collectives
the lowering issues), so a sharded matmul counts one device's share,
not the global product.  On plain tensors it sees the ops themselves.
Loops are Python loops, so there is no trip count to recover: every
iteration dispatches its ops again.

  from repro_torch.launch import op_cost
  cost = op_cost.analyze(fn, *args)      # cost.flops, cost.hbm_bytes, ...
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.build import LAUNCH_RECORDERS

__all__ = ["OpCost", "analyze"]

_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# functional-collective op -> kind
_COLLECTIVE_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that move no bytes (views are found from their schema)
_NO_TRAFFIC = {"detach", "alias", "lift_fresh", "wait_tensor", "empty",
               "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_local_scalar_dense", "set_",
               "resize_"}
# data movement: bytes yes, flops no
_NO_FLOPS = {
    "copy", "copy_", "clone", "_to_copy", "contiguous", "lift_fresh_copy",
    "cat", "stack", "constant_pad_nd", "pad", "flip", "roll", "repeat",
    "index", "index_select", "gather", "embedding", "take_along_dim",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "index_put",
    "index_put_", "_index_put_impl_", "index_add", "index_add_",
    "index_copy", "index_copy_", "slice_scatter", "select_scatter",
    "embedding_dense_backward", "masked_scatter",
    "arange", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_full", "fill", "fill_",
    "zero_", "scalar_tensor", "rand", "randn", "sort", "argsort",
    "expand", "expand_copy", "unfold_copy", "split_with_sizes_copy",
} | _NO_TRAFFIC


@dataclasses.dataclass
class OpCost:
    """One call's per-device counts (the reference's ``HloCost`` fields,
    then what the eager recorder adds)."""
    flops: float
    hbm_bytes: float
    collectives: dict
    wire_bytes: float
    pod_wire_bytes: float
    records: list = dataclasses.field(default_factory=list)
    kernels: dict = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0
    result: object = dataclasses.field(default=None, repr=False)


def _bytes_of(tensors) -> int:
    """Bytes the tensors address: a dim of stride 0 (an expanded view)
    reads its elements once."""
    total = 0
    for t in tensors:
        n = t.numel()
        if n and 0 in t.stride():
            n = 1
            for size, stride in zip(t.shape, t.stride()):
                if stride:
                    n *= size
        total += n * t.element_size()
    return total


def _nbytes(x) -> int:
    return _bytes_of(t for t in tree_flatten(x)[0]
                     if isinstance(t, torch.Tensor))


def _dtensor_type():
    """DTensor's class, or None where torch.distributed is not built."""
    import torch.distributed as dist

    if not dist.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _is_inplace(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


class _Recorder(TorchDispatchMode):
    """The dispatch mode `analyze` runs under."""

    def __init__(self, pod_stride: int | None, fake_mode):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.pod_stride = pod_stride
        self.formulas = flop_registry
        self.fake_mode = fake_mode
        self.dtensor_type = _dtensor_type()
        self.flops = 0.0
        self.hbm = 0.0
        self.wire = 0.0
        self.pod_wire = 0.0
        self.colls: dict = {}
        self.rows: dict = {}
        self.kernels: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0

    # -- tallies ----------------------------------------------------------
    def _row(self, op: str, outs, nbytes: float, flops: float) -> None:
        key = (op, tuple((t.dtype, tuple(t.shape)) for t in outs[:2]))
        row = self.rows.setdefault(key, [0.0, 0.0, 0])
        row[0] += nbytes
        row[1] += flops
        row[2] += 1

    def _track(self, outs) -> None:
        for t in outs:
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def kernel(self, name: str, inputs, outputs) -> None:
        """A hand-written kernel's launch: operand and result bytes, no
        flops."""
        outs = [t for t in tree_flatten(outputs)[0]
                if isinstance(t, torch.Tensor)]
        b = _nbytes(inputs) + _bytes_of(outs)
        self.hbm += b
        self.kernels[name] += 1
        self._row(f"kernel:{name}", outs, b, 0.0)

    def _collective(self, kind: str, args, ins, outs) -> None:
        b = _bytes_of(outs)
        c = self.colls.setdefault(kind, {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += b
        w = b * _WIRE_FACTOR.get(kind, 1.0)
        self.wire += w
        group = args[-1] if args and isinstance(args[-1], str) else None
        if group is not None and self.pod_stride \
                and _crosses_pod(group, self.pod_stride):
            self.pod_wire += w
        total = b + _bytes_of(ins)
        self.hbm += total
        self._row(kind, outs, total, 0.0)
        self._track(outs)

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.dtensor_type is not None \
                and any(issubclass(t, self.dtensor_type) for t in types):
            # let DTensor lower the op to its local op (and collectives)
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not outs:
            return out                   # metadata (prim.device, ...)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if self.fake_mode is not None and not any(
                getattr(t, "fake_mode", None) is self.fake_mode
                for t in ins + outs):
            # on a fake step, real tensors are DTensor's host bookkeeping
            # and other fake modes' tensors its sharding propagator's
            # global-shape trial runs: neither is a device's work
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            kind = _COLLECTIVE_OF.get(name.removesuffix("_autograd"))
            if kind is not None:
                self._collective(kind, args, ins, outs)
            return out
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        elif name in _NO_FLOPS:
            flops = 0.0
        else:
            flops = float(sum(t.numel() for t in outs))
        nbytes = _bytes_of(ins) + _bytes_of(outs)
        self.flops += flops
        self.hbm += nbytes
        self._row(f"{ns}.{name}" if ns != "aten" else name, outs, nbytes,
                  flops)
        if not _is_inplace(func):
            self._track(outs)
        return out


def _pod_stride(args, pod_axis: str | None) -> int | None:
    """Ranks a pod of the mesh of the first DTensor among ``args``, when
    that mesh has a ``pod_axis`` (else None)."""
    dtensor = _dtensor_type()
    if pod_axis is None or dtensor is None:
        return None
    for t in tree_flatten(args)[0]:
        if isinstance(t, dtensor):
            mesh = t.device_mesh
            names = mesh.mesh_dim_names or ()
            if pod_axis not in names:
                return None
            return mesh.size() // mesh.size(names.index(pod_axis))
    return None


@functools.lru_cache(maxsize=None)
def _crosses_pod(group_name: str, pod_stride: int) -> bool:
    """Whether the process group's ranks span both sides of the first
    pod boundary (the reference's replica-group test)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return min(ranks) < pod_stride <= max(ranks)


def _fake_mode_of(args):
    """The FakeTensorMode of the first tensor among ``args`` (a DTensor's
    local tensor counts), None when it is real."""
    dtensor = _dtensor_type()
    for t in tree_flatten(args)[0]:
        if dtensor is not None and isinstance(t, dtensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            return getattr(t, "fake_mode", None)
    return None


def analyze(fn, *args, pod_axis: str | None = "pod") -> OpCost:
    """Run ``fn(*args)`` and return its per-device `OpCost` (the
    function's return value in ``.result``).  When ``args`` are fake
    tensors (a dry run), only ops on tensors of their fake mode count."""
    rec = _Recorder(_pod_stride(args, pod_axis), _fake_mode_of(args))
    LAUNCH_RECORDERS.append(rec)
    try:
        with rec:
            result = fn(*args)
    finally:
        LAUNCH_RECORDERS.remove(rec)
    records = [{"op": op, "shape": ",".join(
        f"{str(dt).removeprefix('torch.')}{list(shp)}" for dt, shp in outs),
                "bytes": b, "flops": f, "count": n}
               for (op, outs), (b, f, n) in rec.rows.items()]
    return OpCost(flops=rec.flops, hbm_bytes=rec.hbm,
                  collectives=rec.colls, wire_bytes=rec.wire,
                  pod_wire_bytes=rec.pod_wire, records=records,
                  kernels=dict(rec.kernels), temp_bytes=rec.peak,
                  result=result)
