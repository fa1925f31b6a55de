"""Activation-sharding context (the JAX package's ``sharding/ctx.py``)
and the DTensor helpers the model code calls.

Model code is mesh-agnostic; a launcher installs the batch mesh axes
here and ``constrain_batch`` anchors the residual stream's sharding at
segment boundaries (``constrain_expert`` an MoE buffer's group and
expert dims).  Outside a launcher, and on any tensor that is not a
DTensor, both return their input itself, so the plain paths see no
change at all; so does `reduce_partial`.  `embed_rows` is the
embedding lookup and `scatter_rows_` the ring write, plain or shard by
shard; `sdpa_sharded` is the attention of DTensors.  `ReplicateRefused`
is the dispatch mode under which a DTensor op that DTensor cannot shard
runs on replicated operands (the dry run and ``launch.train --mesh``).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["activation_sharding", "constrain_batch", "constrain_expert",
           "dtensor_mesh", "local_shard", "shard_offset", "reduce_partial",
           "embed_rows", "scatter_rows_", "sdpa_sharded",
           "ReplicateRefused"]

_BATCH_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_axes", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes):
    """batch_axes: mesh-axis tuple for the batch dim, e.g. ("pod","data")."""
    tok = _BATCH_AXES.set(tuple(batch_axes) if batch_axes else None)
    try:
        yield
    finally:
        _BATCH_AXES.reset(tok)


def dtensor_mesh(x):
    """x's `DeviceMesh` when x is a DTensor, else None (at once for a
    plain tensor: the model's hot paths ask)."""
    if type(x) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor

    return x.device_mesh if isinstance(x, DTensor) else None


def _constrain(x, mesh, entries: dict) -> torch.Tensor:
    """Redistribute x to Shard(dim) on the mesh axes ``entries`` gives
    each named dim, Replicate on every other mesh axis (as the JAX
    package's None entries force replication)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, axes in entries.items() for a in axes}
    placements = tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                       for n in mesh.mesh_dim_names)
    if tuple(x.placements) == placements:
        return x
    with _without_fake_mode():
        return x.redistribute(mesh, placements)


def _size(mesh, axes) -> int:
    size = 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def constrain_batch(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """Constrain dim `batch_dim` of x to the installed batch axes (x
    itself when no context is installed, x is not a DTensor, or the dim
    doesn't divide)."""
    axes = _BATCH_AXES.get()
    mesh = dtensor_mesh(x) if axes is not None else None
    if mesh is None:
        return x
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    # divisibility guard: decode-time groups/batches of 1 stay unsharded
    if x.shape[batch_dim] % _size(mesh, axes) != 0:
        return x
    return _constrain(x, mesh, {batch_dim % x.ndim: axes})


def constrain_expert(x: torch.Tensor, batch_dim: int = 0,
                     expert_dim: int = 1) -> torch.Tensor:
    """MoE dispatch/hidden/combine buffers: group dim on the batch axes,
    expert dim on "model", everything else replicated."""
    axes = _BATCH_AXES.get()
    mesh = dtensor_mesh(x) if axes is not None else None
    if mesh is None:
        return x
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    entries: dict = {}
    if x.shape[batch_dim] % _size(mesh, axes) == 0:
        entries[batch_dim % x.ndim] = axes
    if "model" in mesh.mesh_dim_names \
            and x.shape[expert_dim] % _size(mesh, ("model",)) == 0:
        entries[expert_dim % x.ndim] = ("model",)
    return _constrain(x, mesh, entries)


def local_shard(x, mesh, placements) -> torch.Tensor:
    """This device's shard of ``x`` redistributed to ``placements`` on
    ``mesh`` (a plain tensor is taken as replicated); differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    with _without_fake_mode():
        if dtensor_mesh(x) is None:
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, tuple(placements)).to_local()


def shard_offset(shape, mesh, placements) -> tuple:
    """Where this device's shard of a tensor of global ``shape`` placed
    by ``placements`` starts, dim by dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    with _without_fake_mode():
        return tuple(compute_local_shape_and_global_offset(
            shape, mesh, tuple(placements))[1])


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """x with its pending reductions done: a DTensor's Partial placements
    become Replicate (its shards stay); x itself when x is not a DTensor
    or has none.  A gather over a vocab-sharded dim leaves a masked
    Partial that DTensor can only reduce in the gather's own shape."""
    if dtensor_mesh(x) is None or not any(p.is_partial()
                                          for p in x.placements):
        return x
    from torch.distributed.tensor import Partial, Replicate

    with _without_fake_mode():
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements))


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, the embedding lookup.

    On a DTensor table each device looks up its own shard: where the
    vocab rows are sharded it reads every id that falls in its rows
    (zeros for the others) and the lookups are summed over those axes
    (`reduce_partial`); where the embed columns are sharded it reads
    every id and keeps its columns; elsewhere it reads its own ids, in
    the ids' placements.  So the table is never gathered.  The table's
    gradient comes back in its own placements (a partial sum on the axes
    where each device saw only its own ids)."""
    mesh = dtensor_mesh(table)
    if mesh is None:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ids_pl = ids.placements if dtensor_mesh(ids) is not None \
        else (Replicate(),) * mesh.ndim
    id_pl, out_pl, grad_pl = [], [], []
    for tp, ip in zip(table.placements, ids_pl):
        if tp.is_shard(0) or tp.is_shard(1):
            id_pl.append(Replicate())
            out_pl.append(Partial() if tp.is_shard(0) else Shard(ids.dim()))
            grad_pl.append(tp)
        else:
            id_pl.append(ip)
            out_pl.append(ip)
            grad_pl.append(Partial() if ip.is_shard() else tp)
    loc_ids = local_shard(ids, mesh, id_pl)
    loc = table.to_local(grad_placements=grad_pl)
    rows = loc_ids - shard_offset(table.shape, mesh, table.placements)[0]
    inside = ((rows >= 0) & (rows < loc.shape[0]))[..., None]
    out = torch.where(inside, loc[rows.clamp(0, loc.shape[0] - 1)], 0)
    shape = tuple(ids.shape) + (table.shape[1],)
    return reduce_partial(DTensor.from_local(
        out, mesh, out_pl, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride()))


def scatter_rows_(buf: torch.Tensor, index: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``buf[b, index[b, i]] = rows[b, i]`` in place along dim 1, a ring
    write: buf (B, C, ...), index (B, C') and rows (B, C', ...), or
    index (B,) and rows (B, ...) for one slot a row; returns ``buf``.

    On a DTensor ring each device writes its own rows into its local
    shard, with no collective on the ring: the rows and slots are
    redistributed to the ring's placements (its dim 1 replicated), and
    where dim 1 itself is sharded (the context-parallel layout of a
    decode cache whose kv heads do not divide the model axis) a device
    writes only the slots in its own range of the ring, at the local
    slot, and keeps its other rows (a masked write)."""
    if index.dim() == 1:
        index, rows = index[:, None], rows.unsqueeze(1)
    shape = index.shape + (1,) * (rows.dim() - 2)
    mesh = dtensor_mesh(buf)
    if mesh is None or any(p.is_partial() for p in buf.placements):
        return buf.scatter_(1, index.reshape(shape).expand(rows.shape),
                            rows)
    from torch.distributed.tensor import Replicate, Shard

    # rows and slots follow the ring's placements, its dim 1 replicated
    loc_rows = local_shard(rows, mesh, [Replicate() if p.is_shard(1) else p
                                        for p in buf.placements])
    loc_idx = local_shard(index, mesh, [Shard(0) if p.is_shard(0)
                                        else Replicate()
                                        for p in buf.placements])
    offset = shard_offset(buf.shape, mesh, buf.placements)
    local = buf._local_tensor
    shape = loc_idx.shape + (1,) * (loc_rows.dim() - 2)
    if not any(p.is_shard(1) for p in buf.placements):
        local.scatter_(1, loc_idx.reshape(shape).expand(loc_rows.shape),
                       loc_rows)
        return buf
    slot = loc_idx - offset[1]
    inside = ((slot >= 0) & (slot < local.shape[1])).reshape(shape)
    slot = slot.clamp(0, local.shape[1] - 1).reshape(shape) \
        .expand(loc_rows.shape)
    keep = local.gather(1, slot)
    local.scatter_(1, slot, torch.where(inside, loc_rows, keep))
    return buf


def sdpa_sharded(q, k, v, mask, scale, scores, mix):
    """Attention on DTensors, each device on its own shards: ``scores(q,
    k, mask, scale)`` gives the masked f32 scores (B, Hkv, G, S, T) and
    ``mix(w, v)`` the weighted values (B, S, H, vd) of local tensors (the
    model's `attention._scores` and `_mix`).

    The batch stays on the mesh axes that shard it.  A ring whose slot
    dim is sharded (the context-parallel decode cache) stays so: each
    device scores its own slots for every head, and the softmax's max
    and sum and the weighted values are all-reduced over those axes.
    The query heads stay on the axes that shard them where the kv groups
    split with them (a device reads the kv heads its query heads use,
    from a kv tensor sharded or replicated there).  Every other axis
    replicates.  The result keeps the batch and head placements."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    b, s, h, _ = q.shape
    t, hkv = k.shape[1], k.shape[2]
    k_pl = k.placements if dtensor_mesh(k) is not None \
        else (Replicate(),) * mesh.ndim
    q_pl, kv_pl, m_pl, t_dims = [], [], [], []
    nb = nt = nh = 1
    for d, qp in enumerate(q.placements):
        n = mesh.size(d)
        if qp.is_shard(0) and b % (nb * n) == 0:
            nb *= n
            pls = (Shard(0), Shard(0),
                   Shard(0) if mask.dim() == 3 else Replicate())
        elif k_pl[d].is_shard(1) and t % (nt * n) == 0:
            nt *= n
            t_dims.append(d)
            pls = (Replicate(), Shard(1), Shard(mask.dim() - 1))
        elif qp.is_shard(2) and h % (nh * n) == 0 \
                and (hkv % (nh * n) == 0 or (nh * n) % hkv == 0):
            nh *= n
            pls = (Shard(2), Shard(2) if hkv % nh == 0 else Replicate(),
                   Replicate())
        else:
            pls = (Replicate(),) * 3
        q_pl.append(pls[0])
        kv_pl.append(pls[1])
        m_pl.append(pls[2])
    ql, kl, vl, ml = (local_shard(x, mesh, pl) for x, pl in (
        (q, q_pl), (k, kv_pl), (v, kv_pl), (mask, m_pl)))
    if nh > 1:     # the kv heads of this device's query heads
        g = h // hkv
        q_off = shard_offset(q.shape, mesh, q_pl)
        k_off = shard_offset(k.shape, mesh, kv_pl)
        lo = q_off[2] // g - k_off[2]
        hi = (q_off[2] + ql.shape[2] - 1) // g - k_off[2] + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    if not t_dims:
        w = torch.softmax(scores(ql, kl, ml, scale), dim=-1)
        out = mix(w.to(vl.dtype), vl)
    else:
        logits = scores(ql, kl, ml, scale)
        m = logits.amax(dim=-1, keepdim=True)
        for d in t_dims:
            m = funcol.all_reduce(m, "max", (mesh, d))
        p = torch.exp(logits - m)
        den = p.sum(dim=-1, keepdim=True)
        for d in t_dims:
            den = funcol.all_reduce(den, "sum", (mesh, d))
        out = mix((p / den).to(vl.dtype), vl)
        for d in t_dims:
            out = funcol.all_reduce(out, "sum", (mesh, d))
    shape = (b, s, h, v.shape[-1])
    out_pl = tuple(p if p.is_shard() else Replicate() for p in q_pl)
    return DTensor.from_local(out.contiguous(), mesh, out_pl,
                              run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


class ReplicateRefused(TorchDispatchMode):
    """Run a DTensor op that DTensor cannot shard on more replicated
    operands.

    Some ops have no DTensor sharding strategy for the placements they
    meet (``searchsorted``, a gather from a table sharded on its indexed
    dim, a head split of a dim sharded unevenly, ...).  Under this mode
    such an op is retried with its operands' placements replicated on the
    last mesh dim, then on the last two, and so on (the all-gathers and
    all-reduces those redistributions take are real collectives); an op
    with no strategy at all, or none on fully replicated operands, runs
    on the replicated local tensors.  An in-place op runs out of place
    and its result is written back into its operand in the operand's own
    placements.  ``counts`` keeps, by op, how many calls were retried.
    An op that fails every retry raises its first error.

    DTensor's own bookkeeping (shard offsets, costs) runs on small host
    tensors, so a ``FakeTensorMode`` on the mode stack is set aside while
    DTensor handles an op: the local tensors are fake themselves, so the
    local op stays fake, and the factories of the model code, which run
    outside DTensor, stay under the fake mode.
    """

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        with _without_fake_mode():
            try:
                return func(*args, **kwargs)
            except Exception as err:  # noqa: BLE001 - retried, re-raised
                try:
                    out = _retry(func, args, kwargs, err)
                except Exception as again:
                    raise err from again
        name = str(func)
        self.counts[name] = self.counts.get(name, 0) + 1
        return out


@contextlib.contextmanager
def _without_fake_mode():
    """The current dispatch modes but any FakeTensorMode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes() as modes, contextlib.ExitStack() as st:
        for m in modes:
            if not isinstance(m, FakeTensorMode):
                st.enter_context(m)
        yield


def _out_of_place(func):
    """The out-of-place overload of the in-place op ``func`` (None if it
    has none)."""
    name = func._overloadpacket.__name__.removesuffix("_")
    packet = getattr(torch.ops.aten, name, None)
    return getattr(packet, func._overloadname, None) if packet else None


def _replicated(t, mesh_dims):
    """DTensor ``t`` with its placements on ``mesh_dims`` Replicate."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    pl = tuple(Replicate() if d in mesh_dims else p
               for d, p in enumerate(t.placements))
    return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh,
                                                              pl)


def _retry(func, args, kwargs, err):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten

    flat, spec = tree_flatten((args, kwargs))
    mesh = next(t.device_mesh for t in flat if isinstance(t, DTensor))
    inplace = any(r.alias_info is not None and r.alias_info.is_write
                  for r in func._schema.returns)
    op = _out_of_place(func) if inplace else func
    no_strategy = isinstance(err, NotImplementedError)
    for k in reversed(range(mesh.ndim)):
        if op is None or no_strategy:
            break
        dims = set(range(k, mesh.ndim))
        a, kw = tree_unflatten([_replicated(t, dims) for t in flat], spec)
        try:
            out = op(*a, **kw)
        except Exception:  # noqa: BLE001 - next, more replicated try
            continue
        return _write_back(args[0], out) if inplace else out
    # every device runs the op unsharded on the local tensors
    rep = (Replicate(),) * mesh.ndim
    locs = [_replicated(t, set(range(mesh.ndim)))._local_tensor
            if isinstance(t, DTensor) else t for t in flat]
    if inplace and isinstance(args[0], DTensor):
        locs[0] = locs[0].clone()   # written back below, in its placements
    largs, lkwargs = tree_unflatten(locs, spec)
    out = func(*largs, **lkwargs)
    if inplace:
        if not isinstance(args[0], DTensor):
            return args[0]          # a plain operand was written itself
        return _write_back(args[0], DTensor.from_local(
            largs[0], mesh, rep, run_check=False))
    oflat, ospec = tree_flatten(out)
    return tree_unflatten(
        [DTensor.from_local(t, mesh, rep, run_check=False)
         if isinstance(t, torch.Tensor) else t for t in oflat], ospec)


def _write_back(self_, value):
    """Write DTensor ``value`` into ``self_`` (an in-place op's operand)
    in self_'s own placements; a Partial(sum) dim of self_ keeps the
    value on its first coordinate and zeros on the others."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = value.device_mesh
    if not isinstance(self_, DTensor):
        full = value.redistribute(mesh, (Replicate(),) * mesh.ndim)
        self_.copy_(full._local_tensor)
        return self_
    target = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in self_.placements)
    back = value.redistribute(mesh, target)._local_tensor
    if any(isinstance(p, Partial) and mesh.get_local_rank(d) != 0
           for d, p in enumerate(self_.placements)):
        back = torch.zeros_like(back)
    self_._local_tensor.copy_(back)
    return self_
