"""Carry weights and solved tables into the port from numpy.

Everything here takes numpy arrays (or objects whose attributes are
numpy arrays) and imports nothing of any other framework: a caller
holding another framework's arrays converts them to numpy first, e.g.
``jax.tree.map(np.asarray, params)``.  The tests use it so that two
implementations compute the same function on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.line_dp import LineTables
from repro_torch.core.markov import MarkovChain
from repro_torch.core.skip_dp import SkipTables
from repro_torch.core.support import Support

__all__ = ["to_tensor", "params_from_numpy", "opt_state_from_numpy",
           "support_from_numpy",
           "chain_from_numpy", "line_tables_from_numpy",
           "skip_tables_from_numpy"]


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A copy of numpy array ``a`` as a tensor of the same dtype.  A
    tensor (a ``bfloat16`` leaf of `training.checkpoint.load`, which
    numpy has no dtype for) is copied as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, copy=True)
    return torch.tensor(np.array(a), device=device)


def params_from_numpy(np_tree, device="cpu"):
    """A nested dict/list tree of numpy arrays -> the same tree of
    tensors on ``device`` (the layout `repro_torch.models.model`
    reads: ``params["segments"][si]["blocks"]["attn"]["wq"]`` is
    ``(L, D, H*hd)``)."""
    if isinstance(np_tree, dict):
        return {k: params_from_numpy(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in np_tree]
    return to_tensor(np_tree, device)


def opt_state_from_numpy(state, device="cpu") -> dict:
    """An AdamW state ``{"mu", "nu", "step"}`` of numpy arrays (the JAX
    package's ``init_opt_state`` layout) -> the port's: f32 moment trees
    and a 0-dim int32 step on ``device``."""
    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [f32(v) for v in tree]
        return to_tensor(tree, device).float()
    return {"mu": f32(state["mu"]), "nu": f32(state["nu"]),
            "step": to_tensor(state["step"], device).to(torch.int32)
            .reshape(())}


def support_from_numpy(s, device="cpu") -> Support:
    """An object with numpy ``grid``/``edges`` -> `Support`."""
    return Support(grid=to_tensor(s.grid, device).float(),
                   edges=to_tensor(s.edges, device).float())


def chain_from_numpy(c, device="cpu") -> MarkovChain:
    """An object with numpy ``p0``/``trans`` -> `MarkovChain`."""
    return MarkovChain(p0=to_tensor(c.p0, device).float(),
                       trans=to_tensor(c.trans, device).float())


def line_tables_from_numpy(t, device="cpu") -> LineTables:
    """An object with numpy ``cont``/``stop``/``phi``/``sigma``/``value``
    -> `LineTables`."""
    return LineTables(cont=to_tensor(t.cont, device).float(),
                      stop=to_tensor(t.stop, device).bool(),
                      phi=to_tensor(t.phi, device).float(),
                      sigma=to_tensor(t.sigma, device).float(),
                      value=to_tensor(t.value, device).float())


def skip_tables_from_numpy(t, device="cpu") -> SkipTables:
    """An object with numpy ``value_tab``/``nxt``/``value`` ->
    `SkipTables`."""
    return SkipTables(value_tab=to_tensor(t.value_tab, device).float(),
                      nxt=to_tensor(t.nxt, device).to(torch.int32),
                      value=to_tensor(t.value, device).float())
