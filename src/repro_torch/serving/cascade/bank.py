"""`ModelBank` — the ladder of models one cascade server hosts
(DESIGN.md §10).

A multi-model cascade concatenates each model's T-Tamer nodes (ramps +
final head) into ONE global node line, in escalation order: model 0's
nodes come first, model 1's after, and so on.  A strategy built over the
combined `Cascade` (``boundaries`` = nodes per model, edge costs from
``solve_skip(mode="cascade")``) then decides per token which nodes to
probe — and therefore which MODELS to consult — with no cascade-specific
strategy code at all.

The bank is pure bookkeeping: per-model specs (configs + params for real
serving, virtual cost parameters for simulation) plus the node-offset
arithmetic every other cascade component leans on.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelSpec", "ModelBank"]


@dataclasses.dataclass
class ModelSpec:
    """One ladder rung.

    Real serving fills ``cfg``/``params`` (``n_nodes`` is then derived
    and must match ``cfg.n_ramps + 1``); simulation fills the virtual
    cost knobs instead.  ``n_lanes`` is the rung's decode width — rung 0
    is the admission width (one Server slot per rung-0 lane), deeper
    rungs are the escalation capacity.
    """

    name: str
    n_nodes: int
    n_lanes: int = 1
    cfg: object = None             # ModelConfig (real serving)
    params: object = None
    # simulation cost model (virtual units)
    seg_time: float = 1.0          # one node-probe on this model
    prefill_tok_time: float = 0.0  # one prompt/catch-up token


class ModelBank:
    """The ladder: specs in escalation order + node-offset arithmetic."""

    def __init__(self, specs):
        self.specs = tuple(specs)
        if not self.specs:
            raise ValueError("a cascade needs at least one model")
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names {names}")
        for s in self.specs:
            if s.n_nodes < 1 or s.n_lanes < 1:
                raise ValueError(f"model {s.name!r}: n_nodes and n_lanes "
                                 "must be >= 1")
            if s.cfg is not None and s.cfg.n_ramps + 1 != s.n_nodes:
                raise ValueError(
                    f"model {s.name!r}: n_nodes={s.n_nodes} != "
                    f"cfg ramps+head={s.cfg.n_ramps + 1}")
        vocabs = {s.cfg.vocab for s in self.specs if s.cfg is not None}
        if len(vocabs) > 1:
            raise ValueError(
                f"cascade models must share tokenization (one vocab); "
                f"got {sorted(vocabs)} — escalation re-prefills the same "
                "token ids on the target model")
        self._offsets = []
        off = 0
        for s in self.specs:
            self._offsets.append(off)
            off += s.n_nodes
        self.n_total = off

    def __len__(self) -> int:
        return len(self.specs)

    def __getitem__(self, m: int) -> ModelSpec:
        return self.specs[m]

    @property
    def boundaries(self) -> tuple:
        return tuple(s.n_nodes for s in self.specs)

    def offset(self, m: int) -> int:
        """Global id of model ``m``'s first node."""
        return self._offsets[m]

    def node_range(self, m: int) -> tuple[int, int]:
        return self._offsets[m], self._offsets[m] + self.specs[m].n_nodes

    def model_of(self, node: int) -> int:
        """Which ladder model owns global node ``node``."""
        for m in range(len(self.specs) - 1, -1, -1):
            if node >= self._offsets[m]:
                return m
        raise ValueError(f"negative node {node}")
