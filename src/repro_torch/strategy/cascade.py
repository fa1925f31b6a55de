"""`Cascade` — the calibrated serving spec a strategy is built from:
per-node costs in objective units, the discrete loss `Support`, the
fitted Markov chain, and the solved DP tables (line and, on demand,
skip).  ``strategy.make(name, cascade)`` reads whichever pieces the
named strategy needs.

Construction paths:

  * `Cascade.from_traces(losses, costs, ...)`      — offline traces.
  * `Cascade.from_model_traces(...)`               — per-model traces of
    a multi-model ladder over the same inputs.
  * `Cascade.calibrate(params, cfg, tokens, lam)`  — run a model on
    explicit calibration prompts and fit from its ramp losses (the
    serving launcher draws the prompts with numpy from its seed).
  * `Cascade.uniform(n)`                           — placeholder spec
    for strategies that need no tables (thresholds, patience, fixed
    endpoints).

``use_kernel`` on a cascade runs its line solve's backups through the
Bellman-backup kernel, whether the solve happens at construction or
later, when a strategy asks for the tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import skip_dp
from repro_torch.core.line_dp import LineTables, solve_line
from repro_torch.core.markov import MarkovChain, estimate_chain
from repro_torch.core.skip_dp import SkipTables
from repro_torch.core.support import Support, build_support, quantize

__all__ = ["Cascade"]

SKIP_MODES = ("cumulative", "skip_free", "cascade")


@dataclasses.dataclass
class Cascade:
    """Calibrated cascade spec: topology + costs + support + tables."""

    support: Support
    chain: MarkovChain
    costs: torch.Tensor                    # (n,) objective-unit costs
    lam: float = 1.0                       # loss scale the tables assume
    line_tables: LineTables | None = None
    skip_tables: SkipTables | None = None
    edge_costs: np.ndarray | None = None   # (n+1, n+1), set by solve_skip
    skip_mode: str | None = None
    # multi-model cascades: consecutive node counts per model (ladder
    # order) — None means the classic single-model line
    boundaries: tuple | None = None
    entry_costs: tuple | None = None       # per-model escalation charge
    use_kernel: bool = False               # line solve via the kernel

    @property
    def n_nodes(self) -> int:
        return self.chain.n

    @property
    def n_models(self) -> int:
        return 1 if self.boundaries is None else len(self.boundaries)

    def node_model(self, node: int) -> int:
        """Which ladder model owns global node ``node``."""
        if self.boundaries is None:
            return 0
        acc = 0
        for m, b in enumerate(self.boundaries):
            acc += b
            if node < acc:
                return m
        raise ValueError(f"node {node} out of range ({acc} nodes)")

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_traces(cls, losses, costs, *, k: int = 32, lam: float = 1.0,
                    min_cost: float = 1e-6, solve: bool = True,
                    boundaries=None, entry_costs=None, device="cpu",
                    use_kernel: bool = False) -> "Cascade":
        """Fit support + chain from (T, n) RAW loss traces (scaled by
        ``lam`` before the support fit) and, with ``solve``, solve the
        line DP.  ``costs`` are taken as-is and clamped to ``min_cost``
        (Assumption 2.1 needs strictly positive costs).  ``boundaries``
        declares a multi-model cascade: the n trace columns are the
        concatenated node ladders of several models, in escalation order
        (what ``solve_skip(mode="cascade")`` prices)."""
        scaled = lam * np.asarray(losses)
        support = build_support(scaled, k, device=device)
        chain = estimate_chain(quantize(support, torch.as_tensor(scaled)), k)
        costs = torch.clamp(torch.as_tensor(costs, dtype=torch.float32,
                                            device=device), min=min_cost)
        if boundaries is not None:
            boundaries = tuple(int(b) for b in boundaries)
            if sum(boundaries) != scaled.shape[1]:
                raise ValueError(
                    f"boundaries {boundaries} do not cover the "
                    f"{scaled.shape[1]} trace columns")
        if entry_costs is not None:
            entry_costs = tuple(float(c) for c in entry_costs)
        casc = cls(support=support, chain=chain, costs=costs, lam=lam,
                   boundaries=boundaries, entry_costs=entry_costs,
                   use_kernel=use_kernel)
        if solve:
            casc.solve_line()
        return casc

    @classmethod
    def from_model_traces(cls, model_losses, model_costs, *, k: int = 32,
                          lam: float = 1.0, entry_costs=None,
                          solve: bool = True, **kwargs) -> "Cascade":
        """Multi-model calibration: per-model (T, n_m) loss traces over
        the SAME T calibration inputs, concatenated in ladder order; the
        result's ``boundaries`` record where each model's nodes start,
        ready for ``solve_skip(mode="cascade")``."""
        model_losses = [np.asarray(ls) for ls in model_losses]
        t = model_losses[0].shape[0]
        if any(ls.shape[0] != t for ls in model_losses):
            raise ValueError("per-model traces must share the T axis "
                             "(same calibration inputs)")
        boundaries = tuple(ls.shape[1] for ls in model_losses)
        costs = np.concatenate([np.asarray(c, np.float64)
                                for c in model_costs])
        if len(costs) != sum(boundaries):
            raise ValueError(f"model_costs cover {len(costs)} nodes, "
                             f"traces have {sum(boundaries)}")
        return cls.from_traces(np.concatenate(model_losses, axis=1),
                               costs, k=k, lam=lam, solve=solve,
                               boundaries=boundaries,
                               entry_costs=entry_costs, **kwargs)

    @classmethod
    def calibrate(cls, params, cfg, tokens, lam: float, *, k: int = 24,
                  solve: bool = True, use_flash: bool = False,
                  use_ssd_kernel: bool = False,
                  use_kernel: bool = False) -> "Cascade":
        """Fit a cascade from a model's own ramp losses on the (T, seq)
        calibration prompts ``tokens`` (the serving launcher's
        calibration step); every node costs ``(1 - lam) / n``.
        ``use_flash`` runs the calibration prefill's attention through
        the flash-attention kernel, ``use_ssd_kernel`` its SSD chunks
        through the ssd-chunk kernel, ``use_kernel`` the line solve's
        backups through the Bellman-backup kernel; without ``solve`` the
        tables are solved when a strategy first asks for them."""
        from repro_torch.models import model as M   # keep core import light
        device = params["embed"]["table"].device
        tokens = torch.tensor(np.asarray(tokens), device=device)
        with torch.no_grad():
            _, _, node_losses, _ = M.prefill(
                params, cfg, {"tokens": tokens}, tokens.shape[1] + 8,
                use_flash=use_flash, use_ssd_kernel=use_ssd_kernel)
        raw = node_losses.cpu().numpy()
        n = raw.shape[1]
        costs = (1.0 - lam) * np.full((n,), 1.0 / n)
        return cls.from_traces(raw, costs, k=k, lam=lam, solve=solve,
                               device=device, use_kernel=use_kernel)

    @classmethod
    def uniform(cls, n_nodes: int, *, k: int = 8, lam: float = 1.0,
                costs=None, boundaries=None, device="cpu") -> "Cascade":
        """Placeholder spec (uniform chain over a linear grid, equal
        costs unless given) for strategies that consume only the
        topology and costs."""
        grid = torch.linspace(0.1, 1.0, k, dtype=torch.float32,
                              device=device)
        support = Support(grid=grid, edges=(grid[1:] + grid[:-1]) / 2)
        p0 = torch.full((k,), 1.0 / k, device=device)
        trans = torch.full((max(n_nodes - 1, 0), k, k), 1.0 / k,
                           device=device)
        if costs is None:
            costs = np.full((n_nodes,), 1.0 / n_nodes)
        if boundaries is not None:
            boundaries = tuple(int(b) for b in boundaries)
            if sum(boundaries) != n_nodes:
                raise ValueError(f"boundaries {boundaries} do not cover "
                                 f"{n_nodes} nodes")
        return cls(support=support, chain=MarkovChain(p0=p0, trans=trans),
                   costs=torch.as_tensor(costs, dtype=torch.float32,
                                         device=device),
                   lam=lam, boundaries=boundaries)

    def refit(self, losses) -> "Cascade":
        """Re-fit support + chain from NEW raw loss rows at this spec's
        lambda and support size, keeping costs, boundaries and entry
        costs, and re-solve the same table families.  Same support size
        and node count give tables of the same shapes, so a strategy
        rebuilt from the result keeps its bank slot's signature."""
        losses = np.asarray(losses)
        if losses.ndim != 2 or losses.shape[1] != self.n_nodes:
            raise ValueError(f"refit rows have shape {losses.shape}; "
                             f"this cascade expects (T, {self.n_nodes})")
        casc = Cascade.from_traces(
            losses, self.costs.cpu().numpy(), k=self.support.size,
            lam=self.lam, solve=False, boundaries=self.boundaries,
            entry_costs=self.entry_costs, device=self.costs.device,
            use_kernel=self.use_kernel)
        if self.line_tables is not None:
            casc.solve_line()
        if self.skip_tables is not None:
            casc.solve_skip(self.skip_mode)
        return casc

    # ------------------------------------------------------------------
    # solvers (cached on the spec)
    # ------------------------------------------------------------------

    def solve_line(self) -> LineTables:
        """Solve (and cache) the with-recall line DP (Alg. 2)."""
        if self.line_tables is None:
            self.line_tables = solve_line(self.chain, self.costs,
                                          self.support,
                                          use_kernel=self.use_kernel)
        return self.line_tables

    def solve_skip(self, mode: str = "cumulative") -> SkipTables:
        """Solve (and cache) the transitive-closure DP (§5.2).

        ``mode`` picks the edge-cost semantics: ``"cumulative"``
        (intra-model early exit: skipped segments still pay backbone
        compute), ``"skip_free"`` (skipped models are never run), or
        ``"cascade"`` (the multi-model ladder of ``boundaries``:
        cumulative inside a model, skip-free across, plus
        ``entry_costs``).
        """
        if mode not in SKIP_MODES:
            raise ValueError(f"unknown skip mode {mode!r}")
        if mode == "cascade" and self.boundaries is None:
            raise ValueError(
                "skip mode 'cascade' needs multi-model boundaries — "
                "calibrate via Cascade.from_model_traces (or pass "
                "boundaries= to from_traces)")
        if self.skip_tables is None or self.skip_mode != mode:
            costs = self.costs.cpu().numpy().astype(np.float64)
            if mode == "cascade":
                self.edge_costs = skip_dp.edge_costs_cascade(
                    costs, self.boundaries, entry_costs=self.entry_costs)
            elif mode == "cumulative":
                self.edge_costs = skip_dp.edge_costs_cumulative(costs)
            else:
                self.edge_costs = skip_dp.edge_costs_skip_free(costs)
            self.skip_tables = skip_dp.solve_skip(self.chain,
                                                  self.edge_costs,
                                                  self.support)
            self.skip_mode = mode
        return self.skip_tables
