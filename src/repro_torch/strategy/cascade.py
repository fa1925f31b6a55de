"""`Cascade` — the calibrated serving spec a strategy is built from:
per-node costs in objective units, the discrete loss `Support`, the
fitted Markov chain, and the solved line DP tables.

Construction paths:

  * `Cascade.from_traces(losses, costs, ...)`      — offline traces.
  * `Cascade.calibrate(params, cfg, tokens, lam)`  — run a model on
    explicit calibration prompts and fit from its ramp losses (the
    serving launcher draws the prompts with numpy from its seed).
  * `Cascade.uniform(n)`                           — placeholder spec
    for strategies that need no tables (fixed endpoints).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.line_dp import LineTables, solve_line
from repro_torch.core.markov import MarkovChain, estimate_chain
from repro_torch.core.support import Support, build_support, quantize

__all__ = ["Cascade"]

_MIN_COST = 1e-6      # Assumption 2.1 needs strictly positive costs


@dataclasses.dataclass
class Cascade:
    """Calibrated cascade spec: costs + support + chain + tables."""

    support: Support
    chain: MarkovChain
    costs: torch.Tensor                    # (n,) objective-unit costs
    lam: float = 1.0                       # loss scale the tables assume
    line_tables: LineTables | None = None

    @property
    def n_nodes(self) -> int:
        return self.chain.n

    @classmethod
    def from_traces(cls, losses, costs, *, k: int = 32, lam: float = 1.0,
                    device="cpu", use_kernel: bool = False) -> "Cascade":
        """Fit support + chain from (T, n) RAW loss traces (scaled by
        ``lam`` before the support fit) and solve (``use_kernel``: the
        solve's backups run through the Bellman-backup kernel).
        ``costs`` are taken as-is and clamped to ``_MIN_COST``."""
        scaled = lam * np.asarray(losses)
        support = build_support(scaled, k, device=device)
        chain = estimate_chain(quantize(support, torch.as_tensor(scaled)), k)
        costs = torch.clamp(torch.as_tensor(costs, dtype=torch.float32,
                                            device=device), min=_MIN_COST)
        casc = cls(support=support, chain=chain, costs=costs, lam=lam)
        casc.solve_line(use_kernel=use_kernel)
        return casc

    @classmethod
    def calibrate(cls, params, cfg, tokens, lam: float, *, k: int = 24,
                  use_flash: bool = False, use_ssd_kernel: bool = False,
                  use_kernel: bool = False) -> "Cascade":
        """Fit a cascade from a model's own ramp losses on the (T, seq)
        calibration prompts ``tokens`` (the serving launcher's
        calibration step); every node costs ``(1 - lam) / n``.
        ``use_flash`` runs the calibration prefill's attention through
        the flash-attention kernel, ``use_ssd_kernel`` its SSD chunks
        through the ssd-chunk kernel, ``use_kernel`` the line solve's
        backups through the Bellman-backup kernel."""
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
        return cls.from_traces(raw, costs, k=k, lam=lam, device=device,
                               use_kernel=use_kernel)

    @classmethod
    def uniform(cls, n_nodes: int, *, lam: float = 1.0,
                device="cpu") -> "Cascade":
        """Placeholder spec (uniform chain over an 8-point linear grid,
        equal costs) for strategies that consume only the topology."""
        k = 8
        grid = torch.linspace(0.1, 1.0, k, dtype=torch.float32,
                              device=device)
        support = Support(grid=grid, edges=(grid[1:] + grid[:-1]) / 2)
        p0 = torch.full((k,), 1.0 / k, device=device)
        trans = torch.full((max(n_nodes - 1, 0), k, k), 1.0 / k,
                           device=device)
        costs = torch.full((n_nodes,), 1.0 / n_nodes, device=device)
        return cls(support=support, chain=MarkovChain(p0=p0, trans=trans),
                   costs=costs, lam=lam)

    def solve_line(self, use_kernel: bool = False) -> LineTables:
        """Solve (and cache) the with-recall line DP (Alg. 2);
        ``use_kernel`` runs its backups through the Bellman-backup
        kernel."""
        if self.line_tables is None:
            self.line_tables = solve_line(self.chain, self.costs,
                                          self.support,
                                          use_kernel=use_kernel)
        return self.line_tables
