"""Dynamic indexing over the transitive closure of a directed line
(paper §5.2).

After probing node i the policy may jump to ANY later node j > i
(skipping intermediates), paying edge cost ``C[i+1, j+1]``; the
conditional loss distribution across the skip is the Chapman-Kolmogorov
product ``P^{(i->j)} = prod_t trans[t]``.  Bellman recursion (App. C.3):

    Phi(X, s, i) = min{ X, min_{j > i} [ C(i,j) + E_{R_j|R_i=s} Phi(min(X,R_j), R_j, j) ] }

Enumerating successors costs an extra factor n over the single line
(Thm 5.2); inference stays O(1) a node through the precomputed NEXT
table (stop, or which node to probe next).  The solve runs in f32 on the
device of the support, in the JAX package's order of operations: the
products ``cum[i][j] = cum[i][j-1] @ trans[j-1]``, one gather + matmul a
successor, and the strict ``cont < best`` rule, so that of equal values
the nearest successor (or stopping) wins.  The edge-cost constructors
and `simulate_skip` are numpy.

X-axis conventions follow ``line_dp`` (K+2 entries: 0, grid, +inf).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import line_dp
from repro_torch.core.markov import MarkovChain
from repro_torch.core.support import Support

__all__ = ["SkipTables", "solve_skip", "simulate_skip", "STOP",
           "edge_costs_skip_free", "edge_costs_cumulative",
           "edge_costs_cascade"]

STOP = -1  # NEXT-table entry meaning "stop and serve the argmin"


@dataclasses.dataclass(frozen=True)
class SkipTables:
    value_tab: torch.Tensor  # (n+1, K, K+2) f32 — V[l+1][s, x]; row 0 = root
    nxt: torch.Tensor        # (n+1, K, K+2) i32 — STOP or next node to probe
    value: torch.Tensor      # () f32 — online-optimal expected loss

    @property
    def n(self) -> int:
        return int(self.value_tab.shape[0]) - 1

    @property
    def k(self) -> int:
        return int(self.value_tab.shape[1])


def edge_costs_skip_free(costs: np.ndarray) -> np.ndarray:
    """C[i, j] = c_{j-1}: skipping avoids intermediate costs entirely
    (inter-model cascades: skipped models are simply never run)."""
    n = len(costs)
    c = np.zeros((n + 1, n + 1), np.float32)
    for j in range(1, n + 1):
        c[:j, j] = costs[j - 1]
    return c


def edge_costs_cumulative(costs: np.ndarray) -> np.ndarray:
    """C[i, j] = sum_{t in (i..j]} c_t: skipping still pays the backbone
    compute of intermediate segments, only their ramp heads are saved
    (intra-model early exit: you cannot skip backbone layers)."""
    n = len(costs)
    pref = np.concatenate([[0.0], np.cumsum(costs)])
    c = np.zeros((n + 1, n + 1), np.float32)
    for i in range(n + 1):
        for j in range(i + 1, n + 1):
            c[i, j] = pref[j] - pref[i]
    return c


def edge_costs_cascade(costs: np.ndarray, boundaries,
                       entry_costs=None) -> np.ndarray:
    """Multi-model cascade edge costs: the node line is cut into
    consecutive per-model groups (``boundaries`` = nodes per model, in
    ladder order).  An edge WITHIN a model is cumulative (skipped ramps
    still pay their backbone segments); an edge INTO a later model (or
    from the root) pays that model's own segments from its first through
    node j, never the source model's remaining ones, plus the optional
    per-model escalation charge ``entry_costs[m]``.  With one model this
    is `edge_costs_cumulative`."""
    costs = np.asarray(costs, np.float64)
    n = len(costs)
    boundaries = tuple(int(b) for b in boundaries)
    if any(b < 1 for b in boundaries) or sum(boundaries) != n:
        raise ValueError(f"boundaries {boundaries} must be positive and "
                         f"sum to n_nodes={n}")
    if entry_costs is None:
        entry_costs = np.zeros(len(boundaries), np.float64)
    entry_costs = np.asarray(entry_costs, np.float64)
    if entry_costs.shape != (len(boundaries),):
        raise ValueError(f"entry_costs shape {entry_costs.shape} != "
                         f"({len(boundaries)},)")
    model_of = np.repeat(np.arange(len(boundaries)), boundaries)
    # cum[j] = model-local cumulative cost from model(j)'s first segment
    # through node j's segment (inclusive)
    cum = np.zeros(n, np.float64)
    start = 0
    for b in boundaries:
        cum[start:start + b] = np.cumsum(costs[start:start + b])
        start += b
    c = np.zeros((n + 1, n + 1), np.float64)
    for j in range(n):
        for i in range(-1, j):
            if i >= 0 and model_of[i] == model_of[j]:
                c[i + 1, j + 1] = cum[j] - cum[i]
            else:
                c[i + 1, j + 1] = cum[j] + entry_costs[model_of[j]]
    return c.astype(np.float32)


def solve_skip(chain: MarkovChain, edge_costs, support: Support
               ) -> SkipTables:
    """Exact DP for the skip (transitive-closure) setting.

    Args:
      chain: Markov chain over binned losses, n nodes.
      edge_costs: (n+1, n+1); [i+1, j+1] = cost of probing j right after
        i, row/col 0 = the root.  Use the constructors above.
      support: the common discrete support V (its device is the solve's).
    """
    n, k = chain.n, chain.k
    grid = support.grid
    dev = grid.device
    xvals = line_dp.x_values(grid)
    mi_t = line_dp._min_index_matrix(grid).T.contiguous()   # (K, K+2)
    ec = torch.as_tensor(np.asarray(edge_costs, np.float32), device=dev)
    p0, trans = chain.p0.to(dev), chain.trans.to(dev)

    # cumulative conditionals cum[i][j] = P^{(i->j)}
    cum = [[None] * n for _ in range(n)]
    for i in range(n):
        acc = torch.eye(k, dtype=torch.float32, device=dev)
        cum[i][i] = acc
        for j in range(i + 1, n):
            acc = acc @ trans[j - 1]
            cum[i][j] = acc

    stop_val = xvals[None, :].expand(k, k + 2).contiguous()   # (K, K+2)
    v = [None] * (n + 1)                   # v[l+1] indexed by last = l
    nxt = [None] * (n + 1)
    for last in range(n - 1, -2, -1):
        best = stop_val
        best_j = torch.full((k, k + 2), STOP, dtype=torch.int32, device=dev)
        for j in range(last + 1, n):
            if last < 0:
                row_mat = (p0 @ cum[0][j])[None, :].expand(k, k)
            else:
                row_mat = cum[last][j]     # (K, K) Pr[R_j = y | R_last = s]
            m = torch.gather(v[j + 1], 1, mi_t)               # (K, K+2)
            cont = ec[last + 1, j + 1] + row_mat @ m
            take = cont < best
            best_j = torch.where(take, j, best_j)
            best = torch.minimum(best, cont)
        v[last + 1], nxt[last + 1] = best, best_j

    value_tab = torch.stack(v)
    return SkipTables(value_tab=value_tab, nxt=torch.stack(nxt),
                      value=value_tab[0, 0, k + 1])


def simulate_skip(tables: SkipTables, losses: np.ndarray, bins: np.ndarray,
                  edge_costs: np.ndarray):
    """Run the skip policy on traces; returns (served_loss, explore_cost,
    probed_mask) per sample.  Numpy reference implementation."""
    t, n = bins.shape
    k = tables.k
    nxt = tables.nxt.cpu().numpy()
    served = np.zeros(t, np.float32)
    spent = np.zeros(t, np.float32)
    probed = np.zeros((t, n), bool)
    for r in range(t):
        last, s, x_idx = -1, 0, k + 1
        best = np.inf
        while True:
            j = int(nxt[last + 1, s, x_idx])
            if j == STOP:
                break
            spent[r] += edge_costs[last + 1, j + 1]
            probed[r, j] = True
            best = min(best, float(losses[r, j]))
            s = int(bins[r, j])
            x_idx = min(x_idx, s + 1)
            last = j
            if last == n - 1:
                break
        served[r] = best
    return served, spent, probed
