"""T-Tamer's calibration and decisions, plainly (paper arXiv:2509.22992,
Alg. 1 and 2): a quantile support over the lambda-scaled calibration
losses, a Laplace-smoothed Markov chain over their bins, the with-recall
line DP solved backward in float64, and the recall-index walk that reads
its stop table.  Ties break toward stopping (Def. 4.4)."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Tables", "calibrate", "RecallWalk", "FixedWalk", "walker"]

INF_MULT = 1e4           # the X axis' finite "+inf": grid[-1] * 1e4 + 1e4


@dataclasses.dataclass(frozen=True)
class Tables:
    grid: np.ndarray      # (K,) f32 support values
    edges: np.ndarray     # (K-1,) f32 bin edges
    stop: np.ndarray      # (n, K, K+2) bool: stop before probing node i
    value: float          # online-optimal expected total loss
    costs: np.ndarray     # (n,) node costs
    lam: float


def _support(scaled: np.ndarray, k: int):
    flat = np.asarray(scaled, np.float64).reshape(-1)
    flat = flat[np.isfinite(flat)]
    lo = float(flat.min())
    flat = flat + (0.0 if lo > 0 else 1e-6 - lo)
    grid = np.maximum.accumulate(np.quantile(flat, np.linspace(0, 1, k)))
    eps = max(1e-9, 1e-9 * float(grid[-1]))
    for i in range(1, k):
        if grid[i] <= grid[i - 1]:
            grid[i] = grid[i - 1] + eps
    edges = (grid[1:] + grid[:-1]) / 2.0
    return grid.astype(np.float32), edges.astype(np.float32)


def bins(edges: np.ndarray, x) -> np.ndarray:
    """Bin of each value: the first edge at or above it."""
    return np.searchsorted(edges, np.asarray(x, np.float32), side="left")


def _chain(b: np.ndarray, k: int, alpha: float = 0.5):
    t, n = b.shape
    p0 = np.bincount(b[:, 0], minlength=k) + alpha
    p0 = p0 / p0.sum()
    trans = np.zeros((max(n - 1, 0), k, k))
    for i in range(n - 1):
        counts = np.zeros((k, k))
        np.add.at(counts, (b[:, i], b[:, i + 1]), 1.0)
        counts += alpha
        trans[i] = counts / counts.sum(axis=1, keepdims=True)
    return p0, trans


def _solve(grid, p0, trans, costs):
    """Backward line DP over X = [0, v_1..v_K, inf]: cont[i, s, x] =
    c_i + sum_y P_i(s, y) * Phi_{i+1}(min(x, v_y), y), Phi_i = min(x,
    cont_i), Phi_n(x) = x; node 0's row is p0 for every s."""
    k = grid.shape[0]
    n = trans.shape[0] + 1
    g = grid.astype(np.float64)
    xv = np.concatenate([[0.0], g, [g[-1] * INF_MULT + INF_MULT]])
    # X index of min(xv[x], grid[y])
    mi = np.where(xv[:, None] <= g[None, :],
                  np.arange(k + 2)[:, None], np.arange(1, k + 1)[None, :])
    full = np.concatenate([np.broadcast_to(p0, (1, k, k)), trans], axis=0)
    phi = np.broadcast_to(xv, (k, k + 2)).copy()
    cont = np.zeros((n, k, k + 2))
    for i in range(n - 1, -1, -1):
        m = phi[np.arange(k)[:, None], mi.T]           # (K, X): [y, x]
        cont[i] = costs[i] + full[i] @ m
        phi = np.minimum(xv[None, :], cont[i])
    stop = xv[None, None, :] <= cont
    return stop, float(cont[0, 0, k + 1])


def calibrate(node_losses: np.ndarray, lam: float, k: int) -> Tables:
    """Tables from (T, n) raw calibration losses (1 - max softmax of each
    node at each prompt's last position); every node costs (1 - lam) /
    n."""
    n = node_losses.shape[1]
    scaled = lam * np.asarray(node_losses, np.float64)
    grid, edges = _support(scaled, k)
    b = bins(edges, scaled.astype(np.float32))
    p0, trans = _chain(b, k)
    costs = np.maximum((1.0 - lam) * np.full(n, 1.0 / n), 1e-6)
    stop, value = _solve(grid, p0, trans, costs.astype(np.float32))
    return Tables(grid=grid, edges=edges, stop=stop, value=value,
                  costs=costs, lam=lam)


class RecallWalk:
    """Alg. 1 for one token: probe while the stop table says continue,
    serve the probed node of least scaled loss (the first on ties)."""

    def __init__(self, tables: Tables):
        self.t = tables
        self.n = tables.stop.shape[0]
        k = tables.grid.shape[0]
        self.x_idx, self.s_bin = k + 1, 0
        self.best_loss, self.best_node = np.inf, 0

    def observe(self, node: int, ell: float) -> bool:
        scaled = np.float32(self.t.lam) * np.float32(ell)
        b = int(bins(self.t.edges, scaled))
        if scaled < self.best_loss:
            self.best_loss, self.best_node = scaled, node
        self.x_idx = min(self.x_idx, b + 1)
        self.s_bin = b
        nxt = min(node + 1, self.n - 1)
        stop = bool(self.t.stop[nxt, self.s_bin, self.x_idx])
        return (not stop) and node + 1 < self.n

    def serve(self) -> int:
        return self.best_node


class FixedWalk:
    """A fixed node (``always_last``: the last; ``always_first``: 0)."""

    def __init__(self, n: int, node: int):
        self.n, self.node = n, node % n

    def observe(self, node: int, ell: float) -> bool:
        return node < self.node

    def serve(self) -> int:
        return self.node


def walker(strategy: str, tables: Tables, n: int):
    """A fresh one-token walk of the named strategy."""
    if strategy == "recall_index":
        return RecallWalk(tables)
    if strategy == "always_last":
        return FixedWalk(n, n - 1)
    if strategy == "always_first":
        return FixedWalk(n, 0)
    raise ValueError(f"the reference has no walk for {strategy!r}")
