"""Exact expectimax oracles for small instances (test-only, pure numpy).

These compute the online-optimal expected loss by direct minimization over
ALL adaptive probe/stop policies — no index structure, no if-stop tables —
and serve as the independent ground truth that the DP solvers (line, skip,
multi-line, tree) are validated against in the property tests
(Thm 4.5 / 5.1 / 5.2 optimality claims).

Exponential in n and |V|; use with n <= 6, K <= 4.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["bf_line", "bf_skip", "bf_forest"]


def bf_line(p0: np.ndarray, trans: np.ndarray, costs: np.ndarray,
            grid: np.ndarray) -> float:
    """Optimal online value for the with-recall single line (Prob. 4.1)."""
    n = len(costs)
    k = len(grid)

    @functools.lru_cache(maxsize=None)
    def value(i: int, s: int, xb: int) -> float:
        # xb == k encodes X = +inf (nothing probed yet).
        stop = np.inf if xb == k else float(grid[xb])
        if i == n:
            return stop
        row = p0 if i == 0 else trans[i - 1][s]
        cont = costs[i] + sum(
            row[y] * value(i + 1, y, min(xb, y)) for y in range(k))
        return min(stop, cont)

    return value(0, 0, k)


def bf_skip(p0: np.ndarray, trans: np.ndarray, cost_edge: np.ndarray,
            grid: np.ndarray) -> float:
    """Optimal value for the transitive closure of a line (§5.2).

    ``cost_edge[i, j]`` is the cost of probing j right after i (i < j);
    row 0 is the dummy-root row, so nodes are 1-indexed into cost_edge.
    """
    n = trans.shape[0] + 1
    k = len(grid)

    # P^{(i->j)} cumulative conditionals, 0-indexed nodes.
    cum = {}
    for i in range(n):
        acc = np.eye(k)
        for j in range(i + 1, n):
            acc = acc @ trans[j - 1]
            cum[(i, j)] = acc

    @functools.lru_cache(maxsize=None)
    def value(last: int, s: int, xb: int) -> float:
        # last = -1 means at dummy root; s, xb as in bf_line.
        stop = np.inf if xb == k else float(grid[xb])
        best = stop
        for j in range(last + 1, n):
            if last < 0:
                row = p0 if j == 0 else p0 @ cum[(0, j)]
            else:
                row = trans[last][s] if j == last + 1 else cum[(last, j)][s]
            c = cost_edge[last + 1, j + 1]
            cont = c + sum(
                row[y] * value(j, y, min(xb, y)) for y in range(k))
            best = min(best, cont)
        return best

    return value(-1, 0, k)


def bf_forest(parents: list[int], root_pmfs: dict[int, np.ndarray],
              trans: dict[int, np.ndarray], costs: np.ndarray,
              grid: np.ndarray) -> float:
    """Optimal value for Markovian costly exploration over a forest (§5.1).

    Args:
      parents: parents[v] = parent node or -1 for roots.
      root_pmfs: root node -> (K,) marginal PMF.
      trans: non-root node v -> (K, K) conditional ``Pr[R_v = y | R_parent = s]``.
      costs: (n,) per-node inspection cost (edge cost folded into child).
      grid: (K,) support values.
    """
    n = len(parents)
    k = len(grid)
    children = [[] for _ in range(n)]
    roots = []
    for v, p in enumerate(parents):
        if p < 0:
            roots.append(v)
        else:
            children[p].append(v)

    @functools.lru_cache(maxsize=None)
    def value(probed: frozenset, xb: int) -> float:
        stop = np.inf if xb == k else float(grid[xb])
        probed_map = dict(probed)
        frontier = [v for v in range(n)
                    if v not in probed_map
                    and (parents[v] < 0 or parents[v] in probed_map)]
        best = stop
        for v in frontier:
            row = (root_pmfs[v] if parents[v] < 0
                   else trans[v][probed_map[parents[v]]])
            cont = costs[v] + sum(
                row[y] * value(probed | {(v, y)}, min(xb, y))
                for y in range(k))
            best = min(best, cont)
        return best

    return value(frozenset(), k)
