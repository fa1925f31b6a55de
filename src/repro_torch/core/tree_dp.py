"""Markovian costly exploration over directed trees / forests (§5.1, App. C).

The paper's result (Thm C.7 + C.14): the optimal policy probes, among all
*available* nodes (roots or children of probed nodes), the one with the
smallest **dynamic index**, and stops once the running min X falls below
every available index.  A node's index is the indifference point of the
subproblem "explore only subtree(v), against outside option x", i.e. the
contraction of the whole subtree into one equivalent node (Lem. C.4/C.5).

Implementation notes:
  * ``subtree_phi`` evaluates the contracted subtree's equivalent loss
    Phi_v(x | s) exactly (expectimax over the subtree);
    ``node_index`` then bisects Phi_v(x|s) = x for sigma_v(s).  Phi - x is
    non-increasing and 1-Lipschitz (Lem. B.1) so bisection is safe.
  * ``solve_forest_exact`` is the unrestricted expectimax optimum (same
    value the DP must match — Thm C.14's claim is index policy == optimal).
  * ``index_policy_value`` evaluates THE index policy exactly (expectation
    over all realizations, following the policy's choices).  The property
    tests assert it equals ``solve_forest_exact`` — a direct numerical
    verification of Thm C.14.
  * Multi-line (§C.1) is the special case of a forest whose trees are
    paths; ``forest_from_lines`` builds it.

Exactness over asymptotics: these evaluators are exponential in subtree
size (fine for serving-cascade topologies, n <= ~10); the paper's poly-time
contraction applies the same recursions bottom-up with quantized cost
support — the values computed here are the ground truth those tables
approximate.  See DESIGN.md §6.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = ["Forest", "forest_from_lines", "solve_forest_exact",
           "node_index", "index_policy_value", "simulate_forest"]


@dataclasses.dataclass(frozen=True)
class Forest:
    """Discrete Markovian forest instance.

    Attributes:
      parents: parents[v] = parent id, or -1 for roots.
      root_pmfs: root id -> (K,) PMF over the support.
      trans: non-root id -> (K, K) matrix, ``Pr[R_v = y | R_parent = s]``.
      costs: (n,) per-node inspection cost.
      grid: (K,) common support values.
    """
    parents: tuple[int, ...]
    root_pmfs: dict[int, np.ndarray]
    trans: dict[int, np.ndarray]
    costs: np.ndarray
    grid: np.ndarray

    @property
    def n(self) -> int:
        return len(self.parents)

    @property
    def k(self) -> int:
        return len(self.grid)

    @functools.cached_property
    def children(self) -> tuple[tuple[int, ...], ...]:
        ch = [[] for _ in range(self.n)]
        for v, p in enumerate(self.parents):
            if p >= 0:
                ch[p].append(v)
        return tuple(tuple(c) for c in ch)

    def subtree(self, v: int) -> tuple[int, ...]:
        out, stack = [], [v]
        while stack:
            u = stack.pop()
            out.append(u)
            stack.extend(self.children[u])
        return tuple(sorted(out))

    def row(self, v: int, parent_bin: int | None) -> np.ndarray:
        """Conditional PMF of R_v given its parent's realized bin."""
        if self.parents[v] < 0:
            return self.root_pmfs[v]
        assert parent_bin is not None
        return self.trans[v][parent_bin]


def forest_from_lines(lines) -> Forest:
    """Build a forest of disjoint paths from [(p0, trans, costs), ...]."""
    parents, root_pmfs, trans_d, costs = [], {}, {}, []
    grid = None
    for (p0, tr, cs, g) in lines:
        base = len(parents)
        grid = g if grid is None else grid
        assert np.allclose(grid, g), "lines must share a support"
        for i in range(len(cs)):
            if i == 0:
                parents.append(-1)
                root_pmfs[base] = np.asarray(p0, np.float64)
            else:
                parents.append(base + i - 1)
                trans_d[base + i] = np.asarray(tr[i - 1], np.float64)
            costs.append(float(cs[i]))
    return Forest(parents=tuple(parents), root_pmfs=root_pmfs, trans=trans_d,
                  costs=np.asarray(costs, np.float64),
                  grid=np.asarray(grid, np.float64))


# ---------------------------------------------------------------------------
# Exact optimum (expectimax over the full information state).
# ---------------------------------------------------------------------------

def _expectimax(forest: Forest, allowed: frozenset[int]):
    """Return memoized V(probed: frozenset[(v, bin)], x: float) restricted
    to nodes in ``allowed``."""
    grid, k = forest.grid, forest.k

    @functools.lru_cache(maxsize=None)
    def value(probed: frozenset, x: float) -> float:
        probed_map = dict(probed)
        best = x
        for v in allowed:
            if v in probed_map:
                continue
            p = forest.parents[v]
            if p >= 0 and p not in probed_map:
                continue  # parent not yet probed
            row = forest.row(v, probed_map.get(p))
            cont = forest.costs[v] + sum(
                row[y] * value(probed | {(v, y)}, min(x, float(grid[y])))
                for y in range(k))
            best = min(best, cont)
        return best

    return value


def solve_forest_exact(forest: Forest) -> float:
    """Online-optimal expected loss (must probe at least one node)."""
    value = _expectimax(forest, frozenset(range(forest.n)))
    inf = float(forest.grid[-1] * 1e6 + 1e6)
    return value(frozenset(), inf)


# ---------------------------------------------------------------------------
# Dynamic index of a node = contraction of its subtree (Lem. C.4/C.5).
# ---------------------------------------------------------------------------

def subtree_phi(forest: Forest, v: int, x: float,
                parent_bin: int | None) -> float:
    """Equivalent loss Phi_v(x | s): optimal play restricted to subtree(v)
    with outside option x, conditioned on the parent's realized bin."""
    allowed = frozenset(forest.subtree(v))
    grid, k = forest.grid, forest.k

    @functools.lru_cache(maxsize=None)
    def value(probed: frozenset, xx: float) -> float:
        probed_map = dict(probed)
        best = xx
        for u in allowed:
            if u in probed_map:
                continue
            p = forest.parents[u]
            if u == v:
                row = forest.row(v, parent_bin)
            elif p in probed_map:
                row = forest.trans[u][probed_map[p]]
            else:
                continue
            cont = forest.costs[u] + sum(
                row[y] * value(probed | {(u, y)}, min(xx, float(grid[y])))
                for y in range(k))
            best = min(best, cont)
        return best

    return value(frozenset(), x)


def node_index(forest: Forest, v: int, parent_bin: int | None,
               tol: float = 1e-9) -> float:
    """sigma_v(s): smallest x with Phi_v(x | s) = x (Def. 4.4 generalized).

    H(x) = Phi - x is non-increasing, 1-Lipschitz, H(0) >= 0; bisect on
    [0, hi] where hi = grid[-1] (H(grid[-1]) <= 0 because stopping at the
    max support value is always weakly worse than the subtree's best)."""
    lo, hi = 0.0, float(forest.grid[-1]) + float(np.sum(forest.costs)) + 1.0
    # Ensure H(hi) <= 0.
    while subtree_phi(forest, v, hi, parent_bin) >= hi - tol:
        if subtree_phi(forest, v, hi, parent_bin) <= hi + tol:
            break
        hi *= 2
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if subtree_phi(forest, v, mid, parent_bin) < mid - tol:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# The index policy (Alg. 3 / Thm C.7) and its exact value.
# ---------------------------------------------------------------------------

def _policy_action(forest: Forest, probed_map: dict[int, int], x: float,
                   sigma_cache: dict) -> int | None:
    """Index policy: probe argmin-sigma frontier node, or None to stop."""
    frontier = [v for v in range(forest.n)
                if v not in probed_map
                and (forest.parents[v] < 0 or forest.parents[v] in probed_map)]
    if not frontier:
        return None
    sigmas = []
    for v in frontier:
        key = (v, probed_map.get(forest.parents[v]))
        if key not in sigma_cache:
            sigma_cache[key] = node_index(forest, v, key[1])
        sigmas.append(sigma_cache[key])
    j = int(np.argmin(sigmas))
    if x <= sigmas[j] + 1e-9:
        return None  # X at-or-below every index -> stop (ties stop)
    return frontier[j]


def index_policy_value(forest: Forest) -> float:
    """Exact expected loss of the index policy (for Thm C.14 validation)."""
    grid, k = forest.grid, forest.k
    sigma_cache: dict = {}

    @functools.lru_cache(maxsize=None)
    def value(probed: frozenset, x: float) -> float:
        probed_map = dict(probed)
        v = _policy_action(forest, probed_map, x, sigma_cache)
        if v is None:
            return x
        row = forest.row(v, probed_map.get(forest.parents[v]))
        return forest.costs[v] + sum(
            row[y] * value(probed | {(v, y)}, min(x, float(grid[y])))
            for y in range(k))

    inf = float(grid[-1] * 1e6 + 1e6)
    # Force at least one probe (policy must serve something).
    frontier = [v for v in range(forest.n) if forest.parents[v] < 0]
    assert frontier, "forest has no roots"
    return value(frozenset(), inf)


def simulate_forest(forest: Forest, bins: np.ndarray,
                    losses: np.ndarray | None = None):
    """Run the index policy on sampled realizations.

    Args:
      bins: (T, n) realized bin of every node (column v = node v).
      losses: optional (T, n) real losses; defaults to grid values.

    Returns (served_loss, explore_cost, n_probed) arrays.
    """
    grid = forest.grid
    if losses is None:
        losses = grid[bins]
    t = bins.shape[0]
    sigma_cache: dict = {}
    served = np.zeros(t)
    spent = np.zeros(t)
    nprobe = np.zeros(t, np.int64)
    for r in range(t):
        probed_map: dict[int, int] = {}
        x = float(grid[-1] * 1e6 + 1e6)
        best = np.inf
        while True:
            v = _policy_action(forest, probed_map, x, sigma_cache)
            if v is None:
                break
            spent[r] += forest.costs[v]
            nprobe[r] += 1
            probed_map[v] = int(bins[r, v])
            best = min(best, float(losses[r, v]))
            x = min(x, float(grid[bins[r, v]]))
        served[r] = best if np.isfinite(best) else float(grid[-1])
    return served, spent, nprobe
