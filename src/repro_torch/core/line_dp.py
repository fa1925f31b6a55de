"""Dynamic-index DP for the directed line (paper §4, Alg. 2, Thm 4.5).

State ``(X, R_{i-1}, i)``: running-min loss X, previous node's binned
loss s, next candidate node i.  Bellman recursion (§4.2):

    Phi(X, s, i) = min{ X,  c_i + E_{R_i | R_{i-1}=s}[ Phi(min(X, R_i), R_i, i+1) ] }

with base case ``Phi(X, *, n) = X``.  The X axis has K+2 entries,
``xvals = [0, v_1..v_K, INF]``; a loss bin b maps to X-index b+1.  The
backward pass is n backups, (K x K) @ (K x (K+2)) matmuls over a
min-gathered table: a reversed Python loop of the plain gather + matmul
(`repro_torch.kernels.bellman_solve_plain`), or, under
``solve_line(use_kernel=True)``, one launch of the Bellman kernel that
runs the whole loop (`bellman_solve`; the plain loop on CPU tensors).

The exact dynamic index sigma (Def. 4.4) is recovered by linear
interpolation at the stop/continue flip, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.markov import MarkovChain
from repro_torch.core.support import Support
from repro_torch.kernels.bellman_backup import (bellman_solve,
                                                bellman_solve_plain)

__all__ = ["LineTables", "solve_line", "suffix_tables", "x_values",
           "x_index_of_bin", "INF_SENTINEL_MULT"]

INF_SENTINEL_MULT = 1e4  # sentinel = grid[-1]*MULT + MULT (finite "+inf")


def x_values(grid: torch.Tensor) -> torch.Tensor:
    """(K+2,) X axis: [0, v_1..v_K, INF-sentinel]."""
    big = grid[-1:] * INF_SENTINEL_MULT + INF_SENTINEL_MULT
    return torch.cat([torch.zeros_like(grid[:1]), grid, big])


def x_index_of_bin(bins: torch.Tensor) -> torch.Tensor:
    """Map a loss bin (0..K-1) to its X-axis index (1..K)."""
    return bins + 1


@dataclasses.dataclass(frozen=True)
class LineTables:
    cont: torch.Tensor    # (n, K, K+2) f32 — continuation values [i, s, x]
    stop: torch.Tensor    # (n, K, K+2) bool — True => stop before probing i
    phi: torch.Tensor     # (n+1, K, K+2) f32 — equivalent-loss tables
    sigma: torch.Tensor   # (n, K) f32 — exact dynamic index sigma(s, i)
    value: torch.Tensor   # () f32 — online-optimal expected total loss

    @property
    def n(self) -> int:
        return int(self.cont.shape[0])

    @property
    def k(self) -> int:
        return int(self.cont.shape[1])

    @property
    def inf_x(self) -> int:
        return self.k + 1


def _min_index_matrix(grid: torch.Tensor) -> torch.Tensor:
    """mi[x, y] = X-axis index of min(xvals[x], grid[y])."""
    k = grid.shape[0]
    xv = x_values(grid)
    le = xv[:, None] <= grid[None, :]                       # (K+2, K)
    x_idx = torch.arange(k + 2, device=grid.device)[:, None]
    grid_as_x = torch.arange(1, k + 1, device=grid.device)[None, :]
    return torch.where(le, x_idx, grid_as_x)


def solve_line(chain: MarkovChain, costs, support: Support, *,
               use_kernel: bool = False) -> LineTables:
    """Solve the with-recall line problem (Prob. 4.1) exactly.

    Args:
      chain: fitted Markov chain over the binned losses (n nodes).
      costs: (n,) strictly-positive inspection costs c_i.
      support: the common discrete support V.
      use_kernel: run the backward pass as one Bellman-kernel launch.
    """
    grid = support.grid
    costs = torch.as_tensor(costs, dtype=torch.float32, device=grid.device)
    if costs.shape != (chain.n,):
        raise ValueError(f"costs shape {tuple(costs.shape)} != ({chain.n},)")
    k = chain.k
    nx = k + 2
    xvals = x_values(grid)
    mi_t = _min_index_matrix(grid).T.to(torch.int32).contiguous()
    # Node 0 has no predecessor; its "transition row" is p0 for every s.
    trans_full = torch.cat([chain.p0[None, None, :].expand(1, k, k),
                            chain.trans], dim=0)            # (n, K, K)
    base = xvals[None, :].expand(k, nx).contiguous()        # (K, K+2)
    solve = bellman_solve if use_kernel else bellman_solve_plain
    cont, phi = solve(base, trans_full, costs, xvals, mi_t)

    # Ties break toward stopping ("smallest solution", Def. 4.4).
    stop = xvals[None, None, :] <= cont

    # exact sigma via linear interpolation at the flip point: the stop
    # region is the low-x prefix; q = last stop index along the X axis
    q = stop.float().sum(dim=-1).long() - 1
    q = torch.clamp(q, 0, nx - 2)
    x0, x1 = xvals[q], xvals[q + 1]
    c0 = torch.gather(cont, -1, q[..., None])[..., 0]
    c1 = torch.gather(cont, -1, (q + 1)[..., None])[..., 0]
    denom = (x1 - x0) - (c1 - c0)
    sigma = torch.where(denom.abs() > 1e-12,
                        x0 + (c0 - x0) * (x1 - x0)
                        / torch.clamp(denom, min=1e-12),
                        x0)
    sigma = torch.clamp(sigma, min=0.0, max=float(xvals[-1]))
    value = cont[0, 0, nx - 1]  # start: X = inf sentinel, s irrelevant
    return LineTables(cont=cont, stop=stop, phi=phi, sigma=sigma,
                      value=value)


def suffix_tables(chain: MarkovChain, costs, support: Support, start: int,
                  *, use_kernel: bool = False) -> LineTables:
    """Tables for the line suffix [start..n): the multi-line and tree
    indices compute a branch's index on its remaining nodes."""
    if start == 0:
        return solve_line(chain, costs, support, use_kernel=use_kernel)
    sub = MarkovChain(p0=chain.p0 @ _chain_prod(chain, 0, start),
                      trans=chain.trans[start:])
    costs = torch.as_tensor(costs, dtype=torch.float32,
                            device=support.grid.device)
    return solve_line(sub, costs[start:], support, use_kernel=use_kernel)


def _chain_prod(chain: MarkovChain, i: int, j: int) -> torch.Tensor:
    """trans[i] @ ... @ trans[j-1] (the identity for i == j)."""
    acc = torch.eye(chain.k, dtype=chain.p0.dtype, device=chain.p0.device)
    for t in range(i, j):
        acc = acc @ chain.trans[t]
    return acc
