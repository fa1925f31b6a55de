"""Markov-chain model of per-ramp losses (Problem 2.4's distributional
input).

The DP consumes ``p0`` — (K,) PMF of the first node's binned loss — and
``trans`` — (n-1, K, K) row-stochastic transition matrices,
``trans[i][s, y] = Pr[R_{i+2} = v_y | R_{i+1} = v_s]``, estimated by
Laplace-smoothed counting over binned calibration traces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.support import Support, build_support, quantize

__all__ = ["MarkovChain", "estimate_chain", "estimate_from_losses",
           "marginals", "cumulative_transitions", "sample_chain"]


@dataclasses.dataclass(frozen=True)
class MarkovChain:
    """Discrete Markov chain over a common support of size K, n nodes."""

    p0: torch.Tensor      # (K,)
    trans: torch.Tensor   # (n-1, K, K), row-stochastic

    @property
    def n(self) -> int:
        return int(self.trans.shape[0]) + 1

    @property
    def k(self) -> int:
        return int(self.p0.shape[0])


def estimate_chain(bins: torch.Tensor, k: int,
                   alpha: float = 0.5) -> MarkovChain:
    """Fit a MarkovChain from (T, n) int binned calibration traces."""
    bins = torch.as_tensor(bins).long()
    t, n = bins.shape
    p0 = torch.bincount(bins[:, 0], minlength=k).float() + alpha
    p0 = p0 / p0.sum()
    trans = []
    for i in range(n - 1):
        # counts[s, y] = #{rows with bins[:,i]==s and bins[:,i+1]==y}
        idx = bins[:, i] * k + bins[:, i + 1]
        counts = torch.bincount(idx, minlength=k * k).float().reshape(k, k)
        counts = counts + alpha
        trans.append(counts / counts.sum(dim=1, keepdim=True))
    trans = torch.stack(trans) if trans else \
        torch.zeros((0, k, k), device=p0.device)
    return MarkovChain(p0=p0, trans=trans)


def estimate_from_losses(losses, k: int, alpha: float = 0.5,
                         device="cpu") -> tuple[MarkovChain, Support]:
    """Support + chain straight from (T, n) raw loss traces."""
    support = build_support(losses, k, device=device)
    bins = quantize(support, torch.as_tensor(np.asarray(losses)))
    return estimate_chain(bins, k, alpha), support


def marginals(chain: MarkovChain) -> torch.Tensor:
    """(n, K) marginal PMFs p_i (Chapman-Kolmogorov forward pass)."""
    out = [chain.p0]
    for i in range(chain.n - 1):
        out.append(out[-1] @ chain.trans[i])
    return torch.stack(out)


def cumulative_transitions(chain: MarkovChain) -> torch.Tensor:
    """(n, n, K, K) products P^{(i->j)} = trans[i] @ ... @ trans[j-1] for
    i < j, the identity elsewhere: the j-step-ahead conditionals the
    transitive-closure DP (paper §5.2) skips over."""
    n, k = chain.n, chain.k
    eye = torch.eye(k, dtype=chain.p0.dtype, device=chain.p0.device)
    mats = [[eye] * n for _ in range(n)]
    for i in range(n):
        acc = eye
        for j in range(i + 1, n):
            acc = acc @ chain.trans[j - 1]
            mats[i][j] = acc
    return torch.stack([torch.stack(row) for row in mats])


def sample_chain(chain: MarkovChain, generator: torch.Generator,
                 t: int) -> torch.Tensor:
    """Sample (t, n) int64 bin trajectories from the chain, drawing from
    ``generator`` (on the chain's device)."""
    first = torch.multinomial(chain.p0.expand(t, chain.k), 1,
                              replacement=True, generator=generator)[:, 0]
    out = [first]
    for i in range(chain.n - 1):
        probs = chain.trans[i][out[-1]]                # (t, K) rows
        out.append(torch.multinomial(probs, 1, replacement=True,
                                     generator=generator)[:, 0])
    return torch.stack(out, dim=1)
