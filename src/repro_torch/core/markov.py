"""Markov-chain model of per-ramp losses (Problem 2.4's distributional
input).

The DP consumes ``p0`` — (K,) PMF of the first node's binned loss — and
``trans`` — (n-1, K, K) row-stochastic transition matrices,
``trans[i][s, y] = Pr[R_{i+2} = v_y | R_{i+1} = v_s]``, estimated by
Laplace-smoothed counting over binned calibration traces.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MarkovChain", "estimate_chain"]


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
