"""Discrete loss support & quantizer.

The paper's DP (§4.2) assumes every ramp loss takes values on a common
finite support ``V = {v_1 < ... < v_K}``; the quantile quantizer here
produces V from calibration traces.

Index conventions: bins ``0..K-1`` map to ``grid[0..K-1]`` (ascending,
> 0); a sentinel bin ``K`` denotes ``X = +inf`` (the running min before
any node was inspected).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Support", "build_support", "quantize"]


@dataclasses.dataclass(frozen=True)
class Support:
    """A common finite loss support V.

    Attributes:
      grid: (K,) f32 ascending strictly-positive grid values v_1..v_K.
      edges: (K-1,) f32 bucket edges; x maps to bin
        ``searchsorted(edges, x)``.
    """

    grid: torch.Tensor
    edges: torch.Tensor

    @property
    def size(self) -> int:
        return int(self.grid.shape[0])

    @property
    def inf_bin(self) -> int:
        """Sentinel bin index representing X = +inf."""
        return self.size

    def to(self, device) -> "Support":
        return Support(grid=self.grid.to(device), edges=self.edges.to(device))


def build_support(samples, k: int, device="cpu") -> Support:
    """Quantile-based support over pooled calibration losses (numpy,
    float64, as in the JAX package; the result is f32).

    Args:
      samples: any-shape array of observed losses (pooled over ramps and
        inputs).
      k: support size |V|.
    """
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    flat = np.asarray(samples, dtype=np.float64).reshape(-1)
    flat = flat[np.isfinite(flat)]
    if flat.size == 0:
        raise ValueError("no finite calibration samples")
    lo = float(np.min(flat))
    # Assumption 2.1: strictly positive losses.  Shift if violated.
    shift = 0.0 if lo > 0 else (1e-6 - lo)
    flat = flat + shift
    grid = np.quantile(flat, np.linspace(0.0, 1.0, k))
    # De-duplicate (heavy ties collapse quantiles); enforce strict ascent.
    grid = np.maximum.accumulate(grid)
    eps = max(1e-9, 1e-9 * float(grid[-1]))
    for i in range(1, grid.size):
        if grid[i] <= grid[i - 1]:
            grid[i] = grid[i - 1] + eps
    edges = (grid[1:] + grid[:-1]) / 2.0
    return Support(grid=torch.tensor(grid, dtype=torch.float32,
                                     device=device),
                   edges=torch.tensor(edges, dtype=torch.float32,
                                      device=device))


def quantize(support: Support, x: torch.Tensor) -> torch.Tensor:
    """Map loss values to int32 bin indices in [0, K)."""
    x = torch.as_tensor(x).to(device=support.edges.device,
                              dtype=support.edges.dtype)
    return torch.searchsorted(support.edges, x).to(torch.int32)
