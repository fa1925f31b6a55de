"""Percentiles as the contract computes them."""

from __future__ import annotations

import numpy as np

__all__ = ["pct"]


def pct(values, q: float) -> float | None:
    """The ``q``-th percentile (linear interpolation), None for none."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))
