"""Synthetic workload / instance generators for the costly-exploration core.

Two families:
  * ``random_instance`` — arbitrary random Markov chains + costs, used by
    the hypothesis property tests (DP optimality vs brute force).
  * ``ee_like_traces`` — early-exit-shaped loss traces: losses broadly
    decrease with depth, are positively correlated along the ramp sequence
    (App. D.3 notes real ramp losses are positively correlated), and
    occasionally *increase* at deeper ramps ("overthinking", Kaya et al.
    2019, §4) — exactly the phenomenon that makes recall valuable.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_instance", "ee_like_traces", "cascade_traces"]


def random_instance(rng: np.random.Generator, n: int, k: int,
                    cost_scale: float = 0.2, concentration: float = 1.0):
    """Random discrete Markov instance on support grid ~ sorted U(0,1].

    Returns (p0, trans, costs, grid) as float64 numpy arrays.
    """
    grid = np.sort(rng.uniform(0.05, 1.0, size=k))
    # enforce strict ascent
    grid += np.arange(k) * 1e-6
    p0 = rng.dirichlet(np.full(k, concentration))
    trans = rng.dirichlet(np.full(k, concentration), size=(n - 1, k)) \
        if n > 1 else np.zeros((0, k, k))
    costs = rng.uniform(0.01, cost_scale, size=n)
    return p0, trans, costs, grid


def ee_like_traces(rng: np.random.Generator, t: int, n: int,
                   overthink_prob: float = 0.15,
                   difficulty_spread: float = 1.0):
    """Generate (losses, correct, flops) for an n-ramp early-exit workload.

    Each sample has a latent difficulty d ~ LogNormal; ramp i's loss is a
    noisy decreasing function of depth scaled by d, with occasional
    "overthinking" bumps at later ramps.  ``correct[t, i]`` indicates
    whether ramp i's prediction would match the backbone (prob. decreasing
    in loss), and ``flops`` grows superlinearly with depth, mimicking
    transformer ramp placement.

    Returns:
      losses: (t, n) in (0, 1] — the proxy loss (1 - confidence).
      correct: (t, n) bool.
      flops: (n,) normalized cumulative-segment costs summing to 1.
    """
    d = rng.lognormal(mean=0.0, sigma=difficulty_spread, size=(t, 1))
    # deeper ramps converge toward the backbone (superlinear depth gain),
    # so the final ramp's disagreement-with-backbone proxy is small
    depth = (np.linspace(1.0, float(n), n) ** 1.6)[None, :]
    base = d / (d + depth)                       # decreasing in depth
    noise = rng.normal(0.0, 0.05, size=(t, n))
    # AR(1) correlation along ramps (Markov-ish)
    for i in range(1, n):
        noise[:, i] = 0.7 * noise[:, i - 1] + 0.3 * noise[:, i]
    bump = (rng.uniform(size=(t, n)) < overthink_prob) * \
        rng.uniform(0.05, 0.4, size=(t, n))
    bump[:, 0] = 0.0
    losses = np.clip(base + noise + bump, 1e-4, 1.0)
    # calibrated confidences: ramp agrees with the backbone w.p. 1 - loss
    # (real EE ramps are trained toward exactly this; App. D.2 uses
    # 1 - confidence as the loss proxy)
    correct = rng.uniform(size=(t, n)) > losses
    correct[:, -1] = True                        # backbone agrees with itself
    seg = np.linspace(1.0, 2.0, n)               # deeper segments cost more
    flops = np.cumsum(seg)
    flops = flops / flops[-1]
    # per-node incremental cost (segment i alone)
    inc = np.diff(np.concatenate([[0.0], flops]))
    return losses.astype(np.float64), correct, inc.astype(np.float64)


def cascade_traces(rng: np.random.Generator, t: int, depths,
                   overthink_prob: float = 0.15,
                   head_overthink: float = 0.0,
                   difficulty_spread: float = 1.0):
    """Multi-MODEL cascade loss traces: one (t, sum(n_m)) bank whose
    column groups are the node ladders of several models evaluated on
    the SAME inputs.

    ``depths`` is a list of per-model effective-depth vectors (one entry
    per node, ladder order).  Unlike `ee_like_traces` — where the first
    nodes are the shallow prefix of ONE network — each model here is a
    complete network: a small model's ramps sit close to its own head
    (flat depth profile), while a larger model's nodes are much deeper.
    All models share each sample's latent difficulty, and noise is
    AR(1)-correlated across the whole ladder (a hard token is hard for
    everyone; App. D.3's positive correlation).

    ``head_overthink`` adds extra overthinking probability on each
    model's LAST node — the §6 regime where a bigger model's head is
    sometimes beaten by an earlier node, which only recall can exploit.

    Returns (losses (t, n_total), boundaries tuple).
    """
    depths = [np.asarray(d, np.float64) for d in depths]
    boundaries = tuple(len(d) for d in depths)
    depth = np.concatenate(depths)[None, :]
    n = depth.shape[1]
    d = rng.lognormal(mean=0.0, sigma=difficulty_spread, size=(t, 1))
    base = d / (d + depth)
    noise = rng.normal(0.0, 0.05, size=(t, n))
    for i in range(1, n):
        noise[:, i] = 0.7 * noise[:, i - 1] + 0.3 * noise[:, i]
    bump = (rng.uniform(size=(t, n)) < overthink_prob) * \
        rng.uniform(0.05, 0.4, size=(t, n))
    bump[:, 0] = 0.0
    if head_overthink > 0.0:
        heads = np.cumsum(boundaries) - 1
        extra = (rng.uniform(size=(t, len(heads))) < head_overthink) * \
            rng.uniform(0.05, 0.45, size=(t, len(heads)))
        bump[:, heads] += extra
    losses = np.clip(base + noise + bump, 1e-4, 1.0)
    return losses.astype(np.float64), boundaries
