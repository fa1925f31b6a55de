"""The expert sets a router's top-k could pick to rounding.

A configuration may state a routing tie band ``tau`` in router-logit
units (``check.routing_tie``).  Where the reference's own top-k
boundary lies within ``tau``, the program may round its way to another
set: this module lists the sets the judge lets it take.  A MoE family's
reference calls `topk_candidates` at each routing of a decoded token
and computes a branch for each set (`ttbench.families`).

Gates are not renormalised over the set: each expert's gate is its own
softmax probability over all experts whichever set it is in, so a set
differs from the reference's only in which experts it holds.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Candidate", "MAX_BRANCHES", "topk_candidates"]

MAX_BRANCHES = 8        # branches a decoded token at most, its own included


@dataclasses.dataclass(frozen=True)
class Candidate:
    experts: tuple      # expert ids, in the reference's order of rank
    margin: float       # router logit of the expert swapped out less that
                        # of the one swapped in (0 for the reference's own)


def topk_candidates(logits: torch.Tensor, k: int, tau: float,
                    max_alt: int) -> list[Candidate]:
    """The expert sets of one routing of router ``logits`` (E,): the
    reference's own top ``k`` first (exact ties go to the lower expert
    id), then at most ``max_alt`` sets that each swap one expert of it
    for one outside it whose logit lies at most ``tau`` below, nearest
    first (then by rank inside, then by rank outside)."""
    vals, ids = torch.sort(logits.detach().float().cpu(), descending=True,
                           stable=True)
    v, ids = vals.tolist(), ids.tolist()
    own = tuple(ids[:k])
    alts = []
    for i in range(k - 1, -1, -1):            # inside, the weakest first
        if k == len(v) or v[i] - v[k] > tau:
            break
        for o in range(k, len(v)):            # outside, the strongest first
            margin = v[i] - v[o]
            if margin > tau:
                break
            alts.append((margin, i, o))
    alts.sort()
    out = [Candidate(own, 0.0)]
    for margin, i, o in alts[:max(max_alt, 0)]:
        swapped = list(own)
        swapped[i] = ids[o]
        out.append(Candidate(tuple(swapped), margin))
    return out
