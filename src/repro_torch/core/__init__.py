"""T-Tamer core: Markovian costly exploration over DAGs (the paper's
contribution) — the discrete loss support, the Markov chain of per-node
losses, the line (Alg. 2) and skip (§5.2) dynamic-index DPs, the tree
index (§5.1), brute-force oracles, the Thm 3.4 instance, synthetic
traces and the Pareto sweeps."""

from repro_torch.core.support import Support, build_support, quantize
from repro_torch.core.markov import (MarkovChain, estimate_chain,
                                     estimate_from_losses)
from repro_torch.core.line_dp import LineTables, solve_line
from repro_torch.core.skip_dp import SkipTables, solve_skip
from repro_torch.core import tree_dp, traces, impossibility, pareto

__all__ = [
    "Support", "build_support", "quantize",
    "MarkovChain", "estimate_chain", "estimate_from_losses",
    "LineTables", "solve_line", "SkipTables", "solve_skip",
    "tree_dp", "pareto", "traces", "impossibility",
]
