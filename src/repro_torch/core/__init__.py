"""T-Tamer core: the discrete loss support, the Markov chain of per-node
losses, and the line dynamic-index DP (the paper's Alg. 2)."""

from repro_torch.core.line_dp import LineTables, solve_line
from repro_torch.core.markov import MarkovChain, estimate_chain
from repro_torch.core.support import Support, build_support, quantize

__all__ = ["Support", "build_support", "quantize", "MarkovChain",
           "estimate_chain", "LineTables", "solve_line"]
