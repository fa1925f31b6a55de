"""repro_torch — the T-Tamer serving system on PyTorch and CUDA.

Laid out module for module like the JAX package `repro`: the paper's
line DP and strategies (`core`, `strategy`), the early-exit decoder
(`models`), the segment-wise token step (`serving.engine`), the paged
KV pool with chunked prefill (`serving.kvpool`, `serving.runtime`) and
the serving launcher (`launch.serve`).  The paged decode and chunked
prefill attention run in hand-written CUDA kernels (`kernels`,
sources in `csrc/`); every kernel has a plain PyTorch version beside
it, which is what CPU tensors go through.
"""
