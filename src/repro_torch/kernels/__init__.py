"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each
beside a plain PyTorch version of the same contract.  A wrapper runs the
plain version for CPU tensors and launches its kernel for CUDA tensors;
its ``launches`` attribute counts the kernel launches."""

from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.kernels.paged_prefill import (paged_prefill,
                                               paged_prefill_plain)

__all__ = ["paged_attention", "paged_attention_plain", "paged_prefill",
           "paged_prefill_plain"]
