"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each
beside a plain PyTorch version of the same contract.  A wrapper runs the
plain version for CPU tensors and launches its kernel for CUDA tensors;
its ``launches`` attribute counts the kernel launches.  No kernel has a
backward: on CUDA tensors a wrapper raises when gradients are being
recorded and an input requires one (`build.refuse_autograd`)."""

from repro_torch.kernels.bellman_backup import (bellman_backup,
                                                bellman_backup_plain,
                                                bellman_solve,
                                                bellman_solve_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_plain)
from repro_torch.kernels.paged_prefill import (paged_prefill,
                                               paged_prefill_plain)
from repro_torch.kernels.ramp_exit import ramp_exit, ramp_exit_plain
from repro_torch.kernels.ssd_chunk import (prefix_sum, ssd_chunk,
                                           ssd_chunk_plain)

__all__ = ["bellman_backup", "bellman_backup_plain", "bellman_solve",
           "bellman_solve_plain", "flash_attention",
           "flash_attention_plain", "paged_attention",
           "paged_attention_plain", "paged_prefill", "paged_prefill_plain",
           "prefix_sum", "ramp_exit", "ramp_exit_plain", "ssd_chunk",
           "ssd_chunk_plain"]
