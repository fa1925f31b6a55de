"""Kernels (`kernels/paged_prefill.py`, `csrc/paged_prefill.cu`): the
prefill-chunk kernel's share of its roofline in the traced span."""

from ttbench.lib.layer import roofline


def read(run):
    return roofline(run, "paged_prefill", "paged_prefill_kernel")
