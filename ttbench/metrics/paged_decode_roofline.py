"""Kernels (`kernels/paged_attention.py`, `csrc/paged_attention.cu`):
the paged decode kernel's share of its roofline in the traced span."""

from ttbench.lib.layer import roofline


def read(run):
    return roofline(run, "paged_attention", "paged_attention_kernel")
