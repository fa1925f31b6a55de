"""The paged prefill-chunk kernel (`kernels/paged_prefill.py`): one
launch's bytes and operations on its tensors
(`ttbench.lib.kernel_bytes`)."""

from ttbench.lib.kernel_bytes import prefill_cost


def cost(inputs, outputs):
    q, k_pages, _, pos_pages, table, q_pos = inputs[:6]
    return prefill_cost(q, k_pages, pos_pages, table, q_pos)
