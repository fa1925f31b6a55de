"""The paged decode kernel (`kernels/paged_attention.py`): one launch's
bytes and operations on its tensors (`ttbench.lib.kernel_bytes`)."""

from ttbench.lib.kernel_bytes import decode_cost


def cost(inputs, outputs):
    q, k_pages, _, pos_pages, table, q_pos = inputs[:6]
    return decode_cost(q, k_pages, pos_pages, table, q_pos)
