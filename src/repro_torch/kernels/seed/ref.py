"""Plain PyTorch version of the greedy seeding loop (the kernel's oracle):
for each vertex in seeding order, assign it to the lowest-indexed block of
least weight and add its weight there.  A serial loop of three launches per
vertex, with no read back to the host."""

from __future__ import annotations

import torch


def greedy_seed_plain(order, nw_sorted, k: int):
    """Labels (int64, indexed by vertex) of the LPT-style seeding."""
    n = order.shape[0]
    labels = torch.zeros(n, dtype=torch.int64, device=order.device)
    bw = torch.zeros(k, dtype=torch.float32, device=order.device)
    for i in range(n):
        b = torch.argmin(bw).reshape(1)  # first index of the minimum
        labels.index_put_((order[i:i + 1],), b)
        bw.index_add_(0, b, nw_sorted[i:i + 1])
    return labels
