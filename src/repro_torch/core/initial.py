"""Initial partitioning of the coarsest graph (port of
``repro/core/initial.py``): multi-restart greedy balanced seeding (heaviest
vertex → lightest block) followed by Jet + rebalance; the best balanced cut
wins.
"""

from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.core.graph import Graph
from repro_torch.core.partition import edge_cut, l_max, total_overload
from repro_torch.kernels.seed import greedy_seed


def greedy_seed_arith(nw: torch.Tensor, k: int, key) -> torch.Tensor:
    """Assign vertices (heaviest first, random tie order from the per-vertex
    ``tid_uniform`` stream) to the currently lightest block.

    The assignment is serial in n, the coarsest level's size; it runs on
    the device as one kernel (``kernels/seed``), with no read back to the
    host."""
    from repro_torch.refine.comm import tid_uniform

    n = nw.shape[0]
    noise = tid_uniform(key, torch.arange(n, device=nw.device), maxval=1e-3)
    order = torch.argsort(-(nw + noise), stable=True)
    return greedy_seed(order, nw[order], k)


def initial_partition(g: Graph, k: int, eps: float, key,
                      n_restarts: int = 4) -> torch.Tensor:
    from repro_torch.core.refine import jet_refine

    lmax = l_max(g, k, eps)
    best_labels, best_cut = None, float("inf")
    for _ in range(n_restarts):
        key, k1, k2 = rnd.split(key, 3)
        labels = greedy_seed_arith(g.nw, k, k1)
        labels = jet_refine(g, labels, k, eps, k2, rounds=2, patience=6,
                            max_inner=24)
        cut = float(edge_cut(g, labels))
        ov = float(total_overload(g, labels, k, lmax))
        if ov <= 0 and cut < best_cut:
            best_labels, best_cut = labels, cut
    if best_labels is None:  # all restarts imbalanced — take the last anyway
        best_labels = labels
    return best_labels
