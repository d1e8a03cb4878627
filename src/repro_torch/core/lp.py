"""Size-constrained label propagation — the dLP baseline (port of
``repro/core/lp.py``).  Moves into a target block are admitted with
probability min(1, capacity_u / W_u), so a round cannot systematically
overshoot L_max.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core.graph import Graph
from repro_torch.core.partition import best_moves, block_weights
from repro_torch.ops import segment_sum


class LPRoundResult(NamedTuple):
    labels: torch.Tensor
    n_moved: torch.Tensor


def lp_round(g: Graph, labels, k: int, lmax, key) -> LPRoundResult:
    labels = labels.long()
    bw = block_weights(g, labels, k)
    capacity = lmax - bw  # negative for overloaded blocks → ineligible
    own, gain, target = best_moves(g, labels, k, capacity=capacity)
    want = (gain > 0.0) & torch.isfinite(gain) & (target != labels)

    w_in = segment_sum(torch.where(want, g.nw, 0.0), target, k)
    p = torch.where(w_in > 0, torch.clamp(
        capacity / torch.clamp_min(w_in, 1e-9), 0.0, 1.0), 1.0)
    accept = want & (rnd.uniform(key, (g.n,), g.device) < p[target])
    return LPRoundResult(torch.where(accept, target, labels), accept.sum())


def lp_refine(g: Graph, labels, k: int, lmax, key, max_rounds: int = 16):
    """Repeat lp_round until no vertex moves or max_rounds is hit."""
    moved, it = 1, 0
    while moved > 0 and it < max_rounds:
        key, sub = rnd.split(key)
        labels, n_moved = lp_round(g, labels, k, lmax, sub)
        moved, it = int(n_moved), it + 1
    return labels
