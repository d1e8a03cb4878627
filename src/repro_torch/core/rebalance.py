"""Rebalancing (port of ``repro/core/rebalance.py``): the paper's
Algorithm 1 (probabilistic bucket passes) plus the greedy finisher, as
single-device adapters of ``repro_torch.refine.engine``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import Graph
from repro_torch.refine import engine
from repro_torch.refine.comm import SingleComm, edge_view_from_graph
from repro_torch.refine.engine import (  # noqa: F401
    ALPHA,
    GREEDY_NCAND,
    N_BUCKETS,
    _bucket_index,
    _relative_gain,
)
from repro_torch.refine.gain import make_gain


def _single(g: Graph, k: int):
    ev = edge_view_from_graph(g)
    return SingleComm(g.n), make_gain("segment", ev, k), ev


class RebalanceStats(NamedTuple):
    labels: torch.Tensor
    overload: float       # remaining total overload (float32 value)
    epochs: int           # greedy epochs executed
    prob_passes: int


def probabilistic_pass(g: Graph, labels, k: int, lmax, key):
    """Alg. 1 — one probabilistic bucket-rebalancing pass."""
    cm, gb, ev = _single(g, k)
    return engine.prob_pass(cm, gb, ev, labels.long(), key, lmax, k)


def greedy_epoch(g: Graph, labels, k: int, lmax, ncand: int = GREEDY_NCAND):
    """One greedy epoch: the best <= ncand movers by r_v, applied in order
    with live weight accounting."""
    cm, gb, ev = _single(g, k)
    return engine.greedy_epoch(cm, gb, ev, labels.long(), lmax, k, ncand)


def rebalance(g: Graph, labels, k: int, lmax, key,
              max_epochs: int = 32) -> RebalanceStats:
    """Greedy epochs with probabilistic escalation (<10 % progress rule)."""
    cm, gb, ev = _single(g, k)
    labels, ov, ep, pp = engine.rebalance_loop(cm, gb, ev, labels.long(), key,
                                               lmax, k, max_epochs)
    return RebalanceStats(labels, float(ov), ep, pp)
