"""Jet move generation + afterburner filter (port of ``repro/core/jet.py``):
the single-device adapter of ``repro_torch.refine.engine.jet_move`` with the
segment gain backend.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import Graph
from repro_torch.ops import f32
from repro_torch.refine import engine
from repro_torch.refine.comm import SingleComm, edge_view_from_graph
from repro_torch.refine.gain import make_gain


class JetRoundResult(NamedTuple):
    labels: torch.Tensor   # (n,) new block assignment
    locked: torch.Tensor   # (n,) bool — moved this round, locked for the next
    n_moved: torch.Tensor  # () int


def jet_round(g: Graph, labels, locked, k: int, tau: float) -> JetRoundResult:
    ev = edge_view_from_graph(g)
    gb = make_gain("segment", ev, k)
    new_labels, move = engine.jet_move(SingleComm(g.n), gb, ev, labels.long(),
                                       locked, f32(tau, g.device), k)
    return JetRoundResult(new_labels, move, move.sum())
