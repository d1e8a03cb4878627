"""Partition state and metrics (port of ``repro/core/partition.py``).

Balance constraint c(V_i) <= L_max := (1+eps)·ceil(c(V)/k); objective =
total weight of cut edges.  Every sum is a float32 sum of integers on
integer-weight graphs, so it is exact in any order.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import Graph
from repro_torch.ops import f32, segment_sum


def l_max(g: Graph, k: int, eps: float) -> torch.Tensor:
    """L_max = (1+eps)·ceil(c(V)/k); ``1 + eps`` is formed in Python double
    and rounded to float32 once, as the reference does."""
    return f32(1.0 + eps, g.device) * torch.ceil(g.total_node_weight / k)


def block_weights(g: Graph, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) block weights c(V_i)."""
    return segment_sum(g.nw, labels, k)


def edge_cut(g: Graph, labels: torch.Tensor) -> torch.Tensor:
    """Total weight of cut edges (directed copies halved)."""
    lu = labels[g.src.long()]
    lv = labels[g.safe_col()]
    w = torch.where(g.edge_mask & (lu != lv), g.ew, 0.0)
    return w.sum() * 0.5


def imbalance(g: Graph, labels: torch.Tensor, k: int) -> torch.Tensor:
    """max_i c(V_i) / (c(V)/k) − 1."""
    bw = block_weights(g, labels, k)
    return bw.max() / (g.total_node_weight / k) - 1.0


def total_overload(g: Graph, labels: torch.Tensor, k: int,
                   lmax: torch.Tensor) -> torch.Tensor:
    """Σ_o max(0, c(V_o) − L_max)."""
    bw = block_weights(g, labels, k)
    return torch.clamp_min(bw - lmax, 0.0).sum()


def conn_dense(g: Graph, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) matrix conn(v, V_j) = Σ_{(v,u)∈E, u∈V_j} ω(v,u)."""
    lv = labels[g.safe_col()].long()
    key = g.src.long() * k + lv
    w = torch.where(g.edge_mask, g.ew, 0.0)
    return segment_sum(w, key, g.n * k).reshape(g.n, k)


def best_moves(g: Graph, labels: torch.Tensor, k: int,
               capacity: torch.Tensor | None = None):
    """Per-vertex (own_conn, best_gain, best_target) under the shared
    move-selection rule (:func:`repro_torch.refine.gain.masked_best`)."""
    from repro_torch.refine.gain import masked_best

    return masked_best(conn_dense(g, labels, k), labels, g.nw, capacity, k)
