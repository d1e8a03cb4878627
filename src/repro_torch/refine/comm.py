"""Single-device comm backend of the refinement engine (port of the
``SingleComm`` part of ``repro/refine/comm.py``).

Every refinement phase needs four communication primitives — ``exchange``
(publish a per-vertex field), ``lookup`` (read it at edge heads), ``psum``
(all-reduce) and ``gather`` (concatenate small per-PE vectors) — plus
``uniform`` (per-vertex randomness keyed on global vertex ids) and
``apply_moves``.  On one device each of them is the identity or a plain
gather/scatter; the distributed backends come with the distributed slice.

Index fields of :class:`EdgeView` are int64, the dtype torch indexes with.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.random import fold_uniform


class EdgeView(NamedTuple):
    """Per-device static view of one refinement level.  ``head_tid`` /
    ``my_tid`` are the tie-break ids (global vertex ids here)."""

    src: torch.Tensor       # (m,) int64 tail row
    head: torch.Tensor      # (m,) int64 head id (PAD on padding slots)
    live: torch.Tensor      # (m,) bool non-padding slots
    ew: torch.Tensor        # (m,) float32 edge weights (0 on padding)
    head_tid: torch.Tensor  # (m,) int64 tie-break id of the head
    my_tid: torch.Tensor    # (n,) int64 tie-break id of each slot
    nw: torch.Tensor        # (n,) float32 vertex weights
    owned: torch.Tensor     # (n,) bool real vertices

    @property
    def n_local(self) -> int:
        return self.nw.shape[0]


def tid_uniform(key, tid: torch.Tensor, maxval: float = 1.0) -> torch.Tensor:
    """THE per-vertex uniform stream of the refinement engine,
    ``u(v) = uniform(fold_in(key, v))`` — a pure function of (key, id), so
    it does not change with padding or layout."""
    u = fold_uniform(key, tid)
    if maxval != 1.0:
        u = u * torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return u


class SingleComm:
    """Single-device backend: the no-op rendering of the protocol."""

    kind = "single"

    def __init__(self, n_real: int):
        self.n_real = n_real

    def exchange(self, x):
        return x

    def lookup(self, ev: EdgeView, view, x_loc):
        return view[torch.where(ev.live, ev.head, 0)]

    def psum(self, x):
        return x

    def gather(self, x):
        return x

    def uniform(self, key, ev: EdgeView):
        return tid_uniform(key, torch.where(ev.owned, ev.my_tid, 0))

    def apply_moves(self, ev: EdgeView, labels, tids, tgts):
        """Set ``labels[tids] = tgts`` for the replayed moves (ids are
        distinct: one record per vertex)."""
        out = labels.clone()
        out[tids] = tgts.to(labels.dtype)
        return out


def edge_view_from_graph(g) -> EdgeView:
    """Single-device EdgeView of a :class:`repro_torch.core.graph.Graph`."""
    from repro_torch.core.graph import PAD

    live = g.col != PAD
    col = g.col.long()
    ids = torch.arange(g.n, dtype=torch.int64, device=g.device)
    return EdgeView(
        src=g.src.long(), head=col, live=live, ew=g.ew, head_tid=col,
        my_tid=ids, nw=g.nw, owned=torch.ones(g.n, dtype=torch.bool,
                                              device=g.device),
    )
