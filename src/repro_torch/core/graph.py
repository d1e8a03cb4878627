"""Static-shape graph representation (port of ``repro/core/graph.py``).

The partitioner works on an undirected graph stored as *directed* CSR:
every undirected edge {u, v} appears as (u, v) and (v, u).  ``src[e]`` is
the tail of edge slot e (the expanded row index), so every per-edge
computation is a gather plus an ``index_add_``.  Padding edge slots carry
``col == PAD`` and weight 0, so they are inert in every reduction.

Index arrays keep the reference's int32 dtype; code that indexes with them
widens to int64 where torch requires it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

PAD = int(np.iinfo(np.int32).max)  # sentinel column for padding edges


def resolve_device(device) -> torch.device:
    """The port's device rule: entry points default to ``"cuda"`` and run on
    the CPU only when the caller asks for it.  No silent fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the partitioner on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable static-shape graph.  ``n``/``m`` count vertices and
    directed edge slots (padding included)."""

    row_ptr: torch.Tensor  # (n+1,) int32
    col: torch.Tensor      # (m,)  int32, PAD for padding slots
    src: torch.Tensor      # (m,)  int32, tail vertex of each slot
    ew: torch.Tensor       # (m,)  float32, 0 for padding slots
    nw: torch.Tensor       # (n,)  float32, vertex weights
    n: int
    m: int

    @property
    def device(self) -> torch.device:
        return self.nw.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def edge_mask(self) -> torch.Tensor:
        """(m,) bool — True for live (non-padding) edge slots."""
        return self.col != PAD

    @property
    def total_node_weight(self) -> torch.Tensor:
        return self.nw.sum()

    def to(self, device) -> "Graph":
        """This graph on ``device`` (itself when already there)."""
        device = resolve_device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("row_ptr", "col", "src", "ew", "nw")})

    def safe_col(self) -> torch.Tensor:
        """Column ids with padding redirected to vertex 0 (weight-0 edges
        keep the contribution inert), as int64 for indexing."""
        return torch.where(self.edge_mask, self.col, 0).long()


def from_arrays(row_ptr, col, src, ew, nw, n: int, m: int,
                device="cuda") -> Graph:
    """Adopt CSR arrays built elsewhere (e.g. the fields of a reference
    ``repro`` graph through ``np.asarray``) onto ``device``."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    g = Graph(row_ptr=t(row_ptr, torch.int32), col=t(col, torch.int32),
              src=t(src, torch.int32), ew=t(ew, torch.float32),
              nw=t(nw, torch.float32), n=int(n), m=int(m))
    if g.row_ptr.shape != (g.n + 1,) or g.nw.shape != (g.n,) or not (
            g.col.shape == g.src.shape == g.ew.shape == (g.m,)):
        raise ValueError("from_arrays: array shapes do not match n and m")
    return g


def from_coo(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    w: Optional[np.ndarray] = None,
    nw: Optional[np.ndarray] = None,
    symmetrize: bool = True,
    device="cuda",
) -> Graph:
    """Build a :class:`Graph` from a COO edge list on the host (numpy),
    then move it to ``device``.  Self loops are dropped and duplicate edges
    coalesced (weights summed) — the reference's exact host arithmetic."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if w is None:
        w = np.ones(u.shape[0], dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)

    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]

    if symmetrize:
        uu = np.concatenate([u, v])
        vv = np.concatenate([v, u])
        ww = np.concatenate([w, w])
    else:
        uu, vv, ww = u, v, w

    key = uu * n + vv
    order = np.argsort(key, kind="stable")
    key, ww = key[order], ww[order]
    uniq, start = np.unique(key, return_index=True)
    wsum = np.add.reduceat(ww, start) if len(ww) else ww
    uu = (uniq // n).astype(np.int32)
    vv = (uniq % n).astype(np.int32)

    m = int(len(uniq))
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(row_ptr, uu + 1, 1)
    row_ptr = np.cumsum(row_ptr, dtype=np.int64).astype(np.int32)

    if nw is None:
        nw = np.ones(n, dtype=np.float32)
    return from_arrays(row_ptr, vv, uu, wsum.astype(np.float32),
                       np.asarray(nw, dtype=np.float32), n, m, device)


def pad_graph(g: Graph, n_pad: int, m_pad: int) -> Graph:
    """Pad vertex/edge arrays to (n_pad, m_pad) with inert entries."""
    if n_pad < g.n or m_pad < g.m:
        raise ValueError(f"pad_graph: ({n_pad}, {m_pad}) < ({g.n}, {g.m})")
    dev = g.device
    row_ptr = torch.cat([g.row_ptr, g.row_ptr[-1:].expand(n_pad - g.n)])
    col = torch.cat([g.col, torch.full((m_pad - g.m,), PAD, dtype=torch.int32,
                                       device=dev)])
    src = torch.cat([g.src, torch.zeros(m_pad - g.m, dtype=torch.int32,
                                        device=dev)])
    ew = torch.cat([g.ew, torch.zeros(m_pad - g.m, device=dev)])
    nw = torch.cat([g.nw, torch.zeros(n_pad - g.n, device=dev)])
    return Graph(row_ptr=row_ptr, col=col, src=src, ew=ew, nw=nw,
                 n=n_pad, m=m_pad)


def to_padded_fast(g: Graph, max_deg: int):
    """``(nbr, nbr_w)`` of shape (n, max_deg): each edge slot scattered to
    (src, rank within its row); PAD / 0 where unused."""
    src = g.src.long()
    rank = torch.arange(g.m, device=g.device) - g.row_ptr.long()[src]
    ok = (rank < max_deg) & g.edge_mask
    nbr = torch.full((g.n, max_deg), PAD, dtype=torch.int32, device=g.device)
    nbr_w = torch.zeros((g.n, max_deg), dtype=torch.float32, device=g.device)
    nbr[src[ok], rank[ok]] = g.col[ok]
    nbr_w[src[ok], rank[ok]] = g.ew[ok]
    return nbr, nbr_w
