"""Synthetic graph generators (numpy copies of ``grid2d`` and ``rmat`` from
``repro/graphs/generators.py``): the same host arithmetic from the same
seed, so both packages build identical graphs.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, from_coo


def grid2d(nx: int, ny: int, torus: bool = False, seed: int = 0,
           device="cuda") -> Graph:
    """nx*ny lattice; the low-degree mesh-like class (Δ ≤ 4)."""
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    x, y = idx % nx, idx // nx
    es, ed = [], []
    right = x + 1 < nx
    es.append(idx[right]); ed.append(idx[right] + 1)
    up = y + 1 < ny
    es.append(idx[up]); ed.append(idx[up] + nx)
    if torus:
        es.append(idx[x == nx - 1]); ed.append(idx[x == nx - 1] - (nx - 1))
        es.append(idx[y == ny - 1]); ed.append(idx[y == ny - 1] - (ny - 1) * nx)
    return from_coo(n, np.concatenate(es), np.concatenate(ed), device=device)


def rmat(scale: int, edge_factor: int = 8, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, device="cuda") -> Graph:
    """R-MAT / Kronecker generator (Graph500 parameters) — web/social skew."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        right = r > a + b        # falls in c or d quadrant → v bit set
        down = (r > a) & (r <= a + b) | (r > a + b + c)  # b or d → u bit set
        u |= down.astype(np.int64) << lvl
        v |= right.astype(np.int64) << lvl
    keep = u != v
    return from_coo(n, u[keep], v[keep], device=device)
