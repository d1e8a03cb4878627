"""Multilevel coarsening (port of ``repro/core/coarsen.py``):
size-constrained label-propagation clustering on the device plus host
(numpy) contraction.

Clustering scores, per vertex, its strongest neighbouring cluster without an
(n, n_clusters) table: edge (src, cluster[dst]) pairs are lexsorted and
reduced per group.  Contraction is host numpy, as in the reference: level
sizes are data-dependent, so the multilevel driver is a host loop anyway.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core.graph import Graph, from_coo
from repro_torch.ops import f32, segment_sum

INT32_MIN = int(np.iinfo(np.int32).min)
INT32_MAX = int(np.iinfo(np.int32).max)


def _segment_reduce(data, ids, num: int, how: str, empty):
    """``jax.ops.segment_max``/``segment_min``: ``empty`` (the reduction's
    identity, as jax fills it) where a segment has no element."""
    out = torch.full((num,), empty, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids.long(), data, how, include_self=True)


def _lexsort2(secondary, primary):
    """``jnp.lexsort((secondary, primary))``: stable two-key sort order."""
    o1 = torch.argsort(secondary, stable=True)
    return o1[torch.argsort(primary[o1], stable=True)]


def grouped_best_cluster(src, cl_dst, w, *, n: int, m: int):
    """Per tail vertex, the strongest neighbouring cluster over
    (src, cluster[dst]) groups; ties to the smallest cluster id.

    Returns (best_cl, has, best_conn); ``best_cl`` is int32::max where a
    vertex has no live group."""
    order = _lexsort2(cl_dst, src)
    src_s = src[order]
    cl_s = cl_dst[order]
    w_s = w[order]

    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=src.device),
        (src_s[1:] != src_s[:-1]) | (cl_s[1:] != cl_s[:-1])])
    gid = torch.cumsum(first, dim=0) - 1  # group id per sorted edge

    gsum = segment_sum(w_s, gid, m)
    gsrc = _segment_reduce(torch.where(first, src_s, -1), gid, m, "amax",
                           INT32_MIN)
    gcl = _segment_reduce(torch.where(first, cl_s, -1), gid, m, "amax",
                          INT32_MIN)
    gsrc_safe = torch.clamp_min(gsrc, 0)

    vmax = _segment_reduce(gsum, gsrc_safe, n, "amax", -torch.inf)
    vmax = torch.where(torch.isfinite(vmax), vmax, 0.0)

    is_best = (gsum >= vmax[gsrc_safe]) & (gsrc >= 0)
    cand_cl = torch.where(is_best, gcl, INT32_MAX)
    best_cl = _segment_reduce(cand_cl, gsrc_safe, n, "amin", INT32_MAX)
    has = best_cl != INT32_MAX
    return best_cl, has, vmax


def _best_neighbor_cluster(g: Graph, cluster):
    cl_dst = cluster[g.safe_col()]
    w = torch.where(g.edge_mask, g.ew, 0.0)
    best_cl, has, vmax = grouped_best_cluster(g.src.long(), cl_dst, w,
                                              n=g.n, m=g.m)
    return torch.where(has, best_cl, cluster), vmax


def cluster_round(g: Graph, cluster, cl_weight_cap, key):
    """One LP clustering round with probabilistic size-cap admission;
    returns (new clusters, number of accepted moves as a 0-d tensor)."""
    best_cl, best_conn = _best_neighbor_cluster(g, cluster)
    cl_w = segment_sum(g.nw, cluster, g.n)
    want = (best_cl != cluster) & (best_conn > 0)
    want &= cl_w[best_cl] + g.nw <= cl_weight_cap

    inflow = segment_sum(torch.where(want, g.nw, 0.0), best_cl, g.n)
    room = torch.clamp_min(cl_weight_cap - cl_w, 0.0)
    p = torch.where(inflow > 0, torch.clamp(
        room / torch.clamp_min(inflow, 1e-9), 0.0, 1.0), 1.0)
    accept = want & (rnd.uniform(key, (g.n,), g.device) < p[best_cl])
    return torch.where(accept, best_cl, cluster), accept.sum()


def cluster(g: Graph, weight_cap: float, key, rounds: int = 5):
    """A few clustering rounds; returns (n,) int64 cluster leader ids."""
    cl = torch.arange(g.n, dtype=torch.int64, device=g.device)
    cap = f32(weight_cap, g.device)
    for _ in range(rounds):
        key, sub = rnd.split(key)
        cl, moved = cluster_round(g, cl, cap, sub)
        if int(moved) == 0:
            break
    # path-compress: follow leader once (LP may chain v→u→w between rounds)
    return cl[cl]


def contract_arrays(cluster, nw, src, col, ew):
    """Pure contraction arithmetic (host numpy) over the *live* directed
    edges.  Returns ``(nc, mapping, nw_c, cu, cv, w)``: mapping relabels
    vertices to coarse ids (the rank of their cluster leader), (cu, cv, w)
    the surviving inter-cluster directed edges, not yet coalesced."""
    cl = np.asarray(cluster, dtype=np.int64)
    uniq, mapping = np.unique(cl, return_inverse=True)
    nc = int(len(uniq))

    nw_c = np.zeros(nc, dtype=np.float32)
    np.add.at(nw_c, mapping, np.asarray(nw))

    cu = mapping[np.asarray(src)]
    cv = mapping[np.asarray(col)]
    w = np.asarray(ew)
    keep = cu != cv  # intra-cluster edges vanish
    return nc, mapping, nw_c, cu[keep], cv[keep], w[keep]


def contract(g: Graph, cluster) -> tuple[Graph, torch.Tensor]:
    """Contract clusters into a coarse graph on the host; returns
    (coarse graph on ``g.device``, int64 mapping fine → coarse id)."""
    live = g.edge_mask.cpu().numpy()
    nc, mapping, nw_c, cu, cv, w = contract_arrays(
        cluster.cpu().numpy(),
        g.nw.cpu().numpy(),
        g.src.cpu().numpy()[live],
        g.safe_col().cpu().numpy()[live],
        g.ew.cpu().numpy()[live],
    )
    coarse = from_coo(nc, cu, cv, w, nw=nw_c, symmetrize=False,
                      device=g.device)
    return coarse, torch.as_tensor(mapping, dtype=torch.int64, device=g.device)


def coarsen_hierarchy(g: Graph, k: int, key, coarsen_until: int | None = None,
                      max_levels: int = 30, shrink_min: float = 0.05):
    """Iteratively coarsen; returns (levels, coarsest) with levels a list of
    (fine_graph, mapping) from finest to coarsest-1."""
    if coarsen_until is None:
        coarsen_until = max(512, 16 * k)
    total_w = float(g.total_node_weight)
    levels = []
    cur = g
    while cur.n > coarsen_until and len(levels) < max_levels:
        # max cluster weight: a cluster must never exceed what fits a block
        cap = max(total_w / coarsen_until, float(cur.nw.max()))
        key, sub = rnd.split(key)
        cl = cluster(cur, cap, sub)
        coarse, mapping = contract(cur, cl)
        if coarse.n >= (1.0 - shrink_min) * cur.n:
            break  # diminishing returns — stop coarsening
        levels.append((cur, mapping))
        cur = coarse
    return levels, cur
