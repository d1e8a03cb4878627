"""Multilevel V-cycle driver (port of ``repro/core/multilevel.py::partition``):
coarsen → initial partition → uncoarsen + refine.

``refiner`` names a registered refinement variant
(``repro_torch.refine.variants``) or alias; ``schedule`` a per-level
tolerance schedule (``repro_torch.refine.schedule``); ``gain`` the gain
backend (``"segment"``, ``"kernel"`` or ``"auto"``).  From the same graph
and seed the labels are bit-identical to ``repro.core.partition`` on
integer-weight graphs, for every gain backend.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as rnd
from repro_torch.core import coarsen as C
from repro_torch.core.config import UNSET, PartitionConfig, resolve_config
from repro_torch.core.graph import Graph
from repro_torch.core.initial import initial_partition
from repro_torch.core.partition import edge_cut, imbalance
from repro_torch.core.refine import jet_refine, lp_refine_level
from repro_torch.refine.drivers import level_tolerances
from repro_torch.refine.schedule import ToleranceSchedule, weight_frac


def level_trace_entry(n, eps, imb) -> dict:
    """The per-level trace record (``PartitionResult.level_trace``)."""
    return {"n": int(n), "eps": float(eps), "imbalance": float(imb)}


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    labels: torch.Tensor  # (n,) int32 on the graph's device
    cut: float
    imbalance: float
    levels: int
    # per-level tolerances eps_l actually targeted, coarsest → finest
    level_eps: tuple = ()
    # per-level {n, eps, imbalance} after each level's refinement
    # (coarsest → finest), populated by partition(trace_levels=True)
    level_trace: tuple | None = None


def _refine(g: Graph, labels, k, eps, key, var, patience: int,
            max_inner: int, gain: str):
    if var.mode == "lp":
        return lp_refine_level(g, labels, k, eps, key, gain=gain)
    return jet_refine(g, labels, k, eps, key, rounds=var.rounds,
                      patience=patience, max_inner=max_inner, gain=gain,
                      variant=var.name)


def partition(
    g: Graph,
    k: int | None = UNSET,
    eps: float | None = UNSET,
    seed: int = 0,
    refiner: str | None = UNSET,
    coarsen_until: int | None = UNSET,
    patience: int | None = UNSET,
    max_inner: int | None = UNSET,
    gain: str | None = UNSET,
    schedule: str | ToleranceSchedule | None = UNSET,
    eps_coarse: float | None = UNSET,
    trace_levels: bool = False,
    ckpt=UNSET,
    resume: str | None = None,
    config: PartitionConfig | None = None,
    device="cuda",
) -> PartitionResult:
    """Full multilevel partition of ``g`` into ``k`` blocks on ``device``
    (default ``"cuda"``; ``g`` is moved there if it lives elsewhere).

    All static knobs live in one frozen :class:`PartitionConfig`; the loose
    kwargs override its fields.  ``trace_levels=True`` records each level's
    imbalance after refinement in ``PartitionResult.level_trace``.
    Checkpoints (``ckpt``/``resume``) belong to a later slice of the port
    and raise ``ValueError`` here."""
    cfg = resolve_config(config, where="partition", k=k, eps=eps,
                         refiner=refiner, schedule=schedule,
                         eps_coarse=eps_coarse, gain=gain, patience=patience,
                         max_inner=max_inner, coarsen_until=coarsen_until,
                         ckpt=ckpt)
    if cfg.ckpt is not None or resume is not None:
        raise ValueError(
            "partition: checkpointing (ckpt=/resume=) is not ported yet — it "
            "comes with the ingest-and-checkpoint slice of repro_torch")
    g = g.to(device)
    var, sched = cfg.variant(), cfg.tolerance_schedule()
    k, eps, gain = cfg.k, cfg.eps, cfg.gain
    key = rnd.PRNGKey(seed)
    k_coarse, k_init, key = rnd.split(key, 3)

    levels, coarsest = C.coarsen_hierarchy(g, k, k_coarse,
                                           coarsen_until=cfg.coarsen_until)
    n_levels = len(levels) + 1
    w_fracs = None
    if sched.mode == "adaptive":
        w_fracs = tuple(weight_frac(lg.nw.cpu().numpy()) for lg in
                        [coarsest] + [f for f, _ in reversed(levels)])
    eps_l = level_tolerances(sched, eps, n_levels, k, w_fracs=w_fracs)

    # rung j refines level_graphs[j]; rung j > 0 first projects through
    # mappings[j-1]
    level_graphs = [coarsest] + [fine for fine, _ in reversed(levels)]
    mappings = [mapping for _, mapping in reversed(levels)]

    labels = initial_partition(coarsest, k, eps, k_init)
    trace: list[dict] = []
    for j in range(n_levels):
        if j > 0:
            labels = labels[mappings[j - 1]]  # project to the finer level
        key, sub = rnd.split(key)
        labels = _refine(level_graphs[j], labels, k, eps_l[j], sub, var,
                         cfg.patience, cfg.max_inner, gain)
        if trace_levels:
            trace.append(level_trace_entry(
                level_graphs[j].n, eps_l[j],
                imbalance(level_graphs[j], labels, k)))

    return PartitionResult(
        labels=labels.to(torch.int32),
        cut=float(edge_cut(g, labels)),
        imbalance=float(imbalance(g, labels, k)),
        levels=n_levels,
        level_eps=eps_l,
        level_trace=tuple(trace) if trace_levels else None,
    )
