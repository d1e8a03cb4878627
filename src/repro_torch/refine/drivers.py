"""Single-device level driver (port of the ``refine_single`` part of
``repro/refine/drivers.py``).

The reference compiles one level into one XLA program and counts a
dispatch per level; here a level is a host loop of eager launches
(``engine.py``), and ``DISPATCH_COUNT`` still counts one per level call.
"""

from __future__ import annotations

from repro_torch.refine import engine
from repro_torch.refine.comm import SingleComm, edge_view_from_graph
from repro_torch.refine.gain import make_gain, resolve_gain
from repro_torch.refine.schedule import ToleranceSchedule, resolve_schedule
from repro_torch.refine.variants import resolve_variant

DISPATCH_COUNT = 0   # level-refinement calls


def reset_counters() -> None:
    global DISPATCH_COUNT
    DISPATCH_COUNT = 0


def level_tolerances(schedule: str | ToleranceSchedule, eps: float,
                     n_levels: int, k: int,
                     eps_coarse: float | None = None,
                     w_fracs=None) -> tuple[float, ...]:
    """One V-cycle's per-level imbalance tolerances (index 0 = coarsest …
    ``n_levels − 1`` = finest)."""
    return resolve_schedule(schedule, eps_coarse).eps_levels(
        eps, n_levels, k, w_fracs)


def graph_max_deg(g) -> int:
    """True maximum degree of a level (sizes the kernel's padded
    adjacency); one scalar read from the device."""
    return max(int(g.degrees.max()) if g.n else 0, 1)


def refine_single(g, labels, k, key, lmax, taus, *, patience=12,
                  max_inner=64, gain="segment", variant="jet"):
    """Single-device level refinement.  ``variant`` names a registered
    move-generation rule; lp-mode variants ignore ``taus``/``patience``/
    ``max_inner``."""
    global DISPATCH_COUNT
    var = resolve_variant(variant)  # fail on a typo before any work
    kind = resolve_gain(gain, k)
    DISPATCH_COUNT += 1
    ev = edge_view_from_graph(g)
    cm = SingleComm(g.n)
    gb = make_gain(kind, ev, k, graph_max_deg(g) if kind == "kernel" else None)
    if var.mode == "lp":
        return engine.lp_level(cm, gb, ev, labels, key, lmax, k)
    return engine.refine_level(cm, gb, ev, labels, key, lmax, taus, k,
                               patience, max_inner, move_fn=var.move)
