"""Per-level imbalance-tolerance schedules (a pure-Python copy of
``repro/refine/schedule.py``; see the reference's DESIGN.md §2 "Tolerance
schedule").

The paper's unconstrained local search allows imbalance *during* refinement
and restores it later; Jet realises this with a tolerance that tightens from
the coarsest level to the finest, and dKaMinPar shows the per-level value
must stay inside the fused level program to scale.  A
:class:`ToleranceSchedule` maps (final ``eps``, level depth, level count) to
the per-level tolerance ``eps_l`` the rebalancer targets at that level —
``L_max(l) = (1 + eps_l)·⌈c(V)/k⌉``.  The value is a plain Python float
resolved at V-cycle setup time (``drivers.level_tolerances``).

Modes:

  * ``constant``  — ``eps_l = eps`` at every level (the pre-schedule
    behaviour, and the default).
  * ``geometric`` — geometric interpolation from ``eps_coarse`` at the
    coarsest level down to the final ``eps`` at the finest:
    ``eps_l = eps · (eps_coarse/eps)^(d/(L−1))`` with ``d`` the depth above
    the finest level.  The finest level always gets exactly ``eps``.
  * ``snap``      — unconstrained-then-snap: every coarse level is
    effectively unconstrained (``eps_l = k``, i.e. ``L_max ≥ c(V)`` so no
    block can ever be overloaded and the rebalancer never fires), and only
    the finest level snaps back to ``eps``.  ``unconstrained-then-snap``
    is accepted as an alias.
  * ``adaptive``  — the dKaMinPar weight-aware rule:
    ``eps_l = max(eps, k·w_max(l)/c(V))`` with ``w_max(l)`` the heaviest
    vertex of the level.  This makes ``L_max(l) ≳ ⌈c(V)/k⌉ + w_max(l)``,
    so a block can always absorb one heaviest vertex above perfect
    balance — the feasibility floor contraction pushes against (coarse
    vertices aggregate weight; a constant ``eps`` can be *unsatisfiable*
    at coarse levels).  On the finest level of a unit-weight graph
    ``k·w_max/c(V) = k/n ≪ eps``, so the final tolerance degrades to
    exactly ``eps``.  ``weight-adaptive`` is accepted as an alias.  The
    per-level ``w_max/c(V)`` fractions are threaded in by the V-cycle
    drivers (``w_fracs``); with no weight information the mode degrades
    to ``constant``.

Determinism: ``eps_l`` is derived from (mode, eps, eps_coarse, depth, L, k)
in double-precision host arithmetic — identical on every path for the same
hierarchy — so the per-level ``L_max`` values agree with the reference's
and across the gain backends.
"""

from __future__ import annotations

from typing import NamedTuple

SCHEDULES = ("constant", "geometric", "snap", "adaptive")
SCHEDULE_ALIASES = {"unconstrained-then-snap": "snap",
                    "weight-adaptive": "adaptive"}

# geometric default for the coarsest level when the caller gives no
# eps_coarse: hot enough that coarse levels genuinely wander (paper §2)
DEFAULT_EPS_COARSE = 0.25


class ToleranceSchedule(NamedTuple):
    """A per-level imbalance-tolerance schedule.

    ``eps_coarse`` is the coarsest-level tolerance of the ``geometric``
    mode (``None`` → :data:`DEFAULT_EPS_COARSE`; always clamped to at
    least the final ``eps``); the other modes ignore it.
    """

    mode: str = "constant"
    eps_coarse: float | None = None

    def eps_at(self, eps: float, depth: int, n_levels: int, k: int,
               w_frac: float | None = None) -> float:
        """Tolerance at one level; ``depth`` counts up from the finest
        level (0) to the coarsest (``n_levels − 1``).  ``w_frac`` is the
        level's ``w_max/c(V)`` fraction (``adaptive`` mode only; the
        other modes ignore it, and ``None`` degrades ``adaptive`` to the
        constant rule at that level)."""
        if not 0 <= depth < max(n_levels, 1):
            raise ValueError(f"depth {depth} outside [0, {n_levels})")
        if self.mode == "adaptive":
            # applies at EVERY depth (including the finest): the rule is a
            # feasibility floor, not a coarse-level relaxation
            if w_frac is None:
                return float(eps)
            return float(max(float(eps), float(k) * float(w_frac)))
        if self.mode == "constant" or depth == 0 or n_levels <= 1:
            return float(eps)
        if self.mode == "geometric":
            ec = DEFAULT_EPS_COARSE if self.eps_coarse is None else self.eps_coarse
            ec = max(float(ec), float(eps))
            frac = depth / (n_levels - 1)
            if eps <= 0.0:
                # geometric interpolation is undefined at eps = 0 (the
                # ratio ec/eps diverges); fall back to the linear ramp,
                # which keeps the exact endpoints and monotonicity
                return float(eps + (ec - eps) * frac)
            return float(eps * (ec / eps) ** frac)
        if self.mode == "snap":
            # L_max = (1 + k)·⌈c(V)/k⌉ ≥ k·⌈c(V)/k⌉ ≥ c(V): unconstrained
            return float(k)
        raise ValueError(f"unknown schedule mode {self.mode!r}")

    def eps_levels(self, eps: float, n_levels: int, k: int,
                   w_fracs=None) -> tuple[float, ...]:
        """Per-level tolerances, index 0 = coarsest … ``n_levels − 1`` =
        finest (the V-cycle's refinement order).  ``w_fracs`` is the
        matching coarsest-first sequence of per-level ``w_max/c(V)``
        fractions (``adaptive`` mode; ``None`` elements/argument degrade
        to the constant rule)."""
        if w_fracs is not None and len(w_fracs) != n_levels:
            raise ValueError(
                f"w_fracs has {len(w_fracs)} entries for {n_levels} levels")
        return tuple(
            self.eps_at(eps, n_levels - 1 - i, n_levels, k,
                        None if w_fracs is None else w_fracs[i])
            for i in range(n_levels))


def weight_frac(nw) -> float:
    """One level's ``w_max/c(V)`` fraction from its vertex-weight vector —
    the ``adaptive`` schedule's per-level input.  Padding slots carry zero
    weight in every layout (sharded, halo, batched buckets), so the value
    is identical no matter how the level is laid out; the float64 host
    arithmetic makes it bit-identical across paths."""
    import numpy as np

    a = np.asarray(nw, dtype=np.float64)
    s = float(a.sum())
    return float(a.max(initial=0.0) / s) if s > 0 else 0.0


def resolve_schedule(schedule: str | ToleranceSchedule,
                     eps_coarse: float | None = None) -> ToleranceSchedule:
    """Resolve a ``schedule=`` argument to a :class:`ToleranceSchedule`,
    accepting a mode name (or alias) or an already-built schedule; raises
    ``ValueError`` listing the registered modes — called eagerly by
    ``partition``/``dpartition`` so a typo fails at the API boundary.

    An explicitly-passed ``eps_coarse`` always wins: it is the API-level
    knob, so it also overrides the field of an already-built schedule."""
    if isinstance(schedule, ToleranceSchedule):
        if schedule.mode not in SCHEDULES:
            raise ValueError(
                f"unknown schedule mode {schedule.mode!r}: "
                f"modes are {list(SCHEDULES)}")
        if eps_coarse is not None:
            return schedule._replace(eps_coarse=eps_coarse)
        return schedule
    name = SCHEDULE_ALIASES.get(schedule, schedule)
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}: modes are {list(SCHEDULES)} "
            f"(aliases: {sorted(SCHEDULE_ALIASES)})")
    return ToleranceSchedule(name, eps_coarse)
