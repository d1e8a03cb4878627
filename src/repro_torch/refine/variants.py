"""The refinement-variant registry (port of ``repro/refine/variants.py``).

A variant's ``move`` function has the signature

    move(cm, gb, ev, labels, locked, tau, k) -> (new_labels, moved_mask)

with ``cm`` a comm backend, ``gb`` a gain backend, ``ev`` the level's
:class:`~repro_torch.refine.comm.EdgeView`, ``locked`` the moved-last-
iteration mask and ``tau`` the current temperature (a float32 scalar).

Registered variants:

  * ``jet``   — the Jet rule (d4xJet default): negative gains admitted up
    to −⌊τ·conn_own⌋, movers locked for the next iteration, afterburner
    keeps moves with assumed-state delta ≥ 0.
  * ``jetlp`` — no lock; a negative-gain candidate survives the
    afterburner only on strictly positive delta.
  * ``jet_h`` — vertices heavier than the mean vertex weight enter M only
    on strictly positive gain.
  * ``jet_v`` — the afterburner's virtual order is vertex-id order.
  * ``lp``    — size-constrained label propagation (``engine.lp_level``).

Aliases: ``d4xjet`` → ``jet`` (4 rounds), ``djet`` → ``jet`` with 1 round,
``djet_v`` → ``jet_v`` with 1 round, ``dlp`` → ``lp``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.refine import engine
from repro_torch.refine.comm import EdgeView


class Variant(NamedTuple):
    """One registered refinement variant: ``mode`` is ``"jet"`` (temperature
    rounds × inner loop) or ``"lp"``; ``rounds`` the default number of
    temperature rounds."""

    name: str
    mode: str
    move: Callable | None
    rounds: int


def jetlp_move(cm, gb, ev: EdgeView, labels, locked, tau, k: int):
    """JetLP: LP-style unconstrained moves, ``locked`` ignored."""
    lv_e = engine._head_labels(cm, ev, labels)
    own, gain, target = gb.best(ev, lv_e, labels, None)
    cand = engine.candidate_set(ev, labels, own, gain, target, tau)
    delta = engine.afterburner_delta(cm, ev, labels, lv_e, gain, target, cand)
    move = cand & torch.where(gain < 0, delta > 0.0, delta >= 0.0)
    return torch.where(move, target, labels), move


def jet_h_move(cm, gb, ev: EdgeView, labels, locked, tau, k: int):
    """Heavy-vertex-deferred Jet."""
    lv_e = engine._head_labels(cm, ev, labels)
    own, gain, target = gb.best(ev, lv_e, labels, None)

    w_tot = cm.psum(torch.where(ev.owned, ev.nw, 0.0).sum())
    n_tot = cm.psum(ev.owned.to(torch.float32).sum())
    heavy = ev.nw > w_tot / torch.clamp_min(n_tot, 1.0)

    cand = engine.candidate_set(ev, labels, own, gain, target, tau, locked)
    cand &= (~heavy) | (gain > 0.0)

    delta = engine.afterburner_delta(cm, ev, labels, lv_e, gain, target, cand)
    move = cand & (delta >= 0.0)
    return torch.where(move, target, labels), move


def jet_v_move(cm, gb, ev: EdgeView, labels, locked, tau, k: int):
    """Vertex-ordered Jet."""
    lv_e = engine._head_labels(cm, ev, labels)
    own, gain, target = gb.best(ev, lv_e, labels, None)
    cand = engine.candidate_set(ev, labels, own, gain, target, tau, locked)
    delta = engine.afterburner_delta(cm, ev, labels, lv_e, gain, target, cand,
                                     order="vertex")
    move = cand & (delta >= 0.0)
    return torch.where(move, target, labels), move


_REGISTRY: dict[str, Variant] = {}


def register(variant: Variant) -> Variant:
    """Register a variant."""
    if variant.name in _REGISTRY:
        raise ValueError(f"variant {variant.name!r} already registered")
    if variant.mode not in ("jet", "lp"):
        raise ValueError(f"variant mode must be 'jet' or 'lp', got {variant.mode!r}")
    if variant.mode == "jet" and variant.move is None:
        raise ValueError(f"jet-mode variant {variant.name!r} needs a move function")
    _REGISTRY[variant.name] = variant
    return variant


JET = register(Variant("jet", "jet", engine.jet_move, rounds=4))
JETLP = register(Variant("jetlp", "jet", jetlp_move, rounds=4))
JET_H = register(Variant("jet_h", "jet", jet_h_move, rounds=4))
JET_V = register(Variant("jet_v", "jet", jet_v_move, rounds=4))
LP = register(Variant("lp", "lp", None, rounds=1))

ALIASES: dict[str, Variant] = {
    "d4xjet": JET,
    "djet": JET._replace(rounds=1),
    "djet_v": JET_V._replace(rounds=1),
    "dlp": LP,
}


def registered_variants() -> tuple[str, ...]:
    """Canonical variant names, sorted (aliases not included)."""
    return tuple(sorted(_REGISTRY))


def resolve_variant(name: str) -> Variant:
    """Resolve a ``refiner=`` name (or alias) to its :class:`Variant`;
    raises ``ValueError`` listing what is registered."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in ALIASES:
        return ALIASES[name]
    raise ValueError(
        f"unknown refiner {name!r}: registered variants are "
        f"{list(registered_variants())} "
        f"(aliases: {sorted(ALIASES)})")
