"""d4xJet integration (port of ``repro/core/refine.py``): t temperature
rounds with τ interpolating linearly from τ0 = 0.75 down to τ1 = 0.25; within
a round, (Jet → rebalance) repeats until ``patience`` consecutive iterations
fail to improve the best balanced partition, which is kept.
"""

from __future__ import annotations

from repro_torch import random as rnd
from repro_torch.core.graph import Graph
from repro_torch.core.partition import l_max
from repro_torch.core.rebalance import rebalance
from repro_torch.refine.drivers import refine_single

TAU0 = 0.75
TAU1 = 0.25


def temperature_schedule(rounds: int, tau0: float = TAU0, tau1: float = TAU1):
    """τ_i linear from τ0 (round 0) to τ1 (last round), inclusive; a single
    round runs cold (τ1)."""
    if rounds == 1:
        return [tau1]
    return [tau0 + (i / (rounds - 1)) * (tau1 - tau0) for i in range(rounds)]


def jet_refine(g: Graph, labels, k: int, eps: float, key, rounds: int = 4,
               patience: int = 12, max_inner: int = 64, gain: str = "segment",
               variant: str = "jet"):
    """d4xJet (rounds=4) / dJet (rounds=1) refinement at one level."""
    lmax = l_max(g, k, eps)
    return refine_single(g, labels, k, key, lmax, temperature_schedule(rounds),
                         patience=patience, max_inner=max_inner, gain=gain,
                         variant=variant)


def lp_refine_level(g: Graph, labels, k: int, eps: float, key,
                    gain: str = "segment"):
    """The ``lp`` variant at one level (LP rounds + rebalance finisher)."""
    lmax = l_max(g, k, eps)
    return refine_single(g, labels, k, key, lmax, [0.0], gain=gain,
                         variant="lp")


def lp_refine_balanced(g: Graph, labels, k: int, eps: float, key,
                       max_rounds: int = 16):
    """dLP baseline refinement: size-constrained LP + rebalance finisher."""
    from repro_torch.core.lp import lp_refine

    lmax = l_max(g, k, eps)
    k1, k2 = rnd.split(key)
    labels = lp_refine(g, labels, k, lmax, k1, max_rounds=max_rounds)
    return rebalance(g, labels, k, lmax, k2).labels
