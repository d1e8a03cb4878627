"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Import after ``pytest.importorskip("torch")``.  The module-scoped autouse
fixture :func:`fresh_jax_caches` (import it into the test module) drops
jax's compiled programs before and after a module: every compiled XLA CPU
program holds memory mappings, and a pytest worker that runs many files
must not accumulate them.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()


def port_graph(g):
    """The port's CPU copy of a reference ``repro`` graph."""
    from repro_torch.core.graph import from_arrays

    return from_arrays(*(np.asarray(a) for a in (g.row_ptr, g.col, g.src,
                                                  g.ew, g.nw)),
                       g.n, g.m, device="cpu")


def reference_partitions(g, k: int, configs) -> dict:
    """``repro.core.partition`` of ``g`` for each (refiner, schedule),
    with the level trace, on the jnp gain backend."""
    from repro.core import partition

    return {cfg: partition(g, k, refiner=cfg[0], schedule=cfg[1], seed=0,
                           trace_levels=True, gain="jnp")
            for cfg in configs}


def partition_mismatches(g, k: int, refs: dict, gain: str) -> list:
    """The port's partitions of ``g`` on ``gain`` against ``refs``; returns
    a list of (config, differing fields), empty when all are bit-equal."""
    from repro_torch.core import partition

    pg = port_graph(g)
    bad = []
    for (refiner, schedule), ref in refs.items():
        got = partition(pg, k, refiner=refiner, schedule=schedule, seed=0,
                        trace_levels=True, gain=gain, device="cpu")
        fields = {
            "labels": np.array_equal(np.asarray(ref.labels),
                                     got.labels.numpy()),
            "cut": ref.cut == got.cut,
            "imbalance": ref.imbalance == got.imbalance,
            "levels": ref.levels == got.levels,
            "level_eps": ref.level_eps == got.level_eps,
            "level_trace": ref.level_trace == got.level_trace,
        }
        diff = [name for name, same in fields.items() if not same]
        if diff:
            bad.append(((refiner, schedule), diff))
    return bad
