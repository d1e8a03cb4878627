"""The PyTorch port's refinement engine against the reference: one Jet
round (including the reference's known cut-raising round, reproduced, not
"fixed"), one greedy epoch, one probabilistic pass and the rebalance loop
give equal labels on an integer-weight graph, and the rebalancer's bucket
index agrees on a large fuzz."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core as rc  # noqa: E402
from repro.core.graph import from_coo  # noqa: E402
from repro.graphs import grid2d  # noqa: E402
from repro.refine.engine import N_BUCKETS  # noqa: E402
from repro.refine.engine import _bucket_index as jax_bucket_index  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.refine import engine  # noqa: E402
from torch_parity import fresh_jax_caches, port_graph  # noqa: E402,F401


@pytest.fixture(scope="module")
def weighted():
    """grid2d(16, 16)'s edges with integer edge and vertex weights."""
    base = grid2d(16, 16)
    live = np.asarray(base.col) != np.iinfo(np.int32).max
    u, v = np.asarray(base.src)[live], np.asarray(base.col)[live]
    keep = u < v
    rng = np.random.default_rng(11)
    g = from_coo(base.n, u[keep], v[keep],
                 rng.integers(1, 6, keep.sum()).astype(np.float32),
                 nw=rng.integers(1, 4, base.n).astype(np.float32))
    return g, port_graph(g)


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def cut_raising():
    """The reference's known counterexample to "a Jet round never raises the
    cut": a 4-vertex graph (edges 0-1 w=4, 0-2 w=7, 1-3 w=1; nw 2,2,3,3),
    k=2, labels randint(PRNGKey(1)), tau=1.0 — one gain-ordered round takes
    the cut from 4 to 7.  The port must reproduce the labels, not the
    property."""
    u, v, w = np.array([0, 0, 1]), np.array([1, 2, 3]), np.array([4.0, 7.0, 1.0])
    nw = np.array([2.0, 2.0, 3.0, 3.0], np.float32)
    g = from_coo(4, u, v, w.astype(np.float32), nw=nw)
    labels = np.array(jax.random.randint(jax.random.PRNGKey(1), (4,), 0, 2))
    return g, labels


def test_jet_round_matches_reference(weighted, cut_raising):
    g, pg = weighted
    rng = np.random.default_rng(3)
    k = 4
    for _ in range(3):
        labels = rng.integers(0, k, g.n).astype(np.int32)
        locked = rng.random(g.n) < 0.2
        for tau in (0.75, 0.25):
            ref = rc.jet_round(g, jnp.asarray(labels), jnp.asarray(locked), k,
                               tau)
            got = tc.jet_round(pg, torch.from_numpy(labels),
                               torch.from_numpy(locked), k, tau)
            assert _eq(ref.labels, got.labels) and _eq(ref.locked, got.locked)

    g, labels = cut_raising
    pg = port_graph(g)
    ref = rc.jet_round(g, jnp.asarray(labels), jnp.zeros(4, bool), 2, 1.0)
    got = tc.jet_round(pg, torch.from_numpy(labels),
                       torch.zeros(4, dtype=torch.bool), 2, 1.0)
    assert float(rc.edge_cut(g, jnp.asarray(labels))) == 4.0
    assert float(rc.edge_cut(g, ref.labels)) == 7.0
    assert _eq(ref.labels, got.labels)
    assert float(tc.edge_cut(pg, got.labels)) == 7.0


def test_rebalancers_and_lp_match_reference(weighted):
    g, pg = weighted
    rng = np.random.default_rng(3)
    k = 4
    for trial in range(3):
        # skewed labels: block 0 overloaded, so the rebalancers have work
        labels = np.where(rng.random(g.n) < 0.45, 0,
                          rng.integers(0, k, g.n)).astype(np.int32)
        lab_t = torch.from_numpy(labels)
        key = jax.random.PRNGKey(trial)
        tkey = R.PRNGKey(trial)
        lmax = rc.l_max(g, k, 0.03)
        lmax_t = tc.l_max(pg, k, 0.03)
        assert np.float32(lmax) == lmax_t.numpy()

        assert _eq(rc.greedy_epoch(g, jnp.asarray(labels), k, lmax),
                   tc.greedy_epoch(pg, lab_t, k, lmax_t))
        assert _eq(rc.probabilistic_pass(g, jnp.asarray(labels), k, lmax, key),
                   tc.probabilistic_pass(pg, lab_t, k, lmax_t, tkey))
        ref = rc.rebalance(g, jnp.asarray(labels), k, lmax, key)
        got = tc.rebalance(pg, lab_t, k, lmax_t, tkey)
        assert _eq(ref.labels, got.labels)
        assert (float(ref.overload), int(ref.epochs), int(ref.prob_passes)) == (
            got.overload, got.epochs, got.prob_passes)
        assert got.epochs > 0
        assert _eq(rc.lp_refine_balanced(g, jnp.asarray(labels), k, 0.03, key),
                   tc.lp_refine_balanced(pg, lab_t, k, 0.03, tkey))


def reference_bucket_steps():
    """The reference bucket index's step points as float32 bit patterns:
    entry m - 1 is the smallest float32 x > 0 whose bucket (of r = -x) is at
    least m + 2, found by bisection over the bit patterns of the normal
    floats (the bucket is non-decreasing in x)."""
    bucket = jax.jit(jax_bucket_index)

    def of(bits):
        return np.asarray(bucket(-bits.astype(np.uint32).view(np.float32)))

    want = np.arange(1, N_BUCKETS - 2) + 2
    lo = np.full(want.shape, 0x00800000, np.int64)  # smallest normal float
    hi = np.full(want.shape, 0x7F800000, np.int64)  # +inf
    assert (of(hi) >= want).all()
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        ok = of(mid) >= want
        hi, lo = np.where(ok, mid, hi), np.where(ok, lo, mid)
    assert (of(hi - 1) == want - 1).all() and (of(hi) == want).all()
    return tuple(int(b) for b in hi)


def test_bucket_index_matches_reference():
    assert engine._BUCKET_STEPS == reference_bucket_steps()
    rng = np.random.default_rng(7)
    gains = rng.integers(-2000, 2000, 60_000).astype(np.float32)
    cv = rng.integers(1, 300, 60_000).astype(np.float32)
    r = np.concatenate([
        np.where(gains > 0, gains * cv, gains / cv),
        -np.exp(rng.uniform(-20, 14, 60_000)),
        -(np.float32(1.1) ** np.arange(0, 100, dtype=np.float32) - 1),
        [0.0, -0.0, np.inf, -np.inf, -1e-30, 1e-30],
    ]).astype(np.float32)
    r = np.concatenate([r, np.nextafter(r, np.float32(np.inf)),
                        np.nextafter(r, np.float32(-np.inf))])
    # XLA on the CPU flushes subnormals to zero and torch does not; gains are
    # integers and vertex weights >= 1, so r is never subnormal in the engine
    r = r[(r == 0) | ~(np.abs(r) < np.finfo(np.float32).tiny)]
    assert r.size >= 100_000
    want = np.asarray(jax.jit(jax_bucket_index)(jnp.asarray(r)))
    got = engine._bucket_index(torch.from_numpy(r)).numpy()
    assert np.array_equal(want, got)
