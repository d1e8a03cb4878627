"""The PyTorch port's graph layer, coarsening and greedy seeding against
the reference: CSR construction, padding, the padded adjacency and the
partition metrics agree exactly, ``coarsen_hierarchy`` builds the same
hierarchy (level sizes, mappings and CSR arrays) from the same key, and the
initial partition's greedy seeding gives the same labels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core as rc  # noqa: E402
from repro.core.coarsen import coarsen_hierarchy as jax_hierarchy  # noqa: E402
from repro.graphs import grid2d, rmat  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graphs as tg  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.coarsen import coarsen_hierarchy  # noqa: E402
from torch_parity import fresh_jax_caches, port_graph  # noqa: E402,F401

FIELDS = ("row_ptr", "col", "src", "ew", "nw")


def same_graph(ref, got):
    return (ref.n, ref.m) == (got.n, got.m) and all(
        np.array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy())
        for f in FIELDS)


def test_graph_layer_matches_reference():
    assert same_graph(grid2d(7, 5), tg.grid2d(7, 5, device="cpu"))
    assert same_graph(rmat(scale=7), tg.rmat(scale=7, device="cpu"))
    rng = np.random.default_rng(2)
    u, v = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    w = rng.integers(1, 9, 200).astype(np.float32)
    nw = rng.integers(1, 4, 40).astype(np.float32)
    ref = rc.from_coo(40, u, v, w, nw=nw)
    got = tc.from_coo(40, u, v, w, nw=nw, device="cpu")
    assert same_graph(ref, got)
    assert same_graph(rc.pad_graph(ref, 48, ref.m + 9),
                      tc.pad_graph(got, 48, got.m + 9))
    max_deg = int(np.asarray(ref.degrees).max())
    for a, b in zip(rc.to_padded_fast(ref, max_deg),
                    tc.to_padded_fast(got, max_deg)):
        assert np.array_equal(np.asarray(a), b.numpy())

    k, eps = 5, 0.03
    labels = rng.integers(0, k, 40).astype(np.int32)
    lab_j, lab_t = jnp.asarray(labels), torch.from_numpy(labels)
    lmax = rc.l_max(ref, k, eps)
    pairs = [
        (lmax, tc.l_max(got, k, eps)),
        (rc.block_weights(ref, lab_j, k), tc.block_weights(got, lab_t, k)),
        (rc.edge_cut(ref, lab_j), tc.edge_cut(got, lab_t)),
        (rc.imbalance(ref, lab_j, k), tc.imbalance(got, lab_t, k)),
        (rc.total_overload(ref, lab_j, k, lmax),
         tc.total_overload(got, lab_t, k, tc.l_max(got, k, eps))),
        (rc.conn_dense(ref, lab_j, k), tc.conn_dense(got, lab_t, k)),
    ]
    pairs += list(zip(rc.best_moves(ref, lab_j, k),
                      tc.best_moves(got, lab_t, k)))
    for a, b in pairs:
        assert np.array_equal(np.asarray(a), b.numpy())


def test_coarsen_hierarchy_matches_reference():
    for g, cu in ((grid2d(32, 32), None), (rmat(scale=9), 256)):
        levels, coarsest = jax_hierarchy(g, 4, jax.random.PRNGKey(5),
                                         coarsen_until=cu)
        t_levels, t_coarsest = coarsen_hierarchy(
            port_graph(g), 4, R.PRNGKey(5), coarsen_until=cu)
        assert len(levels) == len(t_levels) >= 2
        for (fine, mapping), (t_fine, t_mapping) in zip(levels, t_levels):
            assert same_graph(fine, t_fine)
            assert np.array_equal(np.asarray(mapping), t_mapping.numpy())
        assert same_graph(coarsest, t_coarsest)


def test_greedy_seed_matches_reference():
    from repro.core.initial import greedy_seed_arith as jax_seed
    from repro_torch.core.initial import greedy_seed_arith

    rng = np.random.default_rng(4)
    for n, k, high in ((300, 4, 1), (64, 13, 9)):
        nw = rng.integers(1, high + 1, n).astype(np.float32)
        for seed in (0, 1):
            want = jax_seed(jnp.asarray(nw), k, jax.random.PRNGKey(seed))
            got = greedy_seed_arith(torch.from_numpy(nw), k, R.PRNGKey(seed))
            assert np.array_equal(np.asarray(want), got.numpy()), (n, k, seed)
