"""The PyTorch port's gain scoreboard: the plain version against the
reference oracle and the interpret-mode Pallas kernel, and the port's gain
backends against the reference's.  All comparisons are exact: the inputs
have integer weights, whose float32 sums are exact in any order.  The CUDA
kernel itself is compared with the plain version on the card by
``test_torch_card.py`` and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.core.graph import PAD  # noqa: E402
from repro.graphs import rmat  # noqa: E402
from repro.kernels.gain.kernel import gain_scoreboard_pallas  # noqa: E402
from repro.kernels.gain.ref import gain_scoreboard_ref  # noqa: E402
from repro.refine.comm import edge_view_from_graph as jax_edge_view  # noqa: E402
from repro.refine.gain import JnpGain, PallasGain  # noqa: E402
from repro_torch.kernels.gain import kernel as K  # noqa: E402
from repro_torch.refine.comm import edge_view_from_graph  # noqa: E402
from repro_torch.refine.drivers import graph_max_deg  # noqa: E402
from repro_torch.refine.gain import KernelGain, SegmentGain  # noqa: E402
from torch_parity import fresh_jax_caches, port_graph  # noqa: E402,F401


def scoreboard_inputs(n, d, k, seed):
    """Integer-weight scoreboard inputs with PAD slots, ties, +inf / -inf /
    finite capacities and rows with no eligible block."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, k, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = PAD
    nbr_w = rng.integers(1, 4, (n, d)).astype(np.float32)
    nbr_w[nbr == PAD] = 0.0
    labels = rng.integers(0, k, n).astype(np.int32)
    nw = rng.integers(1, 5, n).astype(np.float32)
    cap = rng.integers(0, 6, k).astype(np.float32)
    cap[rng.random(k) < 0.2] = np.inf
    cap[rng.random(k) < 0.2] = -np.inf
    return nbr, nbr_w, labels, nw, cap


def _plain(nbr, nbr_w, labels, nw, cap):
    return [t.numpy() for t in K.gain_scoreboard(
        *(torch.from_numpy(a) for a in (nbr, nbr_w, labels, nw, cap)))]


def _same(a, b):
    return all(np.array_equal(np.asarray(x).reshape(-1), np.asarray(y).reshape(-1))
               for x, y in zip(a, b))


def test_plain_scoreboard_matches_reference_and_pallas():
    cases = [(256, 16, 5, 0), (256, 32, 131, 2), (256, 16, 2, 3)]
    no_eligible = 0
    for n, d, k, seed in cases:
        nbr, nbr_w, labels, nw, cap = scoreboard_inputs(n, d, k, seed)
        got = _plain(nbr, nbr_w, labels, nw, cap)
        assert _same(got, gain_scoreboard_ref(nbr, nbr_w, labels, nw, cap))
        # the Pallas kernel wants K in lanes of 128: pad with -inf capacity
        k_pad = -(-k // 128) * 128
        cap_p = np.full(k_pad, -np.inf, np.float32)
        cap_p[:k] = cap
        pallas = gain_scoreboard_pallas(
            jnp.asarray(nbr), jnp.asarray(nbr_w), jnp.asarray(labels),
            jnp.asarray(nw), jnp.asarray(cap_p), tile_n=256, deg_chunk=16,
            interpret=True)
        assert _same(got, pallas)
        none = np.isneginf(got[1])
        assert np.array_equal(got[2][none], labels[none])
        no_eligible += int(none.sum())
    assert no_eligible > 0  # the cases do contain rows with no eligible block
    # every row ineligible: -inf capacity everywhere
    nbr, nbr_w, labels, nw, cap = scoreboard_inputs(256, 16, 7, 4)
    cap[:] = -np.inf
    got = _plain(nbr, nbr_w, labels, nw, cap)
    assert np.isneginf(got[1]).all() and np.array_equal(got[2], labels)


def test_gain_backends_match_reference():
    g = rmat(scale=8)
    ev_j = jax_edge_view(g)
    pg = port_graph(g)
    ev = edge_view_from_graph(pg)
    rng = np.random.default_rng(5)
    for k in (4, 13):
        labels = rng.integers(0, k, g.n).astype(np.int32)
        bw = np.bincount(labels, minlength=k).astype(np.float32)
        caps = [None, (np.float32(g.n / k * 1.03) - bw).astype(np.float32)]
        caps[1][caps[1] < 0] = -np.inf
        lab_t = torch.from_numpy(labels).long()
        lv_t = lab_t[torch.where(ev.live, ev.head, 0)]
        lv_j = jnp.asarray(labels)[jnp.where(ev_j.live, ev_j.head, 0)]
        backends = [
            (JnpGain(k), SegmentGain(k)),
            (PallasGain(ev_j, k, graph_max_deg(pg), interpret=True),
             KernelGain(ev, k, graph_max_deg(pg))),
        ]
        for cap in caps:
            cap_j = None if cap is None else jnp.asarray(cap)
            cap_t = None if cap is None else torch.from_numpy(cap)
            for ref_b, port_b in backends:
                want = ref_b.best(ev_j, lv_j, jnp.asarray(labels), cap_j)
                got = [t.numpy() for t in port_b.best(ev, lv_t, lab_t, cap_t)]
                assert _same(got, want), (k, cap is None, type(port_b).__name__)
