"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``; they skip
without one).  This file imports neither jax nor the reference package, so
it also runs where only the port is installed:

    python -m pytest -m gpu tests/test_torch_card.py
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_small.npz")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def scoreboard_inputs(n, d, k, seed, device):
    """Integer-weight scoreboard inputs with PAD slots and +inf / -inf /
    finite capacities."""
    from repro_torch.core.graph import PAD

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
    return [torch.from_numpy(a).to(device)
            for a in (nbr, nbr_w, labels, nw, cap)]


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    from repro_torch.kernels.gain import kernel as K

    dev = _card()
    for n, d, k, seed in [(1000, 4, 64, 0), (777, 40, 1000, 1),
                          (4096, 9, 2, 2), (3, 1, K.KERNEL_MAX_K, 3)]:
        arrays = scoreboard_inputs(n, d, k, seed, dev)
        before = K.LAUNCHES
        got = K.gain_scoreboard(*arrays)
        torch.cuda.synchronize()
        assert K.LAUNCHES == before + 1
        want = K.gain_scoreboard_plain(*arrays)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (n, d, k)
    with pytest.raises(ValueError):
        K.gain_scoreboard(*scoreboard_inputs(8, 2, K.KERNEL_MAX_K + 1, 4, dev))


@pytest.mark.gpu
def test_seed_kernel_matches_plain_on_card():
    from repro_torch.kernels.seed import kernel as S

    dev = _card()
    rng = np.random.default_rng(6)
    for n, k, weights in [(5000, 64, "unit"), (3000, 7, "int"),
                          (777, 1000, "float"), (40, S.KERNEL_MAX_K, "int")]:
        nw = {"unit": np.ones(n), "int": rng.integers(1, 50, n),
              "float": rng.random(n) * 10}[weights].astype(np.float32)
        order = torch.from_numpy(np.argsort(-nw, kind="stable")).to(dev)
        nw_sorted = torch.from_numpy(nw).to(dev)[order]
        before = S.LAUNCHES
        got = S.greedy_seed(order, nw_sorted, k)
        torch.cuda.synchronize()
        assert S.LAUNCHES == before + 1
        assert torch.equal(got, S.greedy_seed_plain(order, nw_sorted, k)), (
            n, k, weights)


@pytest.mark.gpu
def test_partition_on_card_matches_golden_labels():
    import repro_torch.graphs as tg
    from repro_torch.core import partition

    dev = _card()
    with np.load(GOLDEN) as golden:
        g = tg.grid2d(32, 32, device=dev)
        got = partition(g, 8, seed=0, gain="kernel", device=dev)
        assert np.array_equal(got.labels.cpu().numpy(), golden["grid2d_32x32_k8"])
