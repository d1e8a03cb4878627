"""The PyTorch port's partition() against the reference on rmat(scale=9)
(one level) at k=8: jetlp and lp (jet at k=8 is in test_torch_golden.py).
Both gain backends, bit-for-bit (labels, cut, imbalance, levels, level_eps,
level_trace).  See ``test_torch_slice_grid.py`` for how the files split the
grid; the last assertion checks that together they cover every registered
variant."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.graphs import rmat  # noqa: E402
from repro.refine import registered_variants  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    fresh_jax_caches,
    partition_mismatches,
    reference_partitions,
)

K = 8
CONFIGS = [("jetlp", "constant"), ("lp", "constant")]


@pytest.fixture(scope="module")
def case():
    g = rmat(scale=9)
    return g, reference_partitions(g, K, CONFIGS)


@pytest.mark.parametrize("gain", ["segment", "kernel"])
def test_partition_matches_reference(case, gain):
    g, refs = case
    assert partition_mismatches(g, K, refs, gain) == []
    covered = {"jet", "jet_h", "jet_v"} | {v for v, _ in CONFIGS}
    assert covered == set(registered_variants())
