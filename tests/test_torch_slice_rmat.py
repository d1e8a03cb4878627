"""The PyTorch port's partition() against the reference on rmat(scale=9)
(one level) at k=4: jet, jet_h and jet_v.  Both gain backends, bit-for-bit
(labels, cut, imbalance, levels, level_eps, level_trace).  See
``test_torch_slice_grid.py`` for how the files split the grid."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.graphs import rmat  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    fresh_jax_caches,
    partition_mismatches,
    reference_partitions,
)

K = 4
CONFIGS = [("jet", "constant"), ("jet_h", "constant"), ("jet_v", "constant")]


@pytest.fixture(scope="module")
def case():
    g = rmat(scale=9)
    return g, reference_partitions(g, K, CONFIGS)


@pytest.mark.parametrize("gain", ["segment", "kernel"])
def test_partition_matches_reference(case, gain):
    g, refs = case
    assert partition_mismatches(g, K, refs, gain) == []
