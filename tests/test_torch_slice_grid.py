"""The PyTorch port's partition() against the reference on grid2d(32, 32)
(three levels) at k=4: jet under the constant, geometric and snap
tolerance schedules.  Both gain backends, bit-for-bit (labels, cut,
imbalance, levels, level_eps, level_trace).

The partition grid — two graphs × k ∈ {4, 8}, every registered variant
once, the schedules on jet — is spread over three files, one JAX reference
run per cell, because each reference (variant, level, k) costs an XLA
compile of seconds:

  grid2d(32, 32), k=4: jet × {constant, geometric, snap} (here; the
      schedules differ only across levels, so they go on the multi-level
      graph);
  grid2d(32, 32), k=8: jet (test_torch_golden.py);
  rmat(9), k=4: jet, jet_h, jet_v (test_torch_slice_rmat.py);
  rmat(9), k=8: jet (test_torch_golden.py), jetlp, lp
      (test_torch_slice_rmat_k8.py).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.graphs import grid2d  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    fresh_jax_caches,
    partition_mismatches,
    reference_partitions,
)

K = 4
CONFIGS = [("jet", "constant"), ("jet", "geometric"), ("jet", "snap")]


@pytest.fixture(scope="module")
def case():
    g = grid2d(32, 32)
    return g, reference_partitions(g, K, CONFIGS)


@pytest.mark.parametrize("gain", ["segment", "kernel"])
def test_partition_matches_reference(case, gain):
    g, refs = case
    assert partition_mismatches(g, K, refs, gain) == []
