"""The golden labels that chip_smoke.py holds the card against
(``src/repro_torch/testdata/golden_small.npz``) are the reference's
partitions of grid2d(32, 32) and rmat(scale=9) at k=8 (default
configuration, seed 0): the first test regenerates them with the JAX
package, so the committed file cannot drift.  The same reference runs are
the k=8 cells of the partition grid (see ``test_torch_slice_grid.py``): the
port, on both gain backends, must reproduce them bit-for-bit.
``python tests/test_torch_golden.py`` rewrites the file."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import (  # noqa: E402,F401
    fresh_jax_caches,
    partition_mismatches,
    reference_partitions,
)

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "testdata" / "golden_small.npz")
K = 8
CASES = {"grid2d_32x32_k8": ("grid2d", dict(nx=32, ny=32)),
         "rmat_9_k8": ("rmat", dict(scale=9))}
DEFAULT = ("d4xjet", "constant")  # the default configuration


def reference_golden() -> dict:
    import repro.graphs

    out = {}
    for name, (gen, kw) in CASES.items():
        g = getattr(repro.graphs, gen)(**kw)
        out[name] = (g, reference_partitions(g, K, [DEFAULT])[DEFAULT])
    return out


@pytest.fixture(scope="module")
def golden():
    return reference_golden()


def test_golden_file_matches_reference(golden):
    with np.load(GOLDEN) as f:
        stored = {name: f[name] for name in f.files}
    assert sorted(stored) == sorted(golden)
    for name, (_, ref) in golden.items():
        assert stored[name].dtype == np.int32
        assert np.array_equal(stored[name], np.asarray(ref.labels)), name


@pytest.mark.parametrize("gain", ["segment", "kernel"])
def test_partition_matches_reference(golden, gain):
    assert {name: partition_mismatches(g, K, {DEFAULT: ref}, gain)
            for name, (g, ref) in golden.items()} == {n: [] for n in golden}


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **{name: np.asarray(ref.labels)
                        for name, (_, ref) in reference_golden().items()})
    print(f"wrote {GOLDEN}")
