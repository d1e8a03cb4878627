"""The PyTorch port's threefry keys and uniforms equal ``jax.random``
bit-for-bit (partitionable threefry, the reference's default)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from repro.refine.comm import tid_uniform as jax_tid_uniform  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.refine.comm import tid_uniform  # noqa: E402
from torch_parity import fresh_jax_caches  # noqa: E402,F401

SEEDS = (0, 7, 123456, 2**32 - 1)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def test_keys_and_uniforms_match_jax():
    for seed in SEEDS:
        key, tkey = jax.random.PRNGKey(seed), R.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), tkey)
        assert np.array_equal(np.asarray(jax.random.split(key, 5)),
                              np.stack(R.split(tkey, 5)))
        for d in (0, 1, 12345, 2**31 + 5):
            assert np.array_equal(np.asarray(jax.random.fold_in(key, d)),
                                  R.fold_in(tkey, d))
        for shape in ((), (1,), (1000,), (3, 17)):
            assert np.array_equal(_bits(jax.random.uniform(key, shape)),
                                  _bits(R.uniform(tkey, shape).numpy()))
        # a chain of splits, as the V-cycle walks it
        for _ in range(4):
            key, sub = jax.random.split(key)
            tkey, tsub = R.split(tkey)
        assert np.array_equal(np.asarray(sub), tsub)
    # a key handed over from the reference keeps its stream
    key = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    tkey = R.key_from_numpy(np.asarray(key))
    assert np.array_equal(_bits(jax.random.uniform(key, (64,))),
                          _bits(R.uniform(tkey, (64,)).numpy()))


def test_tid_uniform_matches_reference():
    ids = np.random.default_rng(0).integers(0, 2**31 - 1, 2000).astype(np.int32)
    for seed in SEEDS[:3]:
        key = jax.random.PRNGKey(seed)
        for maxval in (1.0, 1e-3):
            want = jax_tid_uniform(key, ids, maxval=maxval)
            got = tid_uniform(R.PRNGKey(seed), torch.from_numpy(ids),
                              maxval=maxval)
            assert np.array_equal(_bits(want), _bits(got.numpy()))
