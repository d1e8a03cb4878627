"""Threefry-2x32 keys and uniforms, bit-for-bit with ``jax.random``.

The reference partitioner's determinism contract rests on ``jax.random``
(threefry-2x32, partitionable mode): every cluster round, rebalance pass and
tie-break noise is a pure function of one key chain.  The port reproduces
that chain exactly, so it cannot use ``torch.Generator``.

Keys are tiny host values — numpy ``uint32[2]`` arrays — because the key
chain never depends on device data: ``split`` and ``fold_in`` run on the
host with no device launch.  Only the vectorised draws (``uniform`` over a
shape, :func:`fold_uniform` over an id vector) run on the device, in int64
arithmetic masked to 32 bits (torch has no full uint32 arithmetic).

The mapping, as in jax with ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)      = [0, seed]``;
* ``split(key, n)[i]   = threefry(key, (0, i))``;
* ``fold_in(key, d)    = threefry(key, (0, d))``;
* ``uniform(key, (n,))[i]`` takes the bits ``x0 ^ x1`` of
  ``threefry(key, (0, i))``, then ``(bits >> 9) | 0x3F800000`` read as
  float32, minus 1.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds.  Works on Python/numpy int64 values and on
    int64 tensors alike (all values in [0, 2**32))."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32."""
    if not 0 <= int(seed) <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.array([0, int(seed)], dtype=np.uint32)


def key_from_numpy(key) -> np.ndarray:
    """Adopt a key made elsewhere (e.g. ``np.asarray(jax_key)``)."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"a key is uint32[2], got {key.dtype}{list(key.shape)}")
    return key.copy()


def _tf_host(key, hi: int, lo: int) -> np.ndarray:
    k0, k1 = int(key[0]), int(key[1])
    y0, y1 = _threefry2x32(k0, k1, hi, lo)
    return np.array([y0, y1], dtype=np.uint32)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of ``num`` keys."""
    return [_tf_host(key, 0, i) for i in range(num)]


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for 0 <= data < 2**32."""
    return _tf_host(key, 0, int(data) & _MASK)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 random bits as the mantissa of a float in [1, 2), minus 1 —
    jax's float32 ``uniform`` recipe."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape=(), device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(ctr), ctr)
    return _bits_to_unit(y0 ^ y1).reshape(shape)


def fold_uniform(key, ids: torch.Tensor) -> torch.Tensor:
    """``vmap(lambda v: uniform(fold_in(key, v)))(ids)`` — one float32 per
    id, a pure function of ``(key, id)``."""
    ids = ids.to(torch.int64) & _MASK
    zero = torch.zeros_like(ids)
    k0, k1 = _threefry2x32(int(key[0]), int(key[1]), zero, ids)
    y0, y1 = _threefry2x32(k0, k1, zero, zero)
    return _bits_to_unit(y0 ^ y1)
