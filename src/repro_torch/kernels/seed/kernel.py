"""Wrapper of the Hopper greedy-seeding kernel (``csrc/greedy_seed.cu``).

:func:`greedy_seed` launches the CUDA kernel for CUDA tensors and uses the
plain version (``ref.py``) for CPU tensors — by device, never as a
fallback.  The kernel is built at first use (``repro_torch.kernels.build``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.seed.ref import greedy_seed_plain

LAUNCHES = 0  # kernel launches (CUDA path only); chip_smoke.py reads it

SOURCE = Path(__file__).resolve().parent / "csrc" / "greedy_seed.cu"
KERNEL_MAX_K = 48 * 1024 // 4  # block weights in 48 KB of shared memory

_lib = None
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, "greedy_seed_launch",
                               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                               + [ctypes.c_void_p])
    return _lib


def greedy_seed(order, nw_sorted, k: int):
    """Labels (n,) int64 of greedy balanced seeding: ``order`` (n,) int64 is
    the seeding order (a permutation of the vertices), ``nw_sorted`` (n,)
    float32 the vertex weights in that order."""
    global LAUNCHES
    n = order.shape[0]
    if order.dtype != torch.int64 or order.shape != (n,):
        raise ValueError(f"greedy_seed: order must be int64 (n,), got "
                         f"{order.dtype} {tuple(order.shape)}")
    if nw_sorted.dtype != torch.float32 or nw_sorted.shape != (n,):
        raise ValueError(f"greedy_seed: nw_sorted must be float32 ({n},), got "
                         f"{nw_sorted.dtype} {tuple(nw_sorted.shape)}")
    if nw_sorted.device != order.device:
        raise ValueError("greedy_seed: order and nw_sorted on different devices")
    dev = order.device
    if dev.type == "cpu":
        return greedy_seed_plain(order, nw_sorted, k)
    if dev.type != "cuda":
        raise ValueError(f"greedy_seed: unsupported device {dev}")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"greedy_seed: k={k} outside [1, {KERNEL_MAX_K}]")
    if n >= 2**31:
        raise ValueError(f"greedy_seed: n={n} exceeds int32")
    order, nw_sorted = order.contiguous(), nw_sorted.contiguous()
    labels = torch.empty(n, dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.greedy_seed_launch(
            order.data_ptr(), nw_sorted.data_ptr(), labels.data_ptr(), n, k,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_seed: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return labels
