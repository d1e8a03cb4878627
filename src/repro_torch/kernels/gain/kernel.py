"""Wrapper of the Hopper gain-scoreboard kernel (``csrc/gain_scoreboard.cu``).

:func:`gain_scoreboard` launches the CUDA kernel for CUDA tensors and uses
the plain version (``ref.py``) for CPU tensors — by device, never as a
fallback: a CUDA call either launches the kernel or raises.  The kernel is
built at first use (``repro_torch.kernels.build``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.gain.ref import gain_scoreboard_plain

LAUNCHES = 0  # kernel launches (CUDA path only); chip_smoke.py reads it

SOURCE = Path(__file__).resolve().parent / "csrc" / "gain_scoreboard.cu"

# Envelope: one K-wide fp32 scoreboard row per warp must fit the 48 KB of
# shared memory a block gets without opting in, so K <= 12288; the degree
# is unbounded (the lane loop walks any row length).
SMEM_BYTES = 48 * 1024
KERNEL_MAX_K = SMEM_BYTES // 4
MAX_ROWS_PER_BLOCK = 8

_lib = None
_lock = threading.Lock()


def rows_per_block(k: int) -> int:
    """Rows (warps) per block: up to 8, as many as the scoreboards allow."""
    return max(1, min(MAX_ROWS_PER_BLOCK, SMEM_BYTES // (4 * max(k, 1))))


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, "gain_scoreboard_launch",
                               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
    return _lib


def _check(nbr_lab, nbr_w, labels, nw, cap):
    if nbr_lab.dim() != 2:
        raise ValueError(f"nbr_lab must be (N, D), got {tuple(nbr_lab.shape)}")
    n, d = nbr_lab.shape
    k = cap.shape[0] if cap.dim() == 1 else -1
    want = ((nbr_lab, torch.int32, (n, d)), (nbr_w, torch.float32, (n, d)),
            (labels, torch.int32, (n,)), (nw, torch.float32, (n,)),
            (cap, torch.float32, (k,)))
    for name, (t, dtype, shape) in zip(
            ("nbr_lab", "nbr_w", "labels", "nw", "cap"), want):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"gain_scoreboard: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != nbr_lab.device:
            raise ValueError(f"gain_scoreboard: {name} is on {t.device}, "
                             f"nbr_lab on {nbr_lab.device}")
        if not t.is_contiguous():
            raise ValueError(f"gain_scoreboard: {name} must be contiguous")
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"gain_scoreboard: K={k} outside [1, {KERNEL_MAX_K}]")
    if n >= 2**31:
        raise ValueError(f"gain_scoreboard: N={n} rows exceed int32")


def gain_scoreboard(nbr_lab, nbr_w, labels, nw, cap):
    """Per-row (own, gain, target) of the padded adjacency.

    ``nbr_lab`` (N, D) int32 neighbour labels (PAD on unused slots),
    ``nbr_w`` (N, D) float32, ``labels`` (N,) int32, ``nw`` (N,) float32,
    ``cap`` (K,) float32.  Returns float32 (N,), float32 (N,), int32 (N,).
    """
    global LAUNCHES
    _check(nbr_lab, nbr_w, labels, nw, cap)
    dev = nbr_lab.device
    if dev.type == "cpu":
        return gain_scoreboard_plain(nbr_lab, nbr_w, labels, nw, cap)
    if dev.type != "cuda":
        raise ValueError(f"gain_scoreboard: unsupported device {dev}")
    n, d = nbr_lab.shape
    k = cap.shape[0]
    lib = _library()
    own = torch.empty(n, dtype=torch.float32, device=dev)
    gain = torch.empty(n, dtype=torch.float32, device=dev)
    tgt = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gain_scoreboard_launch(
            nbr_lab.data_ptr(), nbr_w.data_ptr(), labels.data_ptr(),
            nw.data_ptr(), cap.data_ptr(), own.data_ptr(), gain.data_ptr(),
            tgt.data_ptr(), n, d, k, rows_per_block(k), stream)
    if err != 0:
        raise RuntimeError(f"gain_scoreboard: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return own, gain, tgt
