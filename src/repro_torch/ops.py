"""Tensor helpers shared by ``core`` and ``refine`` (no module counterpart
in ``repro``: they stand in for ``jax.ops`` and for jax's rounding of
Python constants)."""

from __future__ import annotations

import torch


def f32(x: float, device) -> torch.Tensor:
    """A Python float rounded once to a float32 scalar tensor — how the
    reference's weakly typed Python constants meet its float32 arrays."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` (ids in range)."""
    out = torch.zeros(num, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids.long(), data)
