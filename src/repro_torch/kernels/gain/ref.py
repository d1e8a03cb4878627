"""Plain PyTorch version of the gain scoreboard (the kernel's oracle).

Same contract as ``csrc/gain_scoreboard.cu`` and as the reference's
``repro/kernels/gain/kernel.py::_gain_kernel``: for each row v,

    conn[v, j] = Σ_r nbr_w[v, r] · [nbr_lab[v, r] == j]      (j < K)
    own        = conn[v, labels[v]]   (0 when labels[v] is not a block)
    best       = max over eligible j of conn[v, j],
                 eligible ⇔ j ≠ labels[v] ∧ cap[j] ≥ nw[v]
    target     = the first (lowest) j achieving ``best``
    gain       = best − own;  −inf and target = labels[v] when no j is
                 eligible.

Neighbour slots whose label is not in [0, K) (PAD) add nothing.
"""

from __future__ import annotations

import torch


def gain_scoreboard_plain(nbr_lab, nbr_w, labels, nw, cap):
    """Returns (own, gain, target), each of shape (N,)."""
    n, d = nbr_lab.shape
    k = cap.shape[0]
    dev = nbr_lab.device
    flat = nbr_lab.reshape(-1)
    pos = ((flat >= 0) & (flat < k)).nonzero().squeeze(1)  # block slots
    key = torch.div(pos, d, rounding_mode="floor") * k + flat[pos].long()
    conn = torch.zeros(n * k, dtype=torch.float32, device=dev)
    conn = conn.index_add_(0, key, nbr_w.reshape(-1)[pos]).reshape(n, k)

    lab_v = labels.long()
    in_range = (lab_v >= 0) & (lab_v < k)
    own = torch.where(
        in_range,
        conn.gather(1, torch.where(in_range, lab_v, 0).unsqueeze(1))[:, 0],
        0.0)
    blk = torch.arange(k, device=dev)
    eligible = (blk.unsqueeze(0) != lab_v.unsqueeze(1)) & (
        cap.unsqueeze(0) >= nw.unsqueeze(1))
    masked = torch.where(eligible, conn, -torch.inf)
    best = masked.amax(dim=1)
    tgt = masked.argmax(dim=1)  # first index of the maximum
    found = eligible.any(dim=1)
    gain = torch.where(found, best - own, -torch.inf)
    tgt = torch.where(found, tgt, lab_v).to(torch.int32)
    return own, gain, tgt
