"""Gain backends of the refinement engine (port of ``repro/refine/gain.py``).

A gain backend answers one question per round, for every vertex v:

    own(v)    = conn(v, V_own)
    gain(v)   = max_{j eligible} conn(v, V_j) − own(v)
    target(v) = argmax_{j eligible} conn(v, V_j)

with eligibility j ≠ own(v) ∧ capacity[j] ≥ c(v) (``capacity=None`` means
unconstrained Jet move generation).  Two implementations:

  * :class:`SegmentGain` — one (n·k,) ``index_add_`` per round, then the
    dense move-selection rule (counterpart of ``JnpGain``);
  * :class:`KernelGain`  — the hand-written gain-scoreboard kernel
    (``kernels/gain``) over a per-level padded adjacency (counterpart of
    ``PallasGain``).

Both give bit-identical results on integer-weight graphs (float32 sums of
integers below 2**24 are exact; tie-breaks are index order in both).
"""

from __future__ import annotations

import torch

from repro_torch.ops import segment_sum
from repro_torch.kernels.gain.kernel import KERNEL_MAX_K, gain_scoreboard

GAIN_BACKENDS = ("segment", "kernel", "auto")


def resolve_gain(kind: str, k: int) -> str:
    """The port's fallback rule: the kernel serves k <= KERNEL_MAX_K (its
    shared-memory envelope, see ``kernels/gain/kernel.py``) at any degree;
    larger k streams through ``index_add_``.  ``"auto"`` means "kernel if
    it fits"."""
    if kind == "auto":
        kind = "kernel"
    if kind not in ("segment", "kernel"):
        raise ValueError(
            f"gain backend must be 'segment', 'kernel' or 'auto', got {kind!r}")
    if kind == "kernel" and k > KERNEL_MAX_K:
        return "segment"
    return kind


def masked_best(conn, labels, nw, capacity, k: int):
    """(own, gain, target) from a dense (n, k) connectivity matrix — the
    shared move-selection rule (index-order argmax tie-break; gain = −inf
    and target = own block when no block is eligible)."""
    lab = labels.long()
    own = conn.gather(1, lab.unsqueeze(1))[:, 0]
    blk = torch.arange(k, device=conn.device)
    eligible = blk.unsqueeze(0) != lab.unsqueeze(1)
    if capacity is not None:
        eligible &= capacity.unsqueeze(0) >= nw.unsqueeze(1)
    masked = torch.where(eligible, conn, -torch.inf)
    tgt = masked.argmax(dim=1).to(labels.dtype)
    best = masked.amax(dim=1)
    fin = torch.isfinite(best)
    gain = torch.where(fin, best - own, -torch.inf)
    return own, gain, torch.where(fin, tgt, labels)


class SegmentGain:
    """``index_add_`` gain backend — works at any degree and k."""

    def __init__(self, k: int):
        self.k = k

    def best(self, ev, lv_e, labels, capacity):
        w = torch.where(ev.live, ev.ew, 0.0)
        key = ev.src * self.k + torch.where(ev.live, lv_e.long(), 0)
        conn = segment_sum(w, key, ev.n_local * self.k).reshape(
            ev.n_local, self.k)
        return masked_best(conn, labels, ev.nw, capacity, self.k)


class KernelGain:
    """Gain-scoreboard kernel backend.

    Construction (once per level) builds the padded adjacency in edge-slot
    coordinates: ``eslot[v, r]`` is the edge index of v's r-th neighbour
    (m on unused slots).  Each round gathers the heads' labels through
    ``eslot``, so one adjacency serves every round.
    """

    def __init__(self, ev, k: int, max_deg: int):
        self.k = k
        n, m = ev.n_local, ev.src.shape[0]
        d = max(int(max_deg), 1)
        dev = ev.nw.device
        # rank of each live edge within its row (one stable sort recovers
        # CSR order even when rows are not contiguous in the slot array)
        skey = torch.where(ev.live, ev.src, n)
        order = torch.argsort(skey, stable=True)
        sk = skey[order]
        starts = torch.searchsorted(sk, torch.arange(n, device=dev))
        rank_sorted = (torch.arange(m, device=dev)
                       - starts[sk.clamp(0, max(n - 1, 0))])
        rank = torch.empty(m, dtype=torch.int64, device=dev)
        rank[order] = rank_sorted
        ok = ev.live & (rank < d)
        self.eslot = torch.full((n, d), m, dtype=torch.int64, device=dev)
        self.nbr_w = torch.zeros((n, d), dtype=torch.float32, device=dev)
        rows, cols = ev.src[ok], rank[ok]
        self.eslot[rows, cols] = torch.arange(m, device=dev)[ok]
        self.nbr_w[rows, cols] = ev.ew[ok]

    def inputs(self, ev, lv_e, labels, capacity):
        """The kernel's five input tensors for one round: the heads' labels
        gathered through ``eslot`` (PAD on unused slots), the neighbour
        weights, the row labels and weights, and the capacities."""
        from repro_torch.core.graph import PAD

        dev = ev.nw.device
        cap = (torch.full((self.k,), torch.inf, device=dev)
               if capacity is None else capacity.contiguous())
        lv_ext = torch.cat([
            torch.where(ev.live, lv_e, PAD).to(torch.int32),
            torch.full((1,), PAD, dtype=torch.int32, device=dev)])
        return (lv_ext[self.eslot], self.nbr_w,
                labels.to(torch.int32).contiguous(), ev.nw.contiguous(), cap)

    def best(self, ev, lv_e, labels, capacity):
        own, gain, tgt = gain_scoreboard(
            *self.inputs(ev, lv_e, labels, capacity))
        return own, gain, tgt.to(labels.dtype)


def make_gain(kind: str, ev, k: int, max_deg: int | None = None):
    """The gain backend for one level, after the fallback rule.
    ``max_deg`` (the level's true maximum degree) sizes the kernel's padded
    adjacency."""
    kind = resolve_gain(kind, k)
    if kind == "kernel":
        return KernelGain(ev, k, max_deg or 1)
    return SegmentGain(k)
