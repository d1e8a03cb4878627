"""The Jet refinement engine (port of ``repro/refine/engine.py``), written
over a comm backend (``comm.py``) and a gain backend (``gain.py``).

  * :func:`jet_move`          — candidate set M + afterburner + apply/lock;
  * :func:`afterburner_delta` — the assumed-state cut delta every variant's
    move filter is built from (``variants.py``);
  * :func:`prob_pass`         — Alg. 1 probabilistic bucket rebalancing;
  * :func:`greedy_epoch`      — the greedy rebalancer (top-ncand candidates,
    replayed in order with live weight accounting);
  * :func:`rebalance_loop`    — greedy epochs with the <10 % progress
    escalation to the probabilistic pass;
  * :func:`jet_inner`         — (Jet → rebalance) until ``patience``
    non-improvements of the best balanced cut;
  * :func:`refine_level`      — all temperature rounds of one level;
  * :func:`lp_round` / :func:`lp_level` — the dLP baseline.

The reference fuses a level into one XLA program of ``while_loop``s with
data-dependent exits.  Here those loops are host loops: each exit test,
each greedy replay and each best-cut comparison reads a few scalars from
the device.  Every such read goes through :func:`_host`, which counts it in
``HOST_SYNCS``.

Keys are host values (``repro_torch.random``) and follow the reference's
split chain exactly.  Scalars the reference compares in float32 (overloads,
cuts) are compared here as numpy float32, so the decisions are the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.ops import f32, segment_sum
from repro_torch.refine.comm import EdgeView

NEG = -torch.inf

# ---- paper Alg. 1 rebalance constants -------------------------------------
ALPHA = 1.1          # paper §2: "we use α = 1.1"
N_BUCKETS = 96       # static bucket count; r_v ≈ −1e4 lands in bucket ~97 → clip
GREEDY_NCAND = 128   # "a few vertices per overloaded block in every epoch"

HOST_SYNCS = 0       # device → host reads made by the engine


def _host(t: torch.Tensor) -> np.ndarray:
    """Read a device tensor on the host (one synchronisation)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return t.detach().cpu().numpy()


def _relative_gain(gain, cv):
    """r_v = g_v·c(v) if g_v > 0 else g_v/c(v)  (paper Alg. 1 line 4)."""
    cv = torch.clamp_min(cv, 1e-9)
    return torch.where(gain > 0, gain * cv, gain / cv)


# Step points of the bucket index.  For r < 0 the bucket is a step function
# of x = -r: the reference computes 1 + ceil(log1p(x) / log(ALPHA)) in XLA's
# float32 arithmetic, whose log differs from torch's in the last bit for some
# inputs — enough to move a step by one float near a bucket boundary.  So
# the port keeps the reference's own steps: _BUCKET_STEPS[m - 1] is the
# smallest float32 x whose reference bucket is at least m + 2, as float32
# bit patterns (tests/test_torch_engine.py re-derives the table from the
# reference by bisection).
_BUCKET_STEPS = (
    0x3dccccd1, 0x3e570a42, 0x3ea978d9, 0x3eed9e8b, 0x3f1c4a66, 0x3f45850b,
    0x3f72df26, 0x3f926123, 0x3fadd13f, 0x3fcbffc7, 0x3fed32f6, 0x4008dc07,
    0x401cf208, 0x40330a3d, 0x404b580f, 0x40661413, 0x4081be3e, 0x4091eade,
    0x40a3b58e, 0x40b747b6, 0x40cccee2, 0x40e47d2b, 0x40fe89b2, 0x410d9888,
    0x411d5afd, 0x412eb0e3, 0x4141c294, 0x4156bc70, 0x416dcf48, 0x41839868,
    0x41918e0c, 0x41a0e90e, 0x41b1cd29, 0x41c461ae, 0x41d8d1d9, 0x41ef4d3c,
    0x42040415, 0x42119e17, 0x4220944d, 0x42310988, 0x42432416, 0x42570e17,
    0x426cf5e7, 0x4282873f, 0x428fc7f9, 0x429e5bf9, 0x42ae652b, 0x42c008e3,
    0x42d3702e, 0x42e8c833, 0x43002150, 0x430d0b0b, 0x431b3f59, 0x432adf49,
    0x433c0f37, 0x434ef723, 0x4363c30d, 0x437aa35c, 0x4389e6a6, 0x4397bdb7,
    0x43a6f716, 0x43b7b633, 0x43ca2205, 0x43de656c, 0x43f4af91, 0x44069a2a,
    0x44141662, 0x4422ebd2, 0x44333d01, 0x44452fe8, 0x4458ee4c, 0x446ea621,
    0x448344f9, 0x449068ac, 0x449edcbd, 0x44aec2d1, 0x44c03fe6, 0x44d37cb0,
    0x44e8a5f6, 0x44ffecf6, 0x450cc3ee, 0x451ad91f, 0x452a56d6, 0x453b611c,
    0x454e1f9f, 0x4562bdfc, 0x45796c30, 0x45892f81, 0x4596e841, 0x45a60048,
    0x45b69ab6, 0x45c8de2f, 0x45dcf534,
)


@functools.lru_cache(maxsize=None)
def _bucket_steps(device: torch.device) -> torch.Tensor:
    return torch.tensor(_BUCKET_STEPS, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to(device)


def _bucket_index(r):
    """Exponentially spaced bucket index (paper Alg. 1 line 5):
    0 for r >= 0, else 1 + ceil(log_α(1 − r)), clipped to the last bucket."""
    steps = _bucket_steps(r.device)
    j = 2 + torch.searchsorted(steps, torch.clamp_min(-r, 0.0), right=True)
    j = torch.where(r >= 0, 0, j)
    return torch.clamp(j, 0, N_BUCKETS - 1)


# --------------------------------------------------------------------------
# shared per-round helpers
# --------------------------------------------------------------------------

def _head_labels(cm, ev: EdgeView, labels):
    """Per-edge labels of heads."""
    return cm.lookup(ev, cm.exchange(labels), labels)


def block_weights(cm, ev: EdgeView, labels, k: int):
    return cm.psum(segment_sum(ev.nw, labels, k))


def overload_of(cm, ev: EdgeView, labels, k: int, lmax):
    bw = block_weights(cm, ev, labels, k)
    return torch.clamp_min(bw - lmax, 0.0).sum()


def cut_of(cm, ev: EdgeView, labels):
    lv = _head_labels(cm, ev, labels)
    w = torch.where(ev.live & (labels[ev.src] != lv), ev.ew, 0.0)
    return cm.psum(w.sum()) * 0.5


# --------------------------------------------------------------------------
# Jet round: candidate set + afterburner
# --------------------------------------------------------------------------

def afterburner_delta(cm, ev: EdgeView, labels, lv_e, gain, target, cand,
                      order: str = "gain"):
    """Assumed-state cut delta of every candidate move: u precedes v iff
    (g(u), −u) > (g(v), −v) (``order="gain"``) or u < v
    (``order="vertex"``), and v re-evaluates its move assuming every
    preceding candidate neighbour has moved."""
    tu = cm.lookup(ev, cm.exchange(target), target)
    cu = cm.lookup(ev, cm.exchange(cand), cand)
    tail_tid = ev.my_tid[ev.src]
    if order == "vertex":
        precede = cu & (ev.head_tid < tail_tid)
    elif order == "gain":
        gmask = torch.where(cand, gain, NEG)
        gu = cm.lookup(ev, cm.exchange(gmask), gmask)
        gv = gain[ev.src]
        precede = cu & ((gu > gv) | ((gu == gv) & (ev.head_tid < tail_tid)))
    else:
        raise ValueError(f"afterburner order must be 'gain' or 'vertex', "
                         f"got {order!r}")
    assumed = torch.where(precede, tu, lv_e)

    w = torch.where(ev.live, ev.ew, 0.0)
    tv = target[ev.src]
    lown = labels[ev.src]
    delta_e = w * ((assumed == tv).to(w.dtype) - (assumed == lown).to(w.dtype))
    return segment_sum(delta_e, ev.src, ev.n_local)


def candidate_set(ev: EdgeView, labels, own, gain, target, tau, locked=None):
    """Candidate set M: negative gains admitted up to −⌊τ·conn_own⌋,
    finite-gain real moves of owned slots, minus ``locked``."""
    threshold = -torch.floor(tau * own)
    cand = (gain >= threshold) & (target != labels)
    cand &= torch.isfinite(gain) & ev.owned
    if locked is not None:
        cand &= ~locked
    return cand


def jet_move(cm, gb, ev: EdgeView, labels, locked, tau, k: int):
    """One Jet round; returns (new_labels, moved mask)."""
    lv_e = _head_labels(cm, ev, labels)
    own, gain, target = gb.best(ev, lv_e, labels, None)
    cand = candidate_set(ev, labels, own, gain, target, tau, locked)
    delta = afterburner_delta(cm, ev, labels, lv_e, gain, target, cand)
    move = cand & (delta >= 0.0)
    return torch.where(move, target, labels), move


# --------------------------------------------------------------------------
# Alg. 1 — probabilistic bucket rebalancing
# --------------------------------------------------------------------------

def _capacity(bw, lmax):
    overloaded = bw > lmax
    return overloaded, torch.where(~overloaded, lmax - bw, NEG)


def prob_pass(cm, gb, ev: EdgeView, labels, key, lmax, k: int):
    bw = block_weights(cm, ev, labels, k)
    overloaded, capacity = _capacity(bw, lmax)

    lv_e = _head_labels(cm, ev, labels)
    _, gain, target = gb.best(ev, lv_e, labels, capacity)

    mover = overloaded[labels] & torch.isfinite(gain) & ev.owned & (ev.nw > 0)
    bucket = _bucket_index(_relative_gain(gain, ev.nw))

    # per-(overloaded block, bucket) weights c(B_o^i) — Alg. 1 line 8
    B = cm.psum(segment_sum(
        torch.where(mover, ev.nw, 0.0), labels * N_BUCKETS + bucket,
        k * N_BUCKETS)).reshape(k, N_BUCKETS)

    prefix = torch.cumsum(B, dim=1)
    excess = torch.clamp_min(bw - lmax, 0.0)
    covered = prefix >= excess.unsqueeze(1)
    cutoff = torch.where(covered.any(dim=1),
                         covered.to(torch.int32).argmax(dim=1) + 1, N_BUCKETS)
    cutoff = torch.where(excess > 0, cutoff, 0)

    move_cand = mover & (bucket < cutoff[labels])
    W = cm.psum(segment_sum(torch.where(move_cand, ev.nw, 0.0), target, k))
    room = torch.clamp_min(lmax - bw, 0.0)
    p = torch.where(W > 0,
                    torch.clamp_max(room / torch.clamp_min(W, 1e-9), 1.0), 0.0)

    accept = move_cand & (cm.uniform(key, ev) < p[target])
    return torch.where(accept, target, labels)


# --------------------------------------------------------------------------
# Greedy rebalancer — top-ncand candidates + ordered replay
# --------------------------------------------------------------------------

def greedy_epoch(cm, gb, ev: EdgeView, labels, lmax, k: int,
                 ncand: int = GREEDY_NCAND):
    """One epoch: the ncand best movers by r_v (ties by vertex id) are
    replayed in that order with live block-weight accounting.  The replay
    is ncand scalar steps, so it runs on the host over one packed read of
    the candidate records (float32 arithmetic, as on the device)."""
    bw = block_weights(cm, ev, labels, k)
    overloaded, capacity = _capacity(bw, lmax)

    lv_e = _head_labels(cm, ev, labels)
    _, gain, target = gb.best(ev, lv_e, labels, capacity)

    mover = overloaded[labels] & torch.isfinite(gain) & ev.owned
    score = torch.where(mover, _relative_gain(gain, ev.nw), NEG)

    # order (score desc, tie-break id asc): a stable sort over slots, which
    # are in tie-break-id order on the single-device path (my_tid = arange);
    # 0 - score keeps every zero +0.0 (a radix sort orders -0.0 first)
    nc = min(ncand, ev.n_local)
    idx = torch.argsort(0.0 - score, stable=True)[:nc]
    rec = _host(torch.cat([
        score[idx].double(), ev.nw[idx].double(), ev.my_tid[idx].double(),
        target[idx].double(), labels[idx].double(), bw.double(),
        lmax.double().reshape(1)]))
    s, w = rec[:nc].astype(np.float32), rec[nc:2 * nc].astype(np.float32)
    tid, tgt, lab = (rec[i * nc:(i + 1) * nc].astype(np.int64)
                     for i in (2, 3, 4))
    bw_h = rec[5 * nc:5 * nc + k].astype(np.float32)
    lmax_h = np.float32(rec[-1])

    moved = np.zeros(nc, dtype=bool)
    for i in np.lexsort((tid, -s)):
        if not np.isfinite(s[i]):
            break  # non-movers (score -inf) sort last and never move
        a, b, wi = lab[i], tgt[i], w[i]
        if bw_h[a] > lmax_h and bw_h[b] + wi <= lmax_h and b != a:
            moved[i] = True
            bw_h[a] -= wi
            bw_h[b] += wi
    if not moved.any():
        return labels
    dev = labels.device
    return cm.apply_moves(ev, labels, torch.from_numpy(tid[moved]).to(dev),
                          torch.from_numpy(tgt[moved]).to(dev))


# --------------------------------------------------------------------------
# Rebalance driver: greedy epochs + <10 % progress escalation (paper §2)
# --------------------------------------------------------------------------

def rebalance_loop(cm, gb, ev: EdgeView, labels, key, lmax, k: int,
                   max_epochs: int = 32, ncand: int = GREEDY_NCAND):
    """Returns (labels, overload, epochs, prob_passes); the overload is a
    numpy float32."""
    ov = np.float32(_host(overload_of(cm, ev, labels, k, lmax)))
    ep = pp = 0
    while ov > 0 and ep < max_epochs:
        labels = greedy_epoch(cm, gb, ev, labels, lmax, k, ncand)
        new_ov = np.float32(_host(overload_of(cm, ev, labels, k, lmax)))
        slow = new_ov > np.float32(0.9) * ov  # <10 % progress → Alg. 1
        key, sub = rnd.split(key)
        if slow:
            labels = prob_pass(cm, gb, ev, labels, sub, lmax, k)
            new_ov = np.float32(_host(overload_of(cm, ev, labels, k, lmax)))
        ov, ep, pp = new_ov, ep + 1, pp + int(slow)
    return labels, ov, ep, pp


# --------------------------------------------------------------------------
# d4xJet integration: inner (Jet → rebalance) loop + temperature rounds
# --------------------------------------------------------------------------

def jet_inner(cm, gb, ev: EdgeView, labels, tau, lmax, key, k: int,
              patience: int, max_inner: int, move_fn=jet_move):
    """One temperature round: repeat (move_fn → rebalance_loop) until
    ``patience`` consecutive failures to improve the best balanced cut."""
    cut0, ov0 = _host(torch.stack([cut_of(cm, ev, labels),
                                   overload_of(cm, ev, labels, k, lmax)]))
    best_cut = np.float32(cut0) if ov0 <= 0 else np.float32(np.inf)
    best_labels = labels
    locked = torch.zeros(ev.n_local, dtype=torch.bool, device=labels.device)
    since = it = 0
    while since < patience and it < max_inner:
        key, k_reb = rnd.split(key)
        labels, locked = move_fn(cm, gb, ev, labels, locked, tau, k)
        labels, ov, _, _ = rebalance_loop(cm, gb, ev, labels, k_reb, lmax, k)
        cut = np.float32(_host(cut_of(cm, ev, labels)))
        if ov <= 0 and cut < best_cut:
            best_labels, best_cut, since = labels, cut, 0
        else:
            since += 1
        it += 1
    # if no balanced state was ever seen, fall back to the last labels
    return best_labels if np.isfinite(best_cut) else labels


def refine_level(cm, gb, ev: EdgeView, labels, key, lmax, taus, k: int,
                 patience: int, max_inner: int, move_fn=jet_move):
    """Whole-level d4xJet: one :func:`jet_inner` per temperature τ_i (each
    τ rounded to float32, as the reference's τ vector is)."""
    for tau in taus:
        key, sub = rnd.split(key)
        labels = jet_inner(cm, gb, ev, labels, f32(tau, labels.device), lmax,
                           sub, k, patience, max_inner, move_fn=move_fn)
    return labels


# --------------------------------------------------------------------------
# dLP baseline round (size-constrained label propagation)
# --------------------------------------------------------------------------

def lp_round(cm, gb, ev: EdgeView, labels, key, lmax, k: int):
    bw = block_weights(cm, ev, labels, k)
    capacity = lmax - bw
    lv_e = _head_labels(cm, ev, labels)
    _, gain, target = gb.best(ev, lv_e, labels, capacity)
    want = (gain > 0) & torch.isfinite(gain) & ev.owned

    w_in = cm.psum(segment_sum(torch.where(want, ev.nw, 0.0), target, k))
    p = torch.where(w_in > 0, torch.clamp(
        capacity / torch.clamp_min(w_in, 1e-9), 0.0, 1.0), 1.0)
    accept = want & (cm.uniform(key, ev) < p[target])
    return torch.where(accept, target, labels)


def lp_level(cm, gb, ev: EdgeView, labels, key, lmax, k: int,
             lp_rounds: int = 8, max_epochs: int = 32):
    """dLP level: ``lp_rounds`` LP rounds + the rebalance finisher."""
    for _ in range(lp_rounds):
        key, sub = rnd.split(key)
        labels = lp_round(cm, gb, ev, labels, sub, lmax, k)
    key, sub = rnd.split(key)
    labels, _, _, _ = rebalance_loop(cm, gb, ev, labels, sub, lmax, k,
                                     max_epochs)
    return labels
