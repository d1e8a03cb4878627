#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, partitions two small
graphs against the reference's golden labels, drives the main path —
``partition()`` of grid2d(1024, 1024) into 64 blocks — with the launch
counters reset just before it, and times the kernels.  Every phase prints one
line; the first failure raises and the script exits non-zero.  The line
before the last is the kernel report (JSON), the last line the device record.
Exits 2 without printing a result when no CUDA card is visible.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
FULL = dict(nx=1024, ny=1024, k=64, eps=0.03, refiner="d4xjet", seed=0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def abs_err(got, want) -> float:
    """Largest |kernel - plain| over float outputs (0 where both are the same
    infinity); inf if infinities disagree."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype != torch.float32:
            continue
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        fin = torch.isfinite(a) & torch.isfinite(b)
        if not bool((same | fin).all()):
            return float("inf")
        err = max(err, float((a - b)[fin].abs().max()) if fin.any() else 0.0)
    return err


def random_inputs(n, d, k, seed, device):
    """Integer-weight scoreboard inputs with PAD slots, +inf / -inf / finite
    capacities and rows with no eligible block."""
    from repro_torch.core.graph import PAD

    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, k, (n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = PAD
    nbr_w = rng.integers(1, 4, (n, d)).astype(np.float32)
    nbr_w[nbr == PAD] = 0.0
    labels = rng.integers(0, k, n).astype(np.int32)
    nw = rng.integers(1, 5, n).astype(np.float32)
    cap = rng.integers(0, 6, k).astype(np.float32)
    cap[rng.random(k) < 0.2] = np.inf
    cap[rng.random(k) < 0.2] = -np.inf
    cap[0] = -np.inf  # at K=2, rows of block 1 have no eligible block
    return [torch.from_numpy(a).to(device)
            for a in (nbr, nbr_w, labels, nw, cap)]


def bound_ms(n_bytes: int, n_ops: int):
    """The least time the card needs: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / F32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as tc
    import repro_torch.graphs as tg
    from repro_torch.kernels import build
    from repro_torch.kernels.gain import kernel as gain_kernel
    from repro_torch.kernels.seed import kernel as seed_kernel
    from repro_torch.refine import drivers, engine
    from repro_torch.refine.comm import edge_view_from_graph, tid_uniform
    from repro_torch.refine.gain import KernelGain
    from repro_torch.random import PRNGKey

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device and build --------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    t = time.perf_counter()
    libs = build.build([gain_kernel.SOURCE, seed_kernel.SOURCE], verbose=True)
    say("build", f"{', '.join(p.name for p in libs)} built for sm_90a in "
        f"{time.perf_counter() - t:.1f} s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 2. kernel against its plain version, on the card ---------------
    g = tg.grid2d(FULL["nx"], FULL["ny"], device=dev)
    ev = edge_view_from_graph(g)
    k = FULL["k"]
    grid = f"grid2d({FULL['nx']},{FULL['ny']})"
    kg = KernelGain(ev, k, drivers.graph_max_deg(g))
    rng = np.random.default_rng(1)
    labels = torch.from_numpy(rng.integers(0, k, g.n)).to(dev)
    lv_e = labels[torch.where(ev.live, ev.head, 0)]
    bw = torch.bincount(labels, minlength=k).float()
    lmax = tc.l_max(g, k, FULL["eps"])
    caps = {"jet (cap=+inf)": None,
            "rebalance (finite/-inf cap)": torch.where(
                bw > lmax, -torch.inf, lmax - bw)}
    max_err = {"gain": 0.0, "seed": 0.0}
    full_inputs = kg.inputs(ev, lv_e, labels, None)
    for name, cap in caps.items():
        inputs = kg.inputs(ev, lv_e, labels, cap)
        got = gain_kernel.gain_scoreboard(*inputs)
        want = gain_kernel.gain_scoreboard_plain(*inputs)
        torch.cuda.synchronize()
        check(all(bits_equal(a, b) for a, b in zip(got, want)),
              f"kernel != plain on the full-size graph, {name}")
        max_err["gain"] = max(max_err["gain"], abs_err(got, want))
        say("parity", f"gain_scoreboard {grid} K={k} {name}: "
            "bit-equal")
    for kk in (2, 64, 1000):
        inputs = random_inputs(65536, 16, kk, kk, dev)
        got = gain_kernel.gain_scoreboard(*inputs)
        want = gain_kernel.gain_scoreboard_plain(*inputs)
        torch.cuda.synchronize()
        check(all(bits_equal(a, b) for a, b in zip(got, want)),
              f"kernel != plain on random inputs, K={kk}")
        check(kk != 2 or bool(torch.isneginf(got[1]).any()),
              "no row without an eligible block was tested")
        max_err["gain"] = max(max_err["gain"], abs_err(got, want))
        say("parity", f"gain_scoreboard random N=65536 D=16 K={kk} "
            "+-inf/finite cap: bit-equal")

    # greedy seeding at the main path's shape (its coarsest level is the
    # whole graph: coarsening stops at once on this grid), then float weights
    noise = tid_uniform(PRNGKey(0), torch.arange(g.n, device=dev), 1e-3)
    order = torch.argsort(-(g.nw + noise), stable=True)
    seed_inputs = (order, g.nw[order], k)
    got = seed_kernel.greedy_seed(*seed_inputs)
    t = time.perf_counter()
    want = seed_kernel.greedy_seed_plain(*seed_inputs)
    torch.cuda.synchronize()
    seed_plain_ms = (time.perf_counter() - t) * 1e3
    check(torch.equal(got, want), f"greedy_seed kernel != plain at n={g.n}")
    max_err["seed"] = float((got - want).abs().max())
    say("parity", f"greedy_seed n={g.n} K={k} unit weights: equal "
        f"(plain version {seed_plain_ms / 1e3:.1f} s)")
    nw = torch.from_numpy(rng.random(20000).astype(np.float32) * 10).to(dev)
    order_f = torch.argsort(-nw, stable=True)
    got = seed_kernel.greedy_seed(order_f, nw[order_f], 1000)
    want = seed_kernel.greedy_seed_plain(order_f, nw[order_f], 1000)
    check(torch.equal(got, want), "greedy_seed kernel != plain on float weights")
    max_err["seed"] = max(max_err["seed"], float((got - want).abs().max()))
    say("parity", "greedy_seed n=20000 K=1000 float weights: equal")

    # ---- 3. small graphs against the reference's golden labels -----------
    with np.load(ROOT / "src" / "repro_torch" / "testdata"
                 / "golden_small.npz") as golden:
        for name, graph in (("grid2d_32x32_k8", tg.grid2d(32, 32, device=dev)),
                            ("rmat_9_k8", tg.rmat(scale=9, device=dev))):
            res = tc.partition(graph, 8, seed=0, device=dev)
            check(np.array_equal(res.labels.cpu().numpy(), golden[name]),
                  f"{name}: labels differ from the golden file")
            say("golden", f"{name}: labels equal the reference's "
                f"(cut {res.cut}, imbalance {res.imbalance:.5f})")

    # ---- 4. the main path at full width ----------------------------------
    run = {kk: v for kk, v in FULL.items() if kk not in ("nx", "ny")}
    results = {}
    for gain in ("kernel", "segment"):
        gain_kernel.LAUNCHES = seed_kernel.LAUNCHES = 0
        engine.HOST_SYNCS = 0
        drivers.reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = tc.partition(g, gain=gain, device=dev, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        results[gain] = (res, wall, gain_kernel.LAUNCHES, seed_kernel.LAUNCHES)
        lab = res.labels
        check(lab.shape == (g.n,) and lab.dtype == torch.int32
              and int(lab.min()) >= 0 and int(lab.max()) < k,
              f"{gain}: labels out of shape or range")
        check(np.isfinite(res.cut) and np.isfinite(res.imbalance),
              f"{gain}: non-finite cut or imbalance")
        say("full", f"{grid} n={g.n} m={g.m} k={k} gain={gain}: "
            f"cut {res.cut} imbalance {res.imbalance:.5f} levels "
            f"{res.levels} wall {wall:.2f} s launches: gain_scoreboard "
            f"{gain_kernel.LAUNCHES} greedy_seed {seed_kernel.LAUNCHES}; "
            f"host syncs {engine.HOST_SYNCS} "
            f"({engine.HOST_SYNCS / res.levels:.0f}/level)")
    (res_k, wall_k, launches, seeds), (res_s, _, seg_launches, _) = (
        results["kernel"], results["segment"])
    check(launches > 0, "the main path launched gain_scoreboard no time")
    check(seeds > 0, "the main path launched greedy_seed no time")
    check(seg_launches == 0, "the segment backend launched gain_scoreboard")
    check(torch.equal(res_k.labels, res_s.labels) and res_k.cut == res_s.cut,
          "kernel-backend labels differ from segment-backend labels")
    say("full", "kernel and segment backends give equal labels")

    # ---- 5. kernel time at the main path's shapes ------------------------
    nbr_lab = full_inputs[0]
    n, d = nbr_lab.shape
    ms = time_ms(lambda: gain_kernel.gain_scoreboard(*full_inputs), 200)
    plain_ms = time_ms(
        lambda: gain_kernel.gain_scoreboard_plain(*full_inputs), 20)
    slots = int(((nbr_lab >= 0) & (nbr_lab < k)).sum())
    gain_bound = bound_ms(n_bytes=n * d * 8 + n * 8 + k * 4 + n * 12,
                          n_ops=slots + 2 * n * k)  # add per slot; cmp+select
    seed_ms = time_ms(lambda: seed_kernel.greedy_seed(*seed_inputs), 5)
    seed_bound = bound_ms(n_bytes=g.n * 20, n_ops=g.n * (k + 1))
    rows = [("gain_scoreboard", "src/repro_torch/kernels/gain/csrc/"
             "gain_scoreboard.cu", "src/repro/kernels/gain/kernel.py:44",
             launches, max_err["gain"], ms, plain_ms, gain_bound),
            ("greedy_seed", "src/repro_torch/kernels/seed/csrc/greedy_seed.cu",
             "src/repro/core/initial.py:53", seeds, max_err["seed"], seed_ms,
             seed_plain_ms, seed_bound)]
    for name, _, _, count, _, t_ms, t_plain, (b_ms, b_by) in rows:
        say("time", f"{name}: {t_ms * 1e3:.1f} us per call (plain "
            f"{t_plain * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us by {b_by}); "
            f"{count} launches in the main-path run of {wall_k:.2f} s; "
            f"card {card}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": ref,
        "launches": count, "max_abs_err": err, "ms": t_ms,
        "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    } for name, src, ref, count, err, t_ms, t_plain, (b_ms, b_by) in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
