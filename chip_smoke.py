#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases:
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (set-up) and
     print the card's name and power limit;
  2. make the four paper models (MNIST and KWS-6, CoTM and Vanilla, at
     their published widths) as tenants, from ``--seed``: each clause row
     includes a few x-literals of one class motif of the synthetic sets,
     so clauses fire and answers differ by class;
  3. stacked serving: ``TMServer(batch_slot=32)``, every tenant enqueues a
     full slot, one flush per round, 4 rounds (tile clause kernel + class
     sums);
  4. edge serving: ``TMServer(batch_slot=1)``, ``predict`` per request,
     4 requests per tenant (edge clause kernel + class sums);
  5. checks: each kernel equals its plain version bit for bit at these
     shapes, the server's answers equal those of a CPU engine running the
     plain versions, clauses fire, answers are not all one class, and every
     kernel was launched by the phases above;
  6. timing: each kernel, its plain version and a library yardstick as
     device time (CUDA-graph replay, warm and with L2 overwritten), the
     wrapper's time per call issued back to back, flush and request
     latency with the host clock, and one flush under torch.profiler.

Prints the card line, a ``serving`` JSON line, a ``kernels`` JSON line
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the exit code is then non-zero.  Without a CUDA card, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
ALU_OPS_PER_S = 67e12        # H100 SXM non-tensor-core rate (float32 row)
ROUNDS = 4                   # stacked flushes, each 4 tenants x 32 requests
EDGE = 4                     # single-datapoint requests per tenant
ITERS = 200                  # kernel calls per timing graph


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def motif_program(engine, spec, task, rng, datasets, n_inc=3, w_max=4):
    """A program whose clause rows each include ``n_inc`` x-literals of
    one motif of their class (Vanilla negative-polarity rows: of the next
    class), with TA states on the right side of J; CoTM weights +1..+w_max
    for the row's class and -1..-w_max for the others."""
    import numpy as np
    cfg = spec.tm_config()
    rows, j = cfg.total_clauses, cfg.include_threshold
    motifs = datasets.motifs(task)
    ta = rng.integers(0, j, (rows, cfg.literals))
    if spec.kind == "vanilla":
        r = np.arange(rows)
        cls = (r // cfg.clauses + (r % cfg.clauses) % 2) % cfg.classes
    else:
        cls = np.arange(rows) % cfg.classes
    picks = rng.integers(0, task.motifs_per_class, rows)
    for r in range(rows):
        bits = np.flatnonzero(motifs[cls[r], picks[r]])
        on = rng.choice(bits, n_inc, replace=False)
        ta[r, on] = rng.integers(j, 2 * j, n_inc)
    weights = None
    if spec.kind == "coalesced":
        weights = -rng.integers(1, w_max + 1, (cfg.classes, cfg.clauses))
        weights[cls, np.arange(rows)] = rng.integers(1, w_max + 1, rows)
    return engine.lower(spec, ta=ta, weights=weights)


def graph_ms(torch, fn, n: int, cold_l2=None, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed, so no host launch cost is counted.  With
    ``cold_l2`` (a buffer larger than L2) each call follows an overwrite
    of L2, and a graph of the overwrites alone is subtracted."""
    def replay_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                body()
        g.replay()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for _ in range(reps):
            g.replay()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / (reps * n)

    if cold_l2 is None:
        return replay_ms(fn)

    def both():
        cold_l2.zero_()
        fn()
    return replay_ms(both) - replay_ms(cold_l2.zero_)


def call_ms(torch, fn, n: int) -> float:
    """Time per call when calls are issued back to back (CUDA events):
    the larger of the device time and the host's launch cost."""
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def profile_flush(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, summed kernel
    time on the device, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    dev_us = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "busy_share": (dev_us / 1e6) / wall if kernels else None,
            "kernels": [{"name": k[0][:60], "us": k[1], "count": k[2]}
                        for k in top]}


def bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the programs and the requests")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing was run", file=sys.stderr)
        return 1
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch import api
    from repro_torch.configs import tm_paper
    from repro_torch.data import datasets
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.class_sum import class_sum, class_sum_plain
    from repro_torch.kernels.packed_clause import (
        packed_clause_eval, packed_clause_eval_plain, packed_clause_tile,
        packed_clause_tile_plain)
    from repro_torch.launch.serve_tm import TMServer

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(card)
    print(f"build: {build_s:.1f} s, {sorted(p.name for p in libs.values())}")

    # ---- 2. programs --------------------------------------------------------
    roster = {"mnist_cotm": (tm_paper.TM_MNIST_COTM, datasets.MNIST_LIKE),
              "mnist_vanilla": (tm_paper.TM_MNIST_VANILLA,
                                datasets.MNIST_LIKE),
              "kws6_cotm": (tm_paper.TM_KWS6_COTM, datasets.KWS6_LIKE),
              "kws6_vanilla": (tm_paper.TM_KWS6_VANILLA, datasets.KWS6_LIKE)}
    specs = {n: api.TMSpec(kind=c.tm_type, features=c.features,
                           clauses=c.clauses, classes=c.classes, T=c.T, s=c.s,
                           ta_bits=c.ta_bits, weight_bits=c.weight_bits,
                           lfsr_bits=c.lfsr_bits)
             for n, (c, _) in roster.items()}
    tile = api.tile_for(*specs.values())
    gpu = api.compile(tile, device="cuda")
    cpu = api.compile(tile, device="cpu")
    check((gpu.L, gpu.R, gpu.H, gpu.W) == (3200, 4224, 16, 100),
          f"engine geometry {(gpu.L, gpu.R, gpu.H, gpu.W)}")
    rng = np.random.default_rng(args.seed)
    progs = {n: motif_program(cpu, specs[n], task, rng, datasets)
             for n, (_, task) in roster.items()}
    B, n_stack = 32, ROUNDS * 32
    reqs = {n: datasets.make_bool_dataset(task, n_stack + EDGE,
                                          seed=args.seed + i)[0]
            for i, (n, (_, task)) in enumerate(roster.items())}

    def server(engine, slot):
        srv = TMServer(engine, batch_slot=slot)
        for n in roster:
            srv.register(n, specs[n], program=progs[n])
        return srv

    # ---- 3. stacked serving (counts from 0 just before, read just after) ---
    stacked = server(gpu, B)
    ops.reset_launch_counts()
    answers, flush_s = [], []
    for r in range(ROUNDS):
        for n in roster:
            stacked.enqueue(n, reqs[n][r * B:(r + 1) * B])
        t = time.perf_counter()
        answers.append(stacked.flush())
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t)
    counts_stacked = ops.launch_counts()

    # ---- 4. edge serving ----------------------------------------------------
    edge = server(gpu, 1)
    ops.reset_launch_counts()
    edge_answers, edge_s = [], []
    for i in range(EDGE):
        for n in roster:
            t = time.perf_counter()
            edge_answers.append(edge.predict(n, reqs[n][n_stack + i:
                                                        n_stack + i + 1]))
            edge_s.append(time.perf_counter() - t)
    counts_edge = ops.launch_counts()

    # ---- 5. checks ------------------------------------------------------------
    check(counts_stacked["packed_clause_tile"] == ROUNDS
          and counts_stacked["class_sum"] == ROUNDS
          and counts_stacked["packed_clause_eval"] == 0,
          f"stacked flushes launched {counts_stacked}")
    check(counts_edge["packed_clause_eval"] == EDGE * len(roster)
          and counts_edge["class_sum"] == EDGE * len(roster)
          and counts_edge["packed_clause_tile"] == 0,
          f"edge requests launched {counts_edge}")
    ref_stacked, ref_edge = server(cpu, B), server(cpu, 1)
    for r in range(ROUNDS):
        for n in roster:
            ref_stacked.enqueue(n, reqs[n][r * B:(r + 1) * B])
        want = ref_stacked.flush()
        for n in roster:
            check(np.array_equal(answers[r][n], want[n]),
                  f"stacked answers of {n} differ from the plain engine")
    k = 0
    for i in range(EDGE):
        for n in roster:
            want = ref_edge.predict(n, reqs[n][n_stack + i:n_stack + i + 1])
            check(np.array_equal(edge_answers[k], want),
                  f"edge answer of {n} differs from the plain engine")
            k += 1
    for n in roster:
        classes = np.unique(np.concatenate([a[n] for a in answers]))
        check(len(classes) > 1, f"{n} answers only class {classes}")

    names = list(roster)
    bank = api.stack([progs[n] for n in names], gpu)
    lits = torch.stack([gpu.encode(specs[n], reqs[n][:B]) for n in names])
    inc, weights = bank.progs.inc, bank.progs.weights
    L = gpu.L
    rows = torch.tensor([specs[n].tm_config().total_clauses for n in names])
    lit1, inc1, w1 = lits[:1, :1], inc[:1], weights[:1]

    def compare(kernel, plain, *a):
        got, want = kernel(*a), plain(*a)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        mismatches = int((got != want).sum())
        check(mismatches == 0, f"{kernel.__name__}: {mismatches} mismatches")
        return got, err

    cl_tile, err_tile = compare(packed_clause_tile, packed_clause_tile_plain,
                                lits, inc, True, L)
    cl_edge, err_edge = compare(packed_clause_eval, packed_clause_eval_plain,
                                lit1, inc1, True, L)
    check(torch.equal(cl_edge[0], cl_tile[:1, :1][0]),
          "edge and tile kernels disagree on one datapoint")
    cl = cl_tile * bank.progs.cl_mask[:, None, :]
    _, err_sum = compare(class_sum, class_sum_plain, cl, weights)
    cl1 = cl[:1, :1].contiguous()
    _, err_sum1 = compare(class_sum, class_sum_plain, cl1, w1)
    fired = float(cl.sum()) / float(B * rows.sum())
    check(fired > 0, "no clause fired")

    # ---- 6. timing -------------------------------------------------------------
    cold = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    it = ITERS
    K, R, W, H = lits.shape[0], inc.shape[1], inc.shape[2], weights.shape[1]
    clf, wf = cl.float(), weights.float()
    rows_out = []

    def row(name, source, replaces, launches, err, kernel, plain, library,
            nbytes, nops, shape):
        b_ms, b_by = bound(nbytes, nops)
        rows_out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "mismatches": 0,
            "max_abs_err": err, "ms": graph_ms(torch, kernel, it),
            "ms_cold_l2": graph_ms(torch, kernel, it // 4, cold),
            "call_ms": call_ms(torch, kernel, it),
            "plain_ms": graph_ms(torch, plain, max(it // 20, 2)),
            "library_ms": (None if library is None
                           else graph_ms(torch, library, it)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape})

    cu = "src/repro_torch/csrc/"
    row("packed_clause_tile", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:184",
        counts_stacked["packed_clause_tile"], err_tile,
        lambda: packed_clause_tile(lits, inc, True, L),
        lambda: packed_clause_tile_plain(lits, inc, True, L), None,
        4 * (K * B * W + K * R * W + K * B * R), 2 * K * B * R * W,
        f"K={K} B={B} R={R} W={W}")
    row("packed_clause_eval", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:107",
        counts_edge["packed_clause_eval"], err_edge,
        lambda: packed_clause_eval(lit1, inc1, True, L),
        lambda: packed_clause_eval_plain(lit1, inc1, True, L), None,
        4 * (W + R * W + R), 2 * R * W, f"K=1 B=1 R={R} W={W}")
    row("class_sum", cu + "class_sum.cu",
        "src/repro/kernels/class_sum.py:57",
        counts_stacked["class_sum"] + counts_edge["class_sum"],
        max(err_sum, err_sum1),
        lambda: class_sum(cl, weights),
        lambda: class_sum_plain(cl, weights),
        lambda: torch.matmul(clf, wf.transpose(-1, -2)),
        4 * (K * B * R + K * H * R + K * B * H), 2 * K * B * R * H,
        f"K={K} B={B} R={R} H={H}")
    cs1_ms = graph_ms(torch, lambda: class_sum(cl1, w1), it)
    for n in roster:
        stacked.enqueue(n, reqs[n][:B])
    prof = profile_flush(torch, stacked.flush)

    serving = {
        "card": card, "tenants": list(roster), "batch_slot": B,
        "rounds": ROUNDS, "engine": {"L": L, "R": R, "H": H, "W": W},
        "program_nbytes": stacked.stats()["program_nbytes"],
        "fired_clause_share": fired,
        "flush_ms": [s * 1e3 for s in flush_s],
        "flush_ms_median_after_first": float(np.median(flush_s[1:]) * 1e3),
        "edge_predict_ms_median": float(np.median(edge_s) * 1e3),
        "class_sum_b1_ms": cs1_ms,
        "flush_profile": prof,
        "launches": {"stacked": counts_stacked, "edge": counts_edge},
        "build_s": build_s}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
