#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card
and check them.

    python3 chip_smoke.py [--seed N]

Serving phases:
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
  5b. dense serving: ``TMServer(batch_slot=32)`` on an engine with
     ``kernel_path="mxu"`` (the dense clause kernel on unpacked int8
     operands, then class sums), 4 rounds; answers and class sums must
     equal the default flush's bit for bit;
  5c. fused inference: ``tm_infer_op`` on the same bank operands, one
     launch per round; its raw sums must equal class_sum(clause_eval);
  6. timing: each kernel, its plain version and a library yardstick as
     device time (CUDA-graph replay, warm and with L2 overwritten), the
     wrapper's time per call issued back to back, flush and request
     latency with the host clock, and one flush under torch.profiler.

Training phases (the paper's MNIST CoTM at full width, L=1664, R=2048,
H=16, W=52, on the MNIST-like synthetic set: 2048 training and 512
held-out rows):
  7. main fit: ``TM(spec, lfsr PRNG).fit(epochs=2, batch=32)`` with the
     compacted TA update, then the same fit with the engine's skip off
     (dense update); both under ``torch.cuda.set_sync_debug_mode("error")``
     between each epoch's plan upload and stats fetch.  The two final
     programs and PRNGs must be equal, and the first two steps, replayed
     on a CPU engine, must give the card's programs, PRNGs and stats;
  7b. the same fit with ``kernel_path="mxu"`` (the unfused dense front
     half: clause_eval, class_sum, torch selection) and with
     ``ta_prng="stream"`` (the random words made first as a [1, 64, R, L]
     tensor and read by ta_update_streamed, dense update); both must end
     in phase 7's program and PRNG;
  8. edge: 8 ``partial_fit`` steps at B=1 (counter PRNG), each checked
     against the CPU engine;
  9. bank: one ``ProgramBank.train`` step of MNIST CoTM and MNIST Vanilla
     (K=2, 32 rows each, counter PRNGs), checked against the CPU engine,
     and the same step with ``ta_prng="stream"``, which must equal it;
 10. the training kernels against their plain versions at the path's
     shapes (fused_step K=1 B=32; ta_update and ta_update_streamed K=1
     and K=2 with 2B=64; ta_update_sparse at the fit's last step;
     clause_eval K=1 B=32), timed as in phase 6, the TA rows also as
     ``kernel_ms``: the bare launch, its operands and scalars prepared
     outside the graph (``prepare_ta_update*``), apart from the wrapper;
     the streamed update with its stream build beside the in-kernel update
     on the same inputs; the in-place sparse update on those inputs with
     1, 2, 4, ... of the listed groups, beside the dense update on them
     (the three TA entry points run one kernel body, so ``dense`` is
     that body with every group listed); and one step each of the
     default, skip-off (dense TA) and streamed engines under
     torch.profiler.

Bounds: bytes over 3.35 TB/s; integer operations over 64 per clock per
SM (the CUDA guide's rate for 32-bit integer add, logic, shift, compare
and multiply-add on compute capability 9.0) × the SM count × the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``); for the
dense clause kernels (int8 {0,1} operands), two operations per int8
multiply-add over the data sheet's dense int8 tensor-core rate,
1,979 T/s.  Library yardsticks: ``torch._int_mm`` (int8 -> int32
violation counts, one call per program) on the unpacked operands for
the tile and dense clause kernels, float32 ``torch.matmul`` (TF32 off)
for the edge kernel at B=1, and for ``tm_infer`` the ``_int_mm`` calls
plus one float32 matmul of the clause matrix by the weights.  Operations
are the fewest 32-bit integer instructions the function needs on this
run's inputs: one three-input logic op per word pair of a clause
evaluation (``acc | (inc & ~lit)`` is one LOP3) and one zero test per
clause output; one multiply-add per clause and class of a class sum
(one add per fired clause and class in ``fused_step``); three per
clause, batch row and round of the Alg-3 selection; and, for the TA
update, the ``TA_*`` counts below per seed, stream step and delta, from
this run's feedback bits: the seed and stream steps only for the clause
rows with Type I feedback (Type II reads no random word), no output
shift, and the LFSR refresh count only where a refresh can fire within
the call, 2B >= 2^lfsr_bits - 1.  ``bound_ms_before`` is the earlier
count: streams for every clause row with feedback, the shift out and the
refresh count on every step.  No kernel here does float work.

Prints the card line, ``serving`` and ``training`` JSON lines, a
``kernels`` JSON line and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the exit code is then non-zero.  Without a CUDA
card, or without the repository beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
INT8_TC_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor cores (data sheet)
INT_OPS_PER_CLOCK_PER_SM = 64  # 32-bit integer add/logic/shift/compare/IMAD, cc 9.0
# Integer operations of the TA update, from csrc/ta_update.cu's arithmetic:
TA_SEED_OPS = {"counter": 11,  # key (multiply-add, add) and splitmix32 (9)
               "lfsr": 13}     # ... and the lane mask and nonzero select
TA_STEP_OPS = {"counter": 6,   # xorshift32 (3 shifts, 3 xors)
               "lfsr": 4}      # Galois shift (shift, bit test, xor, select)
TA_SHIFT_OUT_OPS = 1           # the word's shift to rand_bits: no work, since the
                               # compare can take a shifted threshold (counted
                               # only by the earlier bound, bound_ms_before)
TA_REFRESH_OPS = 2             # lfsr with seed_refresh: cycle count add, compare,
                               # counted only where a refresh can fire within a
                               # call (2B >= 2^lfsr_bits - 1)
TA_DELTA_OPS = 6               # rand < p_ta, literal bit, Type I select and add,
                               # Type II test and add, per (TA, row with feedback)
TA_CLIP_OPS = 3                # clip to [0, n_states - 1], the include compare
ROUNDS = 4                   # stacked flushes, each 4 tenants x 32 requests
EDGE = 4                     # single-datapoint requests per tenant
ITERS = 200                  # kernel calls per timing graph
N_TRAIN, N_TEST = 2048, 512  # MNIST-like rows for the training phases
EDGE_STEPS = 8               # partial_fit steps at B=1


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def int_ops_per_s(torch) -> float:
    """64 integer operations per clock per SM × SMs × the max SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


class Capture:
    """Within the block, record the arguments of the last call of
    ``module.name`` (a kernel wrapper as the ops module calls it); the
    wrapper itself still runs and counts its launches."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __enter__(self):
        def record(*a, **kw):
            self.args = (a, kw)
            return self.fn(*a, **kw)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


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


def bound(nbytes: int, ops: int, rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def same_state(torch, a, b) -> bool:
    """Leaf-for-leaf equality of two programs or two PRNGs."""
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a.leaves(), b.leaves()))


def paper_spec(api, cfg, backend: str):
    return api.TMSpec(kind=cfg.tm_type, features=cfg.features,
                      clauses=cfg.clauses, classes=cfg.classes, T=cfg.T,
                      s=cfg.s, ta_bits=cfg.ta_bits,
                      weight_bits=cfg.weight_bits, prng_backend=backend,
                      lfsr_bits=cfg.lfsr_bits)


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
    from repro_torch.core.dtm import STAT_KEYS
    from repro_torch.core.prng import PRNG
    from repro_torch.kernels.fused_step import fused_step, fused_step_plain
    from repro_torch.kernels.ta_update import (
        prepare_ta_update, prepare_ta_update_sparse,
        prepare_ta_update_streamed, stream_rands, ta_update, ta_update_plain,
        ta_update_sparse, ta_update_sparse_plain, ta_update_streamed,
        ta_update_streamed_plain)
    from repro_torch.core.booleanize import unpack_literals
    from repro_torch.kernels.clause_eval import clause_eval, clause_eval_plain
    from repro_torch.kernels.tm_infer import tm_infer, tm_infer_plain
    from repro_torch.launch.serve_tm import TMServer
    from repro_torch.kernels.ref import NEG_INF_SUM
    # float32 products (the plain versions, the yardsticks) in full float32
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(card)
    int_rate = int_ops_per_s(torch)
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

    # ---- 5b. dense serving: the mxu clause path (counts from 0 just before) -
    gpu_mxu = api.compile(tile, device="cuda", kernel_path="mxu")
    dense = server(gpu_mxu, B)
    ops.reset_launch_counts()
    dense_answers, dense_flush_s = [], []
    with Capture(ops, "clause_eval") as cap_ce_serve:
        for r in range(ROUNDS):
            for n in roster:
                dense.enqueue(n, reqs[n][r * B:(r + 1) * B])
            t = time.perf_counter()
            dense_answers.append(dense.flush())
            torch.cuda.synchronize()
            dense_flush_s.append(time.perf_counter() - t)
    counts_dense_serve = ops.launch_counts()
    check(counts_dense_serve["clause_eval"] == ROUNDS
          and counts_dense_serve["class_sum"] == ROUNDS
          and counts_dense_serve["packed_clause_tile"] == 0,
          f"dense flushes launched {counts_dense_serve}")
    for r in range(ROUNDS):
        for n in roster:
            check(np.array_equal(dense_answers[r][n], answers[r][n]),
                  f"dense answers of {n} differ from the default flush")
    sums_p, cl_p = gpu.infer_bank(bank.progs, lits)
    sums_d, cl_d = gpu_mxu.infer_bank(bank.progs, lits)
    check(torch.equal(sums_d, sums_p) and torch.equal(cl_d, cl_p),
          "dense class sums or clauses differ from the default path")
    check(gpu_mxu.cache_report()["path_per_stage"]["infer_bank"] == "mxu",
          f"dense engine paths {gpu_mxu.cache_report()}")

    # ---- 5c. fused inference: tm_infer on the same bank operands -----------
    inc8 = unpack_literals(inc, L)
    lit8s = [unpack_literals(torch.stack(
        [gpu.encode(specs[n], reqs[n][r * B:(r + 1) * B]) for n in names]), L)
        for r in range(ROUNDS)]
    ops.reset_launch_counts()
    fused_sums = [ops.tm_infer_op(l8, inc8, weights) for l8 in lit8s]
    torch.cuda.synchronize()
    counts_tm_infer = ops.launch_counts()
    check(counts_tm_infer["tm_infer"] == ROUNDS
          and counts_tm_infer["clause_eval"] == 0,
          f"fused inference launched {counts_tm_infer}")
    for l8, fs in zip(lit8s, fused_sums):
        check(torch.equal(fs, class_sum(clause_eval(l8, inc8, True), weights)),
              "tm_infer differs from class_sum(clause_eval)")
    h_real = bank.progs.h_mask[:, None, :] == 1
    check(torch.equal(torch.where(h_real, fused_sums[0],
                                  torch.full_like(sums_p, NEG_INF_SUM)),
                      sums_p), "tm_infer differs from the engine's sums")

    # ---- 7. training: the main fit, compacted and dense ---------------------
    spec = paper_spec(api, tm_paper.TM_MNIST_COTM, "lfsr")
    spec_c = paper_spec(api, tm_paper.TM_MNIST_COTM, "counter")
    spec_v = paper_spec(api, tm_paper.TM_MNIST_VANILLA, "counter")
    ttile = api.tile_for(spec)
    eng = api.compile(ttile, device="cuda")
    eng_dense = api.compile(ttile, device="cuda", skip=False)
    eng_cpu = api.compile(ttile, device="cpu")
    geo = (eng.L, eng.R, eng.H, eng.W)
    check(geo == (1664, 2048, 16, 52), f"training engine geometry {geo}")
    task = datasets.MNIST_LIKE
    x_tr, y_tr = datasets.make_bool_dataset(task, N_TRAIN, seed=args.seed + 100)
    x_te, y_te = datasets.make_bool_dataset(task, N_TEST, seed=args.seed + 200)
    tm_a = api.TM(spec, engine=eng, seed=args.seed)
    tm_b = api.TM(spec, engine=eng_dense, seed=args.seed)
    p0, r0 = tm_a.program.to("cpu"), tm_a.prng.to("cpu")
    check(same_state(torch, tm_a.program, tm_b.program)
          and same_state(torch, tm_a.prng, tm_b.prng),
          "the two fits start from different states")

    def fit(tm):
        t = time.perf_counter()
        hist = tm.fit(x_tr, y_tr, epochs=2, batch=32,
                      rng=np.random.default_rng(args.seed), sync_guard=True)
        torch.cuda.synchronize()
        return hist, time.perf_counter() - t

    ops.reset_launch_counts()
    with Capture(ops, "fused_step") as cap_front, \
            Capture(ops, "ta_update_sparse") as cap_sparse:
        hist, fit_s = fit(tm_a)
    counts_fit = ops.launch_counts()
    ops.reset_launch_counts()
    with Capture(ops, "ta_update") as cap_dense1:
        hist_d, fit_d_s = fit(tm_b)
    counts_dense = ops.launch_counts()
    steps = 2 * (N_TRAIN // 32)
    check(counts_fit["fused_step"] == steps
          and counts_fit["ta_update_sparse"] == steps
          and counts_fit["ta_update"] == 0,
          f"the compacted fit launched {counts_fit}")
    check(counts_dense["fused_step"] == steps
          and counts_dense["ta_update"] == steps
          and counts_dense["ta_update_sparse"] == 0,
          f"the dense fit launched {counts_dense}")
    check(hist == hist_d, "compacted and dense fits give other histories")
    check(same_state(torch, tm_a.program, tm_b.program)
          and same_state(torch, tm_a.prng, tm_b.prng),
          "compacted and dense fits end in other programs or PRNGs")
    check(hist[-1]["train_acc"] > 1.0 / spec.classes,
          f"last epoch train accuracy {hist[-1]['train_acc']}")
    test_acc = tm_a.score(x_te, y_te)

    # the first two steps of the fit, on the card and on the CPU engine
    plan = np.random.default_rng(args.seed).permutation(N_TRAIN).reshape(
        -1, 32)
    pg, rg, pc, rc = p0.to("cuda"), r0.to("cuda"), p0, r0
    cpu_s = 0.0
    for s_ in range(2):
        xb, lab = x_tr[plan[s_]], spec.encode_labels(y_tr[plan[s_]])
        pg, rg, sg = eng.train_step(pg, rg, eng.encode(spec, xb),
                                    lab.cuda())
        t = time.perf_counter()
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec, xb), lab)
        cpu_s += time.perf_counter() - t
        check(same_state(torch, pg, pc) and same_state(torch, rg, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"fit step {s_} on the card differs from the CPU engine")

    # ---- 7b. the same fit on the dense front half and on streamed words -----
    eng_mxu = api.compile(ttile, device="cuda", kernel_path="mxu")
    eng_stream = api.compile(ttile, device="cuda", ta_prng="stream")
    tm_m = api.TM(spec, engine=eng_mxu, seed=args.seed)
    tm_s = api.TM(spec, engine=eng_stream, seed=args.seed)
    for tm_ in (tm_m, tm_s):
        check(same_state(torch, tm_.program, p0)
              and same_state(torch, tm_.prng, r0),
              "the dense and streamed fits start from other states")
    ops.reset_launch_counts()
    with Capture(ops, "clause_eval") as cap_ce_train:
        hist_m, fit_m_s = fit(tm_m)
    counts_fit_mxu = ops.launch_counts()
    ops.reset_launch_counts()
    with Capture(ops, "ta_update_op") as cap_stream_op, \
            Capture(ops, "ta_update_streamed") as cap_streamed1:
        hist_s, fit_s_s = fit(tm_s)
    counts_fit_stream = ops.launch_counts()
    check(counts_fit_mxu["clause_eval"] == steps
          and counts_fit_mxu["class_sum"] == steps
          and counts_fit_mxu["fused_step"] == 0
          and counts_fit_mxu["ta_update_sparse"] == steps,
          f"the dense-front fit launched {counts_fit_mxu}")
    check(counts_fit_stream["ta_update_streamed"] == steps
          and counts_fit_stream["fused_step"] == steps
          and counts_fit_stream["ta_update"] == 0
          and counts_fit_stream["ta_update_sparse"] == 0,
          f"the streamed fit launched {counts_fit_stream}")
    for name, h_, tm_ in (("dense-front", hist_m, tm_m),
                          ("streamed", hist_s, tm_s)):
        check(h_ == hist and same_state(torch, tm_.program, tm_a.program)
              and same_state(torch, tm_.prng, tm_a.prng),
              f"the {name} fit does not end as the compacted fit")
    check(eng_mxu.cache_report()["path_per_stage"]["train"] == "mxu"
          and eng_stream.cache_report()["path_per_stage"] == {
              "train": "fused", "train_ta": "dense",
              "train_prng": "lfsr-stream"},
          f"paths {eng_mxu.cache_report()} {eng_stream.cache_report()}")

    # ---- 8. edge training: partial_fit at B=1 --------------------------------
    tm_e = api.TM(spec_c, engine=eng, seed=args.seed + 1)
    pc, rc = tm_e.program.to("cpu"), tm_e.prng.to("cpu")
    ops.reset_launch_counts()
    edge_train_s = []
    for i in range(EDGE_STEPS):
        xb, yb = x_tr[i:i + 1], y_tr[i:i + 1]
        t = time.perf_counter()
        sg = tm_e.partial_fit(xb, yb)
        torch.cuda.synchronize()
        edge_train_s.append(time.perf_counter() - t)
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec_c, xb),
                                        spec_c.encode_labels(yb))
        check(same_state(torch, tm_e.program, pc)
              and same_state(torch, tm_e.prng, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"edge step {i} on the card differs from the CPU engine")
    counts_edge_train = ops.launch_counts()
    check(counts_edge_train["packed_clause_eval"] == EDGE_STEPS
          and counts_edge_train["class_sum"] == EDGE_STEPS
          and counts_edge_train["ta_update_sparse"] == EDGE_STEPS
          and counts_edge_train["fused_step"] == 0,
          f"edge training launched {counts_edge_train}")

    # ---- 9. bank training: MNIST CoTM + MNIST Vanilla, K=2 -------------------
    gen = torch.Generator()
    b_progs = [eng.lower(sp, gen.manual_seed(args.seed + 2 + k))
               for k, sp in enumerate((spec_c, spec_v))]
    b_prngs = [PRNG.create(sp.tm_config(), args.seed + 4 + k, device="cuda")
               for k, sp in enumerate((spec_c, spec_v))]
    bank = api.stack(b_progs, eng, prngs=b_prngs)
    cpu_bank = api.stack([q.to("cpu") for q in b_progs], eng_cpu,
                         prngs=[q.to("cpu") for q in b_prngs])
    b_x = [x_tr[32 * k:32 * (k + 1)] for k in range(2)]
    b_y = np.stack([y_tr[32 * k:32 * (k + 1)] for k in range(2)])
    b_lits = torch.stack([eng.encode(sp, xb) for sp, xb in
                          zip((spec_c, spec_v), b_x)])
    ops.reset_launch_counts()
    with Capture(ops, "ta_update") as cap_bank:
        bst = bank.train(b_lits, b_y)
    counts_bank = ops.launch_counts()
    check(counts_bank["fused_step"] == 1 and counts_bank["ta_update"] == 1
          and counts_bank["ta_update_sparse"] == 0,
          f"the bank step launched {counts_bank}")
    t = time.perf_counter()
    cst = cpu_bank.train(b_lits.cpu(), b_y)
    cpu_s += time.perf_counter() - t
    check(same_state(torch, bank.progs, cpu_bank.progs)
          and same_state(torch, bank.prngs, cpu_bank.prngs)
          and all(torch.equal(bst[k].cpu(), cst[k]) for k in STAT_KEYS),
          "the bank step on the card differs from the CPU engine")
    s_bank = api.stack(b_progs, eng_stream, prngs=b_prngs)
    ops.reset_launch_counts()
    with Capture(ops, "ta_update_streamed") as cap_streamed2:
        sst = s_bank.train(b_lits, b_y)
    counts_bank_stream = ops.launch_counts()
    check(counts_bank_stream["fused_step"] == 1
          and counts_bank_stream["ta_update_streamed"] == 1
          and counts_bank_stream["ta_update"] == 0,
          f"the streamed bank step launched {counts_bank_stream}")
    check(same_state(torch, s_bank.progs, bank.progs)
          and same_state(torch, s_bank.prngs, bank.prngs)
          and all(torch.equal(sst[k], bst[k]) for k in STAT_KEYS),
          "the streamed bank step differs from the in-kernel one")

    # ---- 10. the training kernels against their plain versions --------------
    def copies(a):
        """Copies of a captured call's tensors, so an in-place update
        changes neither the fit's state nor the other side's inputs."""
        return tuple(t.clone() if isinstance(t, torch.Tensor) else t
                     for t in a)

    def compare_all(kernel, plain, a, kw):
        got, want = kernel(*copies(a), **kw), plain(*copies(a), **kw)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
            n_bad = int((g != w).sum())
            check(n_bad == 0, f"{kernel.__name__}: {n_bad} mismatches")
        return got, err

    f_a, f_kw = cap_front.args
    front, err_front = compare_all(fused_step, fused_step_plain, f_a, f_kw)
    s_a, s_kw = cap_sparse.args       # the fit's last step
    check(s_kw.get("inplace") is True,
          "the fit's compacted update did not run in place")
    s_a = copies(s_a)                 # timed below, in place
    _, err_sparse = compare_all(ta_update_sparse, ta_update_sparse_plain,
                                s_a, s_kw)
    d1_a, d1_kw = cap_dense1.args     # the dense fit's last step (K=1)
    _, err_d1 = compare_all(ta_update, ta_update_plain, d1_a, d1_kw)
    d2_a, d2_kw = cap_bank.args       # the bank step (K=2)
    _, err_d2 = compare_all(ta_update, ta_update_plain, d2_a, d2_kw)

    def compare_one(kernel, plain, a, kw):
        got, want = kernel(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        check(n_bad == 0, f"{kernel.__name__}: {n_bad} mismatches")
        return got, int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    ce4_a, ce4_kw = cap_ce_serve.args     # the last dense flush (K=4)
    _, err_ce4 = compare_one(clause_eval, clause_eval_plain, ce4_a, ce4_kw)
    ce1_a, ce1_kw = cap_ce_train.args     # the dense-front fit's last step
    _, err_ce1 = compare_one(clause_eval, clause_eval_plain, ce1_a, ce1_kw)
    tmi_a, tmi_kw = (lit8s[0], inc8, weights), {"eval_mode": True}
    _, err_tmi = compare_one(tm_infer, tm_infer_plain, tmi_a, tmi_kw)
    st1_a, st1_kw = cap_streamed1.args    # the streamed fit's last step
    st1, err_st1 = compare_all(ta_update_streamed, ta_update_streamed_plain,
                               st1_a, st1_kw)
    st2_a, st2_kw = cap_streamed2.args    # the streamed bank step (K=2)
    _, err_st2 = compare_all(ta_update_streamed, ta_update_streamed_plain,
                             st2_a, st2_kw)
    op_a, op_kw = cap_stream_op.args      # the same step's op call
    ik_kw = {k: v for k, v in op_kw.items() if k != "stream"}
    for g, w in zip(st1, ta_update(*copies(op_a), **ik_kw)):
        check(torch.equal(g, w), "streamed and in-kernel updates differ")

    # step time (host clock) and one profiled step, from the fit's end
    lits32 = eng.encode(spec, x_tr[:32])
    lab32 = spec.encode_labels(y_tr[:32]).cuda()
    step_s = []
    for _ in range(10):
        t = time.perf_counter()
        eng.train_step(tm_a.program, tm_a.prng, lits32, lab32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    step_prof = profile_flush(torch, lambda: eng.train_step(
        tm_a.program, tm_a.prng, lits32, lab32))
    step_ms_by_path = {"default": float(np.median(step_s) * 1e3)}
    step_prof_by_path = {}
    for name, e in (("mxu", eng_mxu), ("stream", eng_stream),
                    ("dense", eng_dense)):
        ts_ = []
        for _ in range(10):
            t = time.perf_counter()
            e.train_step(tm_a.program, tm_a.prng, lits32, lab32)
            torch.cuda.synchronize()
            ts_.append(time.perf_counter() - t)
        step_ms_by_path[name] = float(np.median(ts_) * 1e3)
        if name != "mxu":   # the paths that run the dense TA body
            step_prof_by_path[name] = profile_flush(
                torch, lambda e=e: e.train_step(tm_a.program, tm_a.prng,
                                                lits32, lab32))

    # ---- 6. timing -------------------------------------------------------------
    cold = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    it = ITERS
    K, R, W, H = lits.shape[0], inc.shape[1], inc.shape[2], weights.shape[1]
    clf, wf = cl.float(), weights.float()
    rows_out = []

    def yardstick(fn, what: str):
        """``fn`` if it runs on these inputs, else None (and why)."""
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"chip_smoke: no {what} yardstick: {e}", file=sys.stderr)
            return None
        return fn

    def int_mm(neg, inc_):
        """torch._int_mm per program: the violation counts [B, C]."""
        return lambda: [torch._int_mm(neg[k], inc_[k].t())
                        for k in range(neg.shape[0])]

    def row(name, source, replaces, launches, err, kernel, plain, library,
            nbytes, nops, shape, plain_graph=True, rate=None,
            library_note=None, bare=None, nops_before=None):
        """One kernels-line entry.  The plain version is timed by graph
        replay, or (``plain_graph=False``: it reads the device on the
        host) with events around back-to-back calls.  ``rate`` is the
        operations rate of the bound (default: the integer rate).
        ``bare``: the kernel's bare launch, operands and scalars prepared
        outside the graph (``kernel_ms``); ``nops_before``: the operations
        of the earlier bound (``bound_ms_before``, ``ta_cost``)."""
        b_ms, b_by = bound(nbytes, nops, rate or int_rate)
        extra = {}
        if bare is not None:
            extra["kernel_ms"] = graph_ms(torch, bare, it)
        if nops_before is not None:
            extra["bound_ms_before"] = bound(nbytes, nops_before,
                                             rate or int_rate)[0]
        rows_out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "mismatches": 0,
            "max_abs_err": err, "ms": graph_ms(torch, kernel, it),
            "ms_cold_l2": graph_ms(torch, kernel, it // 4, cold),
            "call_ms": call_ms(torch, kernel, it),
            "plain_ms": (graph_ms(torch, plain, max(it // 20, 2))
                         if plain_graph else call_ms(torch, plain, 3)),
            "library_ms": (None if library is None
                           else graph_ms(torch, library, it)),
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape,
            "library": library_note if library is not None else None,
            **extra})

    cu = "src/repro_torch/csrc/"
    neg8 = (lit8s[0] == 0).to(torch.int8)          # the bank's first round
    lib_tile = yardstick(int_mm(neg8, inc8), "_int_mm")
    neg1f = (unpack_literals(lit1, L) == 0).to(torch.float32)
    inc1f = unpack_literals(inc1, L).to(torch.float32)
    lib_edge = yardstick(
        lambda: torch.matmul(neg1f, inc1f.transpose(-1, -2)), "matmul")
    row("packed_clause_tile", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:184",
        counts_stacked["packed_clause_tile"], err_tile,
        lambda: packed_clause_tile(lits, inc, True, L),
        lambda: packed_clause_tile_plain(lits, inc, True, L), lib_tile,
        4 * (K * B * W + K * R * W + K * B * R), K * B * R * W + K * B * R,
        f"K={K} B={B} R={R} W={W}",
        library_note=f"torch._int_mm x{K} on the unpacked operands "
        "(violation counts)")
    row("packed_clause_eval", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:107",
        counts_edge["packed_clause_eval"], err_edge,
        lambda: packed_clause_eval(lit1, inc1, True, L),
        lambda: packed_clause_eval_plain(lit1, inc1, True, L), lib_edge,
        4 * (W + R * W + R), R * W + R, f"K=1 B=1 R={R} W={W}",
        library_note="torch.matmul float32, TF32 off, on the unpacked "
        "operands (violation counts)")
    row("class_sum", cu + "class_sum.cu",
        "src/repro/kernels/class_sum.py:57",
        counts_stacked["class_sum"] + counts_edge["class_sum"],
        max(err_sum, err_sum1),
        lambda: class_sum(cl, weights),
        lambda: class_sum_plain(cl, weights),
        lambda: torch.matmul(clf, wf.transpose(-1, -2)),
        4 * (K * B * R + K * H * R + K * B * H), K * B * R * H,
        f"K={K} B={B} R={R} H={H}")
    cs1_ms = graph_ms(torch, lambda: class_sum(cl1, w1), it)
    for n in roster:
        stacked.enqueue(n, reqs[n][:B])
    prof = profile_flush(torch, stacked.flush)

    # training kernels at the path's shapes (bounds from these inputs)
    fl, fi, fw = f_a[0], f_a[1], f_a[2]
    fK, fB, fW = fl.shape
    fR, fH = fi.shape[1], fw.shape[1]
    fired_front = int(front[0].sum())
    row("fused_step", cu + "fused_step.cu",
        "src/repro/kernels/fused_step.py:150",
        counts_fit["fused_step"] + counts_dense["fused_step"]
        + counts_bank["fused_step"], err_front,
        lambda: fused_step(*f_a, **f_kw),
        lambda: fused_step_plain(*f_a, **f_kw), None,
        4 * (fK * fB * fW + fK * fR * fW + fK * fH * fR + 2 * fK * fB
             + 2 * fK * fB * fR + fK * fR + fK * fH + 2 * fK
             + 3 * fK * fB * fR + fK * fB * fH),
        fK * fB * fR * fW + fK * fB * fR + fired_front * fH
        + 2 * 3 * fK * fB * fR,
        f"K={fK} B={fB} R={fR} W={fW} H={fH}")

    def ta_cost(a, kw_, sparse: bool, streamed: bool = False,
                earlier: bool = False):
        """(bytes, operations) of one TA update on this run's inputs.
        Rows processed: every clause row (dense), or the rows of the
        128-row groups with feedback (sparse, in place).  Bytes: those
        rows' states read and written in their dtype, their feedback bytes
        and include words, the literals and l_mask.  Operations: per TA
        of a clause row with Type I feedback a seed and 2B stream steps
        (Type II reads no random word, so the other rows need no stream);
        the delta per (TA, batch row) with feedback; the clip and include
        test per TA processed (the TA_* counts).  ``streamed``: no stream
        operations, and the rands words a Type I delta reads (4 bytes per
        TA of a (batch row, clause row) with Type I feedback).  The
        refresh count is work only where a refresh can fire within the
        call.  ``earlier``: the count before these cuts (streams for every
        clause row with feedback, the shift out and the refresh count on
        every step)."""
        ta_, lits_, cl_, t1_, t2_ = a[:5]
        k_, c_, l_ = ta_.shape
        b2, w_ = lits_.shape[1], lits_.shape[2]
        fb = (t1_ > 0) | (t2_ > 0)                              # [K, 2B, C]
        active = fb.any(dim=1)                                  # [K, C]
        streams = active if earlier else (t1_ > 0).any(dim=1)   # [K, C]
        rows_ = k_ * c_
        if sparse:
            g_ = -(-c_ // 128)
            pad = torch.zeros((k_, g_ * 128), dtype=torch.bool,
                              device=active.device)
            pad[:, :c_] = active
            sizes = (c_ - 128 * torch.arange(g_, device=active.device)
                     ).clamp(max=128)
            rows_ = int((pad.view(k_, g_, 128).any(dim=-1) * sizes).sum())
        nbytes = (2 * rows_ * l_ * ta_.element_size() + 4 * rows_ * w_
                  + 3 * b2 * rows_ + 4 * k_ * b2 * w_ + 4 * k_ * l_)
        nops = int(fb.sum()) * l_ * TA_DELTA_OPS + rows_ * l_ * TA_CLIP_OPS
        if streamed:
            return nbytes + 4 * l_ * int((t1_ > 0).sum()), nops
        family = kw_["prng"]
        fires = b2 >= (1 << kw_["lfsr_bits"]) - 1 or earlier
        step = TA_STEP_OPS[family] + (TA_SHIFT_OUT_OPS if earlier else 0) + (
            TA_REFRESH_OPS if family == "lfsr" and kw_["seed_refresh"]
            and fires else 0)
        nops += int(streams.sum()) * l_ * (TA_SEED_OPS[family] + b2 * step)
        return nbytes, nops

    for label, a, kw_, err in (("K=1", d1_a, d1_kw, err_d1),
                               ("K=2", d2_a, d2_kw, err_d2)):
        k_, c_, l_ = a[0].shape
        nb, no = ta_cost(a, kw_, sparse=False)
        row("ta_update", cu + "ta_update.cu",
            "src/repro/kernels/ta_update.py:285",
            counts_dense["ta_update"] + counts_bank["ta_update"], err,
            lambda a=a, kw_=kw_: ta_update(*a, **kw_),
            lambda a=a, kw_=kw_: ta_update_plain(*a, **kw_), None, nb, no,
            f"{label} 2B={a[1].shape[1]} C={c_} L={l_} "
            f"prng={kw_['prng']}", plain_graph=False,
            bare=prepare_ta_update(*a, **kw_)[0],
            nops_before=ta_cost(a, kw_, sparse=False, earlier=True)[1])
    k_, c_, l_ = s_a[0].shape
    n_groups = int(s_a[8].sum())
    nb, no = ta_cost(s_a, s_kw, sparse=True)
    row("ta_update_sparse", cu + "ta_update.cu",
        "src/repro/kernels/ta_update.py:238",
        counts_fit["ta_update_sparse"]
        + counts_edge_train["ta_update_sparse"], err_sparse,
        lambda: ta_update_sparse(*s_a, **s_kw),
        lambda: ta_update_sparse_plain(*s_a, **s_kw), None, nb, no,
        f"K=1 2B={s_a[1].shape[1]} C={c_} L={l_} active_groups={n_groups}"
        f"/{-(-c_ // 128)} prng={s_kw['prng']}", plain_graph=False,
        bare=prepare_ta_update_sparse(*s_a, **s_kw)[0],
        nops_before=ta_cost(s_a, s_kw, sparse=True, earlier=True)[1])
    # the same inputs with the first n listed groups only, and the dense
    # kernel on them: the in-place update's time against the active share
    dense_kw = {k: v for k, v in s_kw.items() if k != "inplace"}
    ta_ms_by_groups = {"dense": graph_ms(
        torch, lambda: ta_update(*s_a[:6], *s_a[9:], **dense_kw), it)}
    for n_ in sorted({max(n_groups >> i, 1) for i in range(5)}):
        a_ = s_a[:8] + (torch.full_like(s_a[8], n_),) + s_a[9:]
        ta_ms_by_groups[n_] = graph_ms(
            torch, lambda a_=a_: ta_update_sparse(*a_, **s_kw), it)

    # the dense clause kernels: serving (K=4) and the dense-front fit (K=1)
    for label, a, kw_, err in (("serving", ce4_a, ce4_kw, err_ce4),
                               ("training", ce1_a, ce1_kw, err_ce1)):
        k_, b_, l_ = a[0].shape
        c_ = a[1].shape[1]
        row("clause_eval", cu + "clause_eval.cu",
            "src/repro/kernels/clause_eval.py:72",
            counts_dense_serve["clause_eval"] + counts_fit_mxu["clause_eval"],
            err, lambda a=a, kw_=kw_: clause_eval(*a, **kw_),
            lambda a=a, kw_=kw_: clause_eval_plain(*a, **kw_),
            yardstick(int_mm((a[0] == 0).to(torch.int8), a[1]), "_int_mm"),
            k_ * b_ * l_ + k_ * c_ * l_ + 4 * k_ * b_ * c_,
            2 * k_ * b_ * c_ * l_,
            f"{label} K={k_} B={b_} C={c_} L={l_} "
            f"eval_mode={kw_['eval_mode']}", rate=INT8_TC_OPS_PER_S,
            library_note=f"torch._int_mm x{k_} (violation counts)")
    k_, b_, l_ = lit8s[0].shape
    c_, h_ = inc8.shape[1], weights.shape[1]
    clf_d = clause_eval(lit8s[0], inc8, True).to(torch.float32)
    pair_lib = int_mm(neg8, inc8)

    def lib_tmi():
        pair_lib()
        return torch.matmul(clf_d, wf.transpose(-1, -2))
    row("tm_infer", cu + "clause_eval.cu", "src/repro/kernels/tm_infer.py:86",
        counts_tm_infer["tm_infer"], err_tmi,
        lambda: tm_infer(*tmi_a, **tmi_kw),
        lambda: tm_infer_plain(*tmi_a, **tmi_kw),
        yardstick(lib_tmi, "_int_mm + matmul"),
        k_ * b_ * l_ + k_ * c_ * l_ + 4 * k_ * h_ * c_ + 4 * k_ * b_ * h_,
        2 * k_ * b_ * c_ * l_ + 2 * k_ * b_ * c_ * h_,
        f"K={k_} B={b_} C={c_} L={l_} H={h_}", rate=INT8_TC_OPS_PER_S,
        library_note=f"torch._int_mm x{k_} + torch.matmul float32 "
        f"({k_ + 1} calls: violation counts, then clauses x weights)")
    def ms_of(name, shape):
        """``ms`` of the kernels-line row ``name`` whose shape starts
        with ``shape``."""
        return next(r["ms"] for r in rows_out
                    if r["name"] == name and r["shape"].startswith(shape))

    dense_cmp = {
        "flush_ms": [s_ * 1e3 for s_ in dense_flush_s],
        "flush_ms_median_after_first":
            float(np.median(dense_flush_s[1:]) * 1e3),
        "tile_ms": ms_of("packed_clause_tile", ""),
        "clause_eval_ms": ms_of("clause_eval", "serving"),
        "tm_infer_ms": ms_of("tm_infer", ""),
        "clause_eval_plus_class_sum_ms": graph_ms(
            torch, lambda: class_sum(clause_eval(lit8s[0], inc8, True),
                                     weights), it),
        "launches": {"dense_flush": counts_dense_serve,
                     "tm_infer": counts_tm_infer}}

    # the streamed TA update: the streamed fit's last step (K=1, lfsr) and
    # the streamed bank step (K=2, counter)
    for label, a, err in (("K=1", st1_a, err_st1), ("K=2", st2_a, err_st2)):
        k_, c_, l_ = a[0].shape
        nb, no = ta_cost(a, None, sparse=False, streamed=True)
        row("ta_update_streamed", cu + "ta_update.cu",
            "src/repro/kernels/ta_update.py:333",
            counts_fit_stream["ta_update_streamed"]
            + counts_bank_stream["ta_update_streamed"], err,
            lambda a=a: ta_update_streamed(*a),
            lambda a=a: ta_update_streamed_plain(*a), None, nb, no,
            f"{label} 2B={a[1].shape[1]} C={c_} L={l_} rands int32 "
            f"{tuple(a[6].shape)}", plain_graph=False,
            bare=prepare_ta_update_streamed(*a)[0], nops_before=no)
    k_, c_, l_ = op_a[0].shape
    b2 = op_a[1].shape[1]
    stream_cmp = {
        "shape": f"K={k_} 2B={b2} C={c_} L={l_} prng={op_kw['prng']}",
        "rands_bytes": 4 * k_ * b2 * c_ * l_,
        "inkernel_ta_update_ms": graph_ms(
            torch, lambda: ta_update(*op_a, **ik_kw), it),
        "streamed_kernel_ms": ms_of("ta_update_streamed", "K=1"),
        "stream_build_ms": call_ms(torch, lambda: stream_rands(
            k_, b2, c_, l_, op_kw["seed"], op_a[0].device,
            rand_bits=op_kw["rand_bits"], prng=op_kw["prng"],
            lfsr_bits=op_kw["lfsr_bits"],
            seed_refresh=op_kw["seed_refresh"]), 3),
        "build_and_streamed_ms": call_ms(
            torch, lambda: ops.ta_update_op(*op_a, **op_kw), 3),
        "step_ms_median": step_ms_by_path}

    training = {
        "card": card, "model": "MNIST CoTM (784 f, 2000 clauses, 10 classes,"
        " T=500, s=10, ta_bits 8, lfsr_bits 24)",
        "engine": {"L": eng.L, "R": eng.R, "H": eng.H, "W": eng.W},
        "rows": {"train": N_TRAIN, "test": N_TEST}, "batch": 32,
        "epochs": len(hist), "fit_s": {"compact": fit_s, "dense": fit_d_s},
        "epoch_s": {"compact": tm_a.epoch_seconds,
                    "dense": tm_b.epoch_seconds},
        "steps_per_s": {"compact": [(N_TRAIN // 32) / e
                                    for e in tm_a.epoch_seconds],
                        "dense": [(N_TRAIN // 32) / e
                                  for e in tm_b.epoch_seconds]},
        "step_ms_median": float(np.median(step_s) * 1e3),
        "edge_step_ms_median": float(np.median(edge_train_s) * 1e3),
        "skip_frac": tm_a.skip_frac,
        "ta_ms_by_listed_groups": ta_ms_by_groups,
        "train_acc": [h["train_acc"] for h in hist],
        "group_skip_frac": [h["group_skip_frac"] for h in hist],
        "test_acc": test_acc, "step_profile": step_prof,
        "step_profile_by_path": step_prof_by_path,
        "fit_s_dense_front": fit_m_s, "fit_s_streamed": fit_s_s,
        "stream_vs_inkernel": stream_cmp,
        "cpu_reference_s": cpu_s, "int_ops_per_s": int_rate,
        "launches": {"fit_compact": counts_fit, "fit_dense": counts_dense,
                     "fit_dense_front": counts_fit_mxu,
                     "fit_streamed": counts_fit_stream,
                     "edge": counts_edge_train, "bank": counts_bank,
                     "bank_streamed": counts_bank_stream}}

    serving = {
        "card": card, "tenants": list(roster), "batch_slot": B,
        "rounds": ROUNDS, "engine": {"L": L, "R": R, "H": H, "W": W},
        "program_nbytes": stacked.stats()["program_nbytes"],
        "fired_clause_share": fired,
        "flush_ms": [s * 1e3 for s in flush_s],
        "flush_ms_median_after_first": float(np.median(flush_s[1:]) * 1e3),
        "edge_predict_ms_median": float(np.median(edge_s) * 1e3),
        "class_sum_b1_ms": cs1_ms,
        "flush_profile": prof, "dense": dense_cmp,
        "launches": {"stacked": counts_stacked, "edge": counts_edge},
        "build_s": build_s}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
