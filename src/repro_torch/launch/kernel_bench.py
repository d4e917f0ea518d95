"""Time the class-sum, fused-step, fused-inference, packed clause, lfsr
cluster and threefry kernels at the main paths' shapes.

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_bench.py [name ...]

Times ``class_sum``, ``fused_step``, ``tm_infer``, ``packed_clause_tile``,
``packed_clause_eval``, ``lfsr_bits``, ``threefry_bits``,
``step_prologue`` and ``step_epilogue`` (where the tree has them; names
given, those alone) of whichever ``repro_torch`` Python imports: this
checkout's, or another's put first on ``PYTHONPATH``, so one run on one
card can hold two versions of the kernels against each other.  Each
call goes through the public wrapper, and each result is
first held against the kernel's plain version (exact); the operands are
made from seed 0.  Device time per
call: 200 calls captured in one CUDA graph and replayed (warm), and the
same with L2 overwritten before each call (cold).  ``floor_ms`` is the
same replay of 200 one-element ``zero_()`` calls: the least a graph node
takes on this card, the floor under every row.  Prints the card's name
and power limit, then one JSON line.  Exits 1 without a CUDA card.

Shapes: ``class_sum`` at the serving bank (K=4, B=32, R=4224), the
``mxu`` fit's step (K=1, B=32, R=2048) and the edge (B=1, R=4224 serving,
R=2048 training), H=16; ``fused_step`` at the MNIST and KWS-6 CoTM
training steps (B=32, R=2048, W=52 and 100, H=16) and a K=2 bank;
``tm_infer`` (H=16) and ``packed_clause_tile`` (eval mode, n_bits 16
short of 32 W) at the serving bank (K=4, B=32, R=C=4224, W=100,
L=3200) and at K=1, B=32 with MNIST widths (R=C=2048, W=52, L=1664);
``packed_clause_eval`` (eval mode, n_bits 16 short of 32 W) at the
serving edge (K=1, R=4224, W=100, B=1 and 4) and the edge training step
(K=1, B=1, R=2048, W=52); at the full-width conv model's shapes (R=2048,
W=12, 361 patches), ``packed_clause_tile`` at the conv flush (K=2, 32
requests × 361 patches) and edge request (K=1, 361 rows), ``class_sum``
at the conv flush (K=2, B=32, H=16), and ``lfsr_bits`` (24-bit lanes,
8192 of them, 16-bit words) at the flat step's selection draw
(2·32·2048 words) and the conv step's patch and TA draws (32·361·2048
and 2·32·2048·384), and ``threefry_bits`` (one key, 16-bit words) at the
flat step's selection draw (2·32·2048 words) and the program draw of the
MNIST CoTM (2000·1568 TA words without the split, 10·2000 weight words),
and the train step's glue kernels ``step_prologue`` and ``step_epilogue``
at the MNIST fit's step (K=1, B=32, R=2048, W=52, H=16), its edge step
(B=1) and a bank of four at the roster tile (K=4, B=32, R=4224, W=100,
the last program a regression one), each with ``plain_ms``, its plain
version's kernels replayed the same way, and the epilogue also in the
other launch layouts of ``GLUE_LAYOUTS`` (8 and 1 blocks a cluster, the
wide kernel) at the fit's step, and the conv step's TA stage
``conv_ta_update`` (both its kernels) at the conv cell's step (K=1, B=32
and 1, P=361, R=2048, L=384, W=12) on the operands of an engine step
(``conv_ta_operands``), with ``plain_ms`` and ``dense_bound_ms``.
Bounds are the bytes each call must move, or for ``threefry_bits`` the
larger of those and its integer instructions (``THREEFRY_OPS`` a word)
at the issue rate, 128 a clock an SM, 132 SMs and 1980 MHz; for
``conv_ta_update`` the bytes its operands need (``conv_ta_bytes``: the
drawn words that can count), and ``dense_bound_ms`` every drawn word.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
CALLS = 200

CLASS_SUM = [(4, 32, 4224, 16), (1, 32, 2048, 16), (1, 1, 4224, 16),
             (1, 1, 2048, 16), (2, 32, 2048, 16)]    # K, B, R, H
FUSED = [(1, 32, 2048, 52, 16), (1, 32, 2048, 100, 16),
         (2, 32, 2048, 52, 16)]                      # K, B, R, W, H
SERVE = [(4, 32, 4224, 100, 16), (1, 32, 2048, 52, 16)]   # K, B, R, W, H
EDGE = [(1, 1, 4224, 100), (1, 4, 4224, 100), (1, 1, 2048, 52)]  # K, B, R, W
CONV_TILE = [(2, 32 * 361, 2048, 12), (1, 361, 2048, 12)]        # K, B, R, W
LFSR = [2 * 32 * 2048, 32 * 361 * 2048, 2 * 32 * 2048 * 384]     # words
THREEFRY = [(2 * 32 * 2048, 16, True), (2000 * 1568, 1, False),
            (10 * 2000, 1, True)]                     # words, rand_bits, split
GLUE = [(1, 32, 2048, 52, 16), (1, 1, 2048, 52, 16),
        (4, 32, 4224, 100, 16)]                       # K, B, R, W, H
# the epilogue's launch layouts timed beside its own at the fit's shape
GLUE_LAYOUTS = [{"cluster": 8}, {"cluster": 1}, {"wide": 1}]
CONV_TA = [32, 1]     # batch rows of the conv step (K=1, P=361, R=2048, L=384)
# 32-bit integer instructions a threefry word: 20 rounds of an add, a
# funnel-shift rotate and an xor (60), the first and 5 more key injections
# of two adds (12), the output xor and the shift (2)
THREEFRY_OPS = 74
# H100 SXM: 4 schedulers an SM issue one warp instruction a clock each;
# the kernel's mix of integer adds, rotates and xors runs above the 64 a
# clock of any one integer pipe, so the issue rate bounds it
ISSUE_OPS_PER_S = 128 * 132 * 1.98e9


def graph_ms(torch, fn, n: int, cold_l2=None, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed ``reps`` times, so no host launch cost is counted.
    With ``cold_l2`` (a buffer larger than L2) each call follows an
    overwrite of it, whose own time is subtracted.  Dead graphs (a dead
    engine's, freed only by the cyclic collector) are collected before
    the capture and no collection runs during it: a graph freed while
    another captures invalidates that capture."""
    def replay(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g):
                for _ in range(n):
                    body()
        finally:
            if collecting:
                gc.enable()
        g.replay()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for _ in range(reps):
            g.replay()
        e.record()
        torch.cuda.synchronize()  # dtmlint: disable=DTM003 (a timing fence)
        return s.elapsed_time(e) / (reps * n)

    if cold_l2 is None:
        return replay(fn)

    def both():
        cold_l2.zero_()
        fn()
    return replay(both) - replay(cold_l2.zero_)


def words(torch, gen, shape, density):
    """int32 words whose 32 bits are each set with ``density``."""
    bits = torch.rand((*shape, 32), generator=gen) < density
    w = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def glue_operands(torch, gen, K, B, R, W, H, dev):
    """The step glue's operands at a shape: the prologue's draws, labels
    and program leaves, and the epilogue's front-half outputs (0/1 clause
    outputs and selections, 10 real classes), the last program of a bank
    a regression one."""
    h_mask = (torch.arange(H) < 10).to(torch.int32).repeat(K, 1)
    reg = torch.arange(K) == K - 1 if K > 1 else torch.zeros(1, dtype=bool)
    labels = torch.randint(0, 10, (K, B), generator=gen, dtype=torch.int32)
    draws = [labels, torch.randint(0, 1 << 16, (K, B), generator=gen),
             torch.randint(0, 1 << 16, (K, 2), generator=gen),
             torch.randint(0, 1 << 16, (K, 2, B, R), generator=gen),
             h_mask, reg]
    draws = [t.to(dev) for t in draws]
    from repro_torch.kernels.step_glue import step_prologue_plain
    labels, cls_lab, neg, _, sel = step_prologue_plain(*draws)

    def bits(p):
        return (torch.rand((K, B, R), generator=gen) < p).to(
            torch.int32).to(dev)
    epi = [words(torch, gen, (K, B, W), 0.5).to(dev), bits(0.3),
           torch.randint(-500, 500, (K, B, H), generator=gen,
                         dtype=torch.int32).to(dev), bits(0.05), bits(0.05),
           sel, labels, cls_lab, neg,
           torch.randint(-7, 8, (K, H, R), generator=gen,
                         dtype=torch.int32).to(dev),
           torch.ones((K, R), dtype=torch.int32, device=dev),
           torch.zeros(K, dtype=torch.bool, device=dev),
           torch.full((K,), 2047, dtype=torch.int32, device=dev),
           torch.full((K,), 500, dtype=torch.int32, device=dev),
           draws[5]]
    return draws, epi


def conv_ta_operands(torch, B: int, seed: int = 0):
    """The conv TA stage's operands of one engine step at the conv cell's
    shape (the MNIST CoTM's sizes on 28×28 images, a 10×10 window): a
    program whose clauses include about three literals each, so that they
    fire on some patches, and B random images; taken from the step's call
    of ``ops.conv_ta_update_op``."""
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    spec = api.TMSpec.conv(28, 28, 10, classes=10, clauses=2000, T=500,
                           s=10.0, ta_bits=8, weight_bits=12,
                           prng_backend="lfsr", lfsr_bits=24, rand_bits=16)
    eng = api.compile(api.tile_for(spec))
    cfg = spec.tm_config()
    gen = torch.Generator().manual_seed(seed)
    shape = (cfg.total_clauses, cfg.literals)
    ta = cfg.include_threshold - 1 + (torch.rand(shape, generator=gen)
                                      < 3 / shape[1]).to(torch.int32)
    w = torch.randint(-3, 4, (cfg.classes, cfg.clauses), generator=gen,
                      dtype=torch.int32)
    prog = eng.lower(spec, ta=ta, weights=w)
    rng = np.random.default_rng(seed)
    x = (rng.random((B, 28, 28)) < 0.5).astype(np.int8)
    y = spec.encode_labels(rng.integers(0, 10, B)).cuda()
    seen, op = [], ops.conv_ta_update_op

    def spy(*a, **kw):
        seen.append([t.clone() for t in a])
        return op(*a, **kw)
    ops.conv_ta_update_op = spy
    try:
        eng.train_conv(prog, api.TM(spec, engine=eng, seed=seed).prng,
                       eng.encode(spec, x), y)
    finally:
        ops.conv_ta_update_op = op
    return seen[0]


def conv_ta_bytes(torch, a):
    """(bytes these operands need, bytes of the dense stage) of a conv TA
    stage: the pairs' scalars, the clause outputs of the pairs that need a
    pick and their draws where the clause fires, the drawn words that can
    count (t1 ≠ 0, a real literal, not a boosted hit), the patch words and
    the TA states and include words read and written once; the dense
    stage reads every clause output and every drawn word."""
    from repro_torch.core.booleanize import unpack_literals
    (ta, inc, plits, cl_p, cl, sl, sn, w, lab, neg, pr, tr, lm, cm, _, boost,
     _) = a
    K, R, L = ta.shape
    B, P = plits.shape[1:3]
    need = (cl > 0) & ((sl != 0) | (sn != 0))
    pick = (cl_p * 1000 + (pr % 997).to(torch.int32)).argmax(dim=2)
    lit = torch.gather(unpack_literals(plits, L), 2,
                       pick[..., None].expand(K, B, R, L)) > 0
    skip = boost[:, None, None, None] & (cl > 0)[..., None] & lit

    def t1(s, c, neg_round):
        wr = torch.gather(w, 1, c.long()[..., None].expand(K, B, R))
        return s * ((wr < 0) if neg_round else (wr >= 0))
    live = (lm != 0)[:, None, None, :]
    words = sum(int(((t[..., None] != 0) & live & ~skip).sum())
                for t in (t1(sl, lab, False), t1(sn, neg, True)))
    state = (2 * ta.numel() * ta.element_size() + 2 * inc.numel() * 4
             + 4 * (3 * K * B * R + w.numel() + 2 * K * B + K * L + K * R)
             + plits.numel() * 4)
    need_b = (state + 4 * P * int(need.sum())
              + 8 * int(((cl_p > 0) & need[:, :, None]).sum()) + 8 * words)
    dense = state + 4 * cl_p.numel() + 8 * pr.numel() + 8 * tr.numel()
    return need_b, dense


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card; nothing was run", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch import api  # noqa: F401  (the package before its kernels)
    from repro_torch.kernels.class_sum import class_sum, class_sum_plain
    from repro_torch.kernels.fused_step import fused_step, fused_step_plain
    from repro_torch.kernels.packed_clause import (
        packed_clause_eval, packed_clause_eval_plain, packed_clause_tile,
        packed_clause_tile_plain)
    from repro_torch.kernels.tm_infer import tm_infer, tm_infer_plain
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cold = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def timed(name, shape, fn, plain, nbytes, calls=CALLS, nops=0,
              time_plain=False):
        if only and name not in only:
            return
        got, want = fn(), plain()
        torch.cuda.synchronize()  # dtmlint: disable=DTM003 (a timing fence)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise RuntimeError(f"{name} {shape}: kernel != plain")
        rows.append({"name": name, "shape": shape,
                     "ms": graph_ms(torch, fn, calls),
                     "ms_cold_l2": graph_ms(torch, fn, calls // 4, cold),
                     "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                     nops / ISSUE_OPS_PER_S) * 1e3,
                     "bound_by": ("operations" if nops / ISSUE_OPS_PER_S
                                  > nbytes / HBM_BYTES_PER_S
                                  else "bytes")})
        if time_plain:      # the plain version's kernels, replayed alike
            rows[-1]["plain_ms"] = graph_ms(torch, plain, calls // 4)

    for K, B, R, H in CLASS_SUM:
        cl = (torch.rand((K, B, R), generator=gen) < 0.3).to(torch.int32)
        w = torch.randint(-2047, 2048, (K, H, R), generator=gen,
                          dtype=torch.int32)
        cl, w = cl.to(dev), w.to(dev)
        timed("class_sum", f"K={K} B={B} R={R} H={H}",
              lambda cl=cl, w=w: class_sum(cl, w),
              lambda cl=cl, w=w: class_sum_plain(cl, w),
              4 * (K * B * R + K * H * R + K * B * H))
    for K, B, R, W, H in FUSED:
        ops = [words(torch, gen, (K, B, W), 0.5),
               words(torch, gen, (K, R, W), 0.002),
               torch.randint(-7, 8, (K, H, R), generator=gen,
                             dtype=torch.int32),
               torch.randint(0, 10, (K, B), generator=gen, dtype=torch.int32)]
        ops.append(((ops[3] + 1) % 10).to(torch.int32))
        ops += [torch.randint(0, 1 << 16, (K, 2, B, R), generator=gen,
                              dtype=torch.int32),
                torch.ones((K, R), dtype=torch.int32),
                (torch.arange(H) < 10).to(torch.int32).repeat(K, 1),
                torch.full((K,), 500, dtype=torch.int32),
                torch.arange(K, dtype=torch.int32) % 2]
        ops = [t.to(dev) for t in ops]
        n_bits = 32 * W - 16
        timed("fused_step", f"K={K} B={B} R={R} W={W} H={H}",
              lambda ops=ops, n=n_bits: fused_step(*ops, n_bits=n),
              lambda ops=ops, n=n_bits: fused_step_plain(*ops, n_bits=n),
              4 * (K * B * W + K * R * W + K * H * R + 2 * K * B
                   + 2 * K * B * R + K * R + K * H + 2 * K
                   + 3 * K * B * R + K * B * H))
    for K, B, R, W, H in SERVE:
        L = 32 * W                                   # literals of the words
        lit = words(torch, gen, (K, B, W), 0.5).to(dev)
        inc = words(torch, gen, (K, R, W), 0.001).to(dev)
        n_bits = 32 * W - 16
        timed("packed_clause_tile", f"K={K} B={B} R={R} W={W}",
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_tile(
                  lit, inc, True, n),
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_tile_plain(
                  lit, inc, True, n),
              4 * (K * B * W + K * R * W + K * B * R))
        l8 = (torch.rand((K, B, L), generator=gen) < 0.5).to(torch.int8)
        i8 = (torch.rand((K, R, L), generator=gen) < 0.001).to(torch.int8)
        w = torch.randint(-7, 8, (K, H, R), generator=gen, dtype=torch.int32)
        l8, i8, w = l8.to(dev), i8.to(dev), w.to(dev)
        timed("tm_infer", f"K={K} B={B} C={R} L={L} H={H}",
              lambda l8=l8, i8=i8, w=w: tm_infer(l8, i8, w, True),
              lambda l8=l8, i8=i8, w=w: tm_infer_plain(l8, i8, w, True),
              K * B * L + K * R * L + 4 * K * H * R + 4 * K * B * H)
    for K, B, R, W in EDGE:
        lit = words(torch, gen, (K, B, W), 0.5).to(dev)
        inc = words(torch, gen, (K, R, W), 0.001).to(dev)
        n_bits = 32 * W - 16
        timed("packed_clause_eval", f"K={K} B={B} R={R} W={W}",
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_eval(
                  lit, inc, True, n),
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_eval_plain(
                  lit, inc, True, n),
              4 * (K * B * W + K * R * W + K * B * R))
    for K, B, R, W in CONV_TILE:
        lit = words(torch, gen, (K, B, W), 0.5).to(dev)
        inc = words(torch, gen, (K, R, W), 0.01).to(dev)
        n_bits = 32 * W - 112                        # L=384 of 272 literals
        timed("packed_clause_tile", f"conv K={K} B={B} R={R} W={W}",
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_tile(
                  lit, inc, True, n),
              lambda lit=lit, inc=inc, n=n_bits: packed_clause_tile_plain(
                  lit, inc, True, n),
              4 * (K * B * W + K * R * W + K * B * R))
    try:
        from repro_torch.kernels.lfsr import lfsr_bits, lfsr_bits_plain
    except ImportError:                  # a tree from before the kernel
        lfsr_bits = None
    if lfsr_bits is not None:
        from repro_torch.core.prng import make_cluster
        st = make_cluster(0, 8192, 24, dev)
        for size in LFSR:
            args = (st.lanes, st.master, st.cycles, size, 24, 16, True)
            timed("lfsr_bits", f"size={size} lanes=8192 lfsr_bits=24 "
                  "rand_bits=16",
                  lambda a=args: lfsr_bits(*a),
                  lambda a=args: lfsr_bits_plain(*a),
                  8 * size + 2 * 8 * (8192 + 2), calls=20)
    try:
        from repro_torch.kernels.threefry import (threefry_bits,
                                                  threefry_bits_plain)
    except ImportError:                  # a tree from before the kernel
        threefry_bits = None
    if threefry_bits is not None:
        key = torch.tensor([[0, 7]], dtype=torch.int64, device=dev)
        for size, rb, split in THREEFRY:
            args = (key, size, rb, split)
            timed("threefry_bits", f"size={size} rand_bits={rb} "
                  f"split={split}", lambda a=args: threefry_bits(*a),
                  lambda a=args: threefry_bits_plain(*a),
                  8 * size + 4 * 8, calls=20, nops=THREEFRY_OPS * size)
    try:
        from repro_torch.kernels import step_glue
    except ImportError:                  # a tree from before the kernels
        step_glue = None
    if step_glue is not None:
        for K, B, R, W, H in GLUE:
            draws, epi = glue_operands(torch, gen, K, B, R, W, H, dev)
            timed("step_prologue", f"K={K} B={B} R={R} H={H}",
                  lambda a=draws: step_glue.step_prologue(*a),
                  lambda a=draws: step_glue.step_prologue_plain(*a),
                  12 * 2 * K * B * R + 8 * 3 * K * B + 4 * K * H + 24 * K,
                  time_plain=True)
            # read: cl, both selections, the weights, cl_mask, the sums
            # and the literals; written: cl2, t1, t2, lit2 and the weights
            nbytes = 4 * (3 * K * B * R + 2 * K * H * R + K * R
                          + K * B * H + 3 * K * B * W + 6 * K * B * R)
            layouts = [None] + (GLUE_LAYOUTS if (K, B, R) == (1, 32, 2048)
                                else [])
            for g in layouts:
                timed("step_epilogue", f"K={K} B={B} R={R} W={W} H={H}"
                      + ("" if g is None else f" {g}"),
                      lambda a=epi, g=g: step_glue.step_epilogue(
                          *a, geometry=g),
                      lambda a=epi: step_glue.step_epilogue_plain(*a),
                      nbytes, time_plain=g is None)
    try:
        from repro_torch.kernels import conv_ta
    except ImportError:                  # a tree from before the kernels
        conv_ta = None
    if conv_ta is not None and (not only or "conv_ta_update" in only):
        for B in CONV_TA:
            a = conv_ta_operands(torch, B)
            nbytes, dense = conv_ta_bytes(torch, a)
            timed("conv_ta_update", f"K=1 B={B} P=361 R=2048 L=384 W=12",
                  lambda a=a: conv_ta.conv_ta_update(*a),
                  lambda a=a: conv_ta.conv_ta_update_plain(*a),
                  nbytes, calls=40, time_plain=True)
            if rows and rows[-1]["name"] == "conv_ta_update":
                rows[-1]["dense_bound_ms"] = dense / HBM_BYTES_PER_S * 1e3
            del a
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    print(json.dumps({"kernel_bench": {
        "card": card, "repro_torch": repro_torch.__file__, "calls": CALLS,
        "floor_ms": graph_ms(torch, one.zero_, CALLS), "rows": rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
