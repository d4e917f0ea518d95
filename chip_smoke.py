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
     shapes (the edge clause kernel at B=1 and at B=4 of the bank's first
     program; phase 10 adds its edge training shape), the server's
     answers equal those of a CPU engine running the
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
     latency with the host clock, and one flush under torch.profiler;
     class_sum at the serving bank (K=4) and at the mxu fit's shape
     (K=1, B=32, captured in phase 7b), its launches counted over every
     path that runs it, and at B=1 (``class_sum_b1_ms``); tm_infer also
     as ``kernel_ms``, its bare launch without the wrapper's fill
     (``prepare_tm_infer``); the rate of the tensor cores'
     single-bit product (``b1_mma_probe``: back-to-back
     ``mma.m16n8k256 .b1 .and.popc``), which bounds packed_clause_tile;
     packed_clause_eval at B=1 (the row), B=4 and the edge training
     shape (captured in phase 8), its launches counted over edge serving
     and edge training, beside ``floor_ms``: 200 one-element ``zero_()``
     calls replayed the same way, the least a graph node takes.

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
     against the CPU engine (edge clause kernel + class sums + torch
     selection, then the compacted TA update);
  9. bank: one ``ProgramBank.train`` step of MNIST CoTM and MNIST Vanilla
     (K=2, 32 rows each, counter PRNGs), checked against the CPU engine,
     and the same step with ``ta_prng="stream"``, which must equal it;
 10. the training kernels against their plain versions at the path's
     shapes (fused_step K=1 B=32, also as ``kernel_ms``, its bare launch
     from ``prepare_fused_step``, and under torch.profiler: one kernel a
     call, in the profiled step and alone; the step glue's step_prologue
     and step_epilogue at the fit's step (K=1 B=32, the epilogue in place
     as the donated step runs it), both also checked at the edge step
     (B=1) and the bank step (K=2); ta_update and ta_update_streamed K=1
     and K=2 with 2B=64; ta_update_sparse at the fit's second step;
     clause_eval K=1 B=32; packed_clause_eval at the edge step's B=1,
     R=2048, W=52), timed as in phase 6, the TA rows also as
     ``kernel_ms``: the bare launch, its operands and scalars prepared
     outside the graph (``prepare_ta_update*``), apart from the wrapper;
     the streamed update with its stream build beside the in-kernel update
     on the same inputs; the in-place sparse update on those inputs with
     1, 2, 4, ... of the listed groups, beside the dense update on them
     (the three TA entry points run one kernel body, so ``dense`` is
     that body with every group listed); and one step each of the
     default, skip-off (dense TA) and streamed engines under
     torch.profiler.

 11. the lfsr cluster kernel (``lfsr_bits``, every cycle of a
     ``PRNG.bits`` call in one launch) against its plain loop on the card:
     the flat step's draws and the conv step's from the fit's starting
     cluster, widths 4, 8, 12 and 32 with and without the refresh (two
     cycles short of it), rand_bits above and below the width, a K=2 bank
     and lane counts off the block; words and state equal;
 12. conv at full width (the MNIST CoTM's hyperparameters on 28x28 images
     with a 10x10 window: 361 patches, L=384, R=2048, H=16, W=12, P=361):
     ``TM.fit`` of 2 epochs of 1024 MNIST-like rows (64 steps of 32)
     under ``set_sync_debug_mode("error")``, its first two steps replayed
     on the CPU engine and equal (program, PRNG, stats); a conv bank of
     two tenants (the trained model, one lowered from another seed), 2
     flushes of 32 rows each, and 4 edge ``predict`` requests of one row,
     all equal to the CPU engine's answers; the host time of a conv step,
     a profiled conv step and conv flush.  The kernels line gains the
     lfsr row (the conv step's ta_rand draw; the patch and flat selection
     draws as extra keys) and the tile and class_sum rows at the conv
     flush's shapes (the tile also at the train step's and the edge
     request's).

Scheduled durable serving:
 13. ``api.serve`` of the four serving models (lfsr PRNGs, the motif
     programs of phase 2) with a durable directory under ``$TMPDIR``:
     ``resident_slots=2`` a family, ``pipeline_depth=2``, MNIST CoTM
     ``GOLD``, KWS-6 Vanilla ``BATCH``.  Drain mode: 16 rounds of one
     32- or 16-row request a tenant (KWS-6 CoTM sends a second, so the
     EWMA membership promotes it), 4 ``submit_train`` steps of MNIST
     CoTM and one of each other tenant on the same cycles; thread mode:
     64 requests a tenant open loop, with the driver and checkpoint
     writer threads; a stack with transient launch faults at 3 indices
     and one whose retries run out.  Every answer and training step
     equals a synchronous twin on the card, one round the CPU engine's;
     gold requests survive the transient faults with the plan's retry
     count, and exhausted retries fail exactly the two affected futures.
     Then ``checkpoint_now()`` and ``api.serve(None, durable_dir=...)``:
     every tenant equals the live one, and both stacks continue 2 rounds
     of train + infer identically.  The kernels line gains the
     ``scheduled`` rows: the tile and class sums of the resident bank
     (K=2) and the cold path (K=1), ``fused_step``, ``ta_update_sparse``
     and the selection draw at the roster tile (L=3200, R=4224, W=100),
     each held against its plain version on the captured arguments,
     launches counted from the first scheduled request to the end of
     the fault stacks.

Threefry and the plain datapath:
 14. the MNIST CoTM at full width with ``prng_backend="threefry"`` on
     phase 7's engine: ``threefry_bits`` (split and words of a threefry
     ``PRNG.bits`` call in one launch) against its plain version on the
     flat step's three draws (32, 131,072 and 2 words), the program draw
     (2,000 x 1,568 TA words without the split, 10 x 2,000 weight words),
     a K=2 bank, sizes 1, 255 and 1,025 at rand_bits 8, 16 and 32 and
     seeds 0, 1, -5 and 2^32 + 5 (keys and words equal); the program
     lowered on the card from ``PRNGKey(seed)`` against the CPU engine's
     (timed: ``lower_ms``); ``TM(spec, seed).fit`` of 2 epochs of 32-row
     batches under ``set_sync_debug_mode("error")``, its first two steps
     replayed on the CPU engine and equal; 4 edge ``partial_fit`` steps
     and a K=2 ``ProgramBank.train`` step, each against the CPU engine;
     the host step time and one profiled step beside phase 7's.  The
     kernels line gains the ``threefry_bits`` row (the selection draw;
     the program draw's two calls as extra keys).
 15. ``compile(kernel_path="ref")`` on the card (every clause, class-sum
     and TA stage through its plain version): one stacked flush of the
     serving roster against the default flush's answers, 8 train steps
     of phase 7's model from its starting program and PRNG against the
     default engine's, and one K=2 bank step against phase 9's; the
     counts over the phase show no launch of the nine clause and TA
     kernels or the two step-glue kernels, and the lfsr draws' launches.

CUDA graphs (every phase above runs its fits, ``partial_fit`` steps and
bank flushes as graph replays: an epoch of ``TMSession.fit_epochs`` is
one replay of the captured step per batch, a bank flush one replay;
launch counts add each graph's captured launches per replay, so the
checks of the counts above hold as they were; the kernel checks of
phases 5b, 9, 10 and 13 take their arguments from eager calls of the
engine's step, bank step or (bank) inference on the same state, since
a capture runs no kernel and ``Capture`` skips calls made under one):
 16. the six fits of the MNIST CoTM (compacted, skip-off, ``mxu``,
     streamed, conv, threefry) run twice, replayed (``TM.fit`` under
     ``set_sync_debug_mode("error")``) and as the eager chain of the
     engine's step from the same program, PRNG and shuffle: programs,
     PRNGs and histories equal, the first epoch's per-step stats from
     ``_fit_epoch_impl`` equal the chain's, that epoch's launch counts
     equal steps × its graph's captured counts, and the program and
     PRNG the caller held unchanged; ``partial_fit`` at B=1 (flat and
     conv) against the eager step; stacked flushes of the serving
     roster (K=4, then a resident K=2) and of the conv bank on fresh
     engines across three ``swap_in`` calls and a ``swap_resident``,
     each against the eager bank inference, with ``cache_report`` at 1
     graph a stage.  The ``graphs`` line reports host ms a replayed
     step, epoch s, steps/s, fit s and the eager chain's ms a step per
     fit, each epoch's device time (CUDA events, the host held off by a
     sleep kernel so the events read device time) against its host
     time (the busy share without the profiler), capture and warm-up
     ms and pool bytes per graph, flush and ``partial_fit`` wall ms
     against eager, the scheduled cycle of phase 13, and the conv fit's
     peak device memory with its capture.
 17. the served executables (every other JAX stage executable): the
     serving roster at full width with lfsr, counter, threefry and lfsr
     PRNGs, two conv tenants and a K=3 counter bank go through
     ``served_sequence`` (three ``predict`` calls, a resident roster of
     two and its cold path, ten ``TMServer.train`` steps over three
     tenants, a restack at an unchanged K, three ``ProgramBank.train``
     steps each followed by a flush, a conv ``predict`` and flush) on
     fresh engines and on their eager twins (graphs off): every answer,
     step and final state equal, the bank's tensors never rebound, held
     programs unchanged, ``cache_report`` equal to the JAX engine's after
     the same calls (``SERVED_CACHE``), each graph's replays
     ``SERVED_REPLAYS`` (no recapture after a bank step or a restack),
     launches = replays x captured counts.  The ``served_graphs`` line
     reports host ms beside the eager twin (``predict`` flat and conv, a
     cold request, ``TMServer.train`` lfsr and threefry,
     ``ProgramBank.train`` K=2, the first flush after a bank step and
     after a restack, a new-K restack's capturing flush), capture ms and
     pool bytes per graph, and phase 13's scheduled cycle broken down
     (encode, bank replay, cold path, the rest of the flush, train,
     collect, the scheduler's own time).  Since this phase the drain's
     kernel checks of phase 13 and the bank step's of phase 9 take their
     arguments from eager building-block calls on the same state.

The dispatcher's plan cache and the analysis layer:
 18. "tuned": (a) the launch checker (``repro_torch.analysis.
     kernel_check``) with ``HardwareModel.from_device(0)``: 0 violations
     over every plan, its restated ``fused_step`` shared memory equal to
     the library's ``dtm_fused_step_smem``; (b) ``autotune="measure"``
     into a temporary cache at the roster's width (L=3200, R=4224, H=16)
     and the training width (L=1664, R=2048, H=16): eval buckets 1-64,
     train buckets 1, 4, 8 and 32 and ``ta`` at 32, each candidate's ms
     by path and launch geometry (three geometries a packed eval leg,
     the fused leg's cluster sizes at R=4224; each checked by the launch
     checker first) beside the seed model's pick and seconds, the path
     the fastest at its own geometry, and ``planned_tiles`` equal to the
     plan's ``tiles``; the file reloaded in a
     cleared state gives the same plans; engines under ``off``, ``seed``
     and ``measure`` answer and train bit for bit the same at B = 1, 8
     and 32; (c) the trace audit on the card (default and forced
     ``packed_vpu`` legs) against the port's golden; (d)
     ``reconfig_benchmark(small=False)``: steady, swap, train-swap and
     resynthesis times, launch counts from 0 just before.  The ``tuned``
     line reports them.

Pods over ``torch.distributed``:
 19. "pods": ``torch.cuda.device_count()`` NCCL ranks, rank 0 in this
     process, the others spawned (none on a one-card machine), all
     running ``pods_work``: the legacy training core at the MNIST
     CoTM's widths with the kernels (``dp_train_step`` over the data
     axis, 8 rows a rank, its first call timed apart from the median of
     three more, and a sequential step of 2 rows, counter streams, each
     against rank 0's CPU replay); ``ShardedTM`` over a
     ``clauses`` mesh (the training model, lfsr): two inferences and 4
     train steps equal the engine's own ``infer`` and ``train_step`` (at
     one card the unfused sharded front half against ``fused_step``),
     and an inference on a forced ``mxu`` engine; each stage a CUDA graph
     captured over NCCL and replayed, equal to an eager twin
     (``eager_engine``) bit for bit, launch counts included, with the
     host ms of both and each graph's capture ms and pool bytes; ``pod_stack`` of the
     serving roster (K=4) over a ``tenants`` mesh: 3 flushes and 2
     train steps equal ``api.stack``'s bank; ``api.serve(mesh=)``
     drains phase 13's 87 requests with answers equal to phase 13's.
     Launch counts from 0 before the pod path, read after it.  Then the
     TA update on the last of four clause windows of the roster's train
     shape (an eager KWS-6 Vanilla step at L=3200, R=4224: rows [3168,
     4224), ``row0`` = 3168): ``ta_update_sparse`` and ``ta_update``
     against their plain versions and the full-width launch's rows (two
     ``pod window`` rows of the kernels line, with the full width's
     ms); ``plan_for`` on the H100 budget for the roster and the
     training model, on this world and on 4 devices.  Every rank also
     runs ``runtime.compression``: ``compressed_psum`` (with and without
     error feedback) and ``exact_int8_psum`` over the data axis of the
     world, against a CPU reference of every rank's inputs (rtol 1e-6;
     the int8 sum exact).  The ``pods`` line reports them.

The legacy variants and the substrate:
 20. "legacy": ``feedback_fit`` at fig 7's config (MNIST-like, 784
     features, 128 clauses, 10 classes, T=24, s=5, threefry), sequential
     over 64 rows and batched over 1024 rows at batch 64, each with
     ``compute_backend="jnp"`` and ``"pallas"`` (the edge clause kernel
     a sequential datapoint, the dense one a batched step); ``conv_tm``
     at ``benchmarks/convtm_bench.py``'s config (8x8, patch 3, 48
     clauses, 3 classes, T=12, s=3): 16 steps of 32 translated-motif
     images, then ``predict`` on 128; ``regression_tm`` (128 clauses,
     T=128): 4 steps of 32 rows and ``predict``; ``TMHead`` at the system
     test's config (16 features x 4 thermometer bits, 32 clauses, 3
     classes, T=16, s=4): 12 ``train_batch`` calls of 32 and ``predict``;
     ``pool_backbone_features``; AdamW 5 steps on a dict tree in float32,
     bfloat16 and int8 moments.  All on the card (launch counts from 0
     just before, read just after) and again on the CPU: states, PRNGs,
     histories, stats and predictions equal, AdamW and the pooling within
     rtol 1e-6, atol 1e-6 (int8 moment codes equal); 64 edge and 16
     dense clause launches.  The ``legacy`` line reports host ms a step
     of each, and the kernels line gains the ``legacy`` rows: the edge
     clause kernel at B=1, R=128, W=49, the dense one at B=64, C=128,
     L=1568, and ``threefry_bits`` at a datapoint's TA draw (401,408
     words).

The ``examples/`` mirrors:
 21. "examples": the five ``examples/*_torch.py`` scripts' ``main`` on the
     card at their defaults, the JAX scripts' sizes (their assertions
     hold; launch counts from 0 just before, read just after), then at
     the CPU tests' small sizes on the card and on the CPU, whose
     returned numbers must be equal; the kernels line gains the
     quickstart's ``fused_step`` and ``ta_update_sparse`` rows (MNIST
     geometry, 256 clauses, batch 32).

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
refresh count on every step.  packed_clause_tile runs its violation
counts on the tensor cores: its operations are the m16n8k256 products
its tiles need on these inputs (K · ceil(B/8) · ceil(R/16) · ceil(W/8))
at the probe's measured rate, and its ``bound_ms_before`` is the LOP3
count at the integer rate.  ``lfsr_bits`` is bound by the larger of its
int64 words' bytes and one lane's chain of ``steps`` dependent Galois
steps, at the clocks per step that ``lfsr_chain_probe`` measures, over
the maximum SM clock.  ``threefry_bits`` is bound by the larger of its
int64 words' bytes and ``THREEFRY_OPS`` integer instructions a word at
the SM's issue rate, 128 a clock (its mix of adds, rotates and xors
spreads over more than one integer pipe, and ran above 64 a clock).  No
kernel here does float work.

Prints the card line, ``serving``, ``training``, ``conv``,
``scheduler``, ``threefry``, ``ref_path``, ``graphs``,
``served_graphs``, ``tuned``, ``pods`` and ``legacy`` JSON lines, a
``kernels`` JSON line and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the exit code is then non-zero.  Without a CUDA card,
or without the repository beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
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
THREEFRY_OPS = 74              # a threefry word: 20 rounds of add, rotate, xor
                               # (60), six two-add key injections (12), the
                               # output xor and shift (2)
ISSUE_PER_CLOCK_PER_SM = 128   # 4 schedulers x one warp instruction a clock:
                               # the most instructions an SM can issue; the
                               # threefry kernel's mix of adds (some as IMAD on
                               # the FMA pipe), rotates and xors runs above the
                               # 64 a clock of any one integer pipe
ROUNDS = 4                   # stacked flushes, each 4 tenants x 32 requests
EDGE = 4                     # single-datapoint requests per tenant
ITERS = 200                  # kernel calls per timing graph
N_TRAIN, N_TEST = 2048, 512  # MNIST-like rows for the training phases
EDGE_STEPS = 8               # partial_fit steps at B=1
CONV_PATCH, CONV_P = 10, 19 * 19   # 10x10 window on 28x28: 361 patches
N_CONV, N_CONV_TEST = 1024, 256    # conv fit rows (2 epochs of 32 steps)
CONV_ROUNDS = 2              # conv flushes, each 2 tenants x 32 requests


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
    ``module.name`` (a kernel wrapper as the ops module calls it), and of
    the first call at each shape of its tensor arguments (``by_shape``);
    the wrapper itself still runs and counts its launches.  Calls made
    while a CUDA graph is being captured are not recorded: their
    arguments are a graph's buffers, whose contents are not computed
    then (a capture runs no kernel).  ``clone``: record copies of the
    tensor arguments, made before the call (a wrapper that writes one of
    them in place leaves the record as it was called)."""

    def __init__(self, module, name: str, clone: bool = False):
        import torch
        self.torch = torch
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.clone = clone
        self.args = None
        self.by_shape = {}

    def __enter__(self):
        def record(*a, **kw):
            if self.torch.cuda.is_current_stream_capturing():
                return self.fn(*a, **kw)
            kept = (tuple(t.clone() if hasattr(t, "clone") else t
                          for t in a) if self.clone else a)
            self.args = (kept, kw)
            key = tuple(tuple(t.shape) for t in a if hasattr(t, "shape"))
            self.by_shape.setdefault(key, (kept, kw))
            return self.fn(*a, **kw)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def freeze(self) -> None:
        """Clone the tensors of the last call's positional arguments, so
        a later in-place write to their sources leaves them."""
        a, kw = self.args
        self.args = (tuple(t.clone() if hasattr(t, "clone") else t
                           for t in a), kw)


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


def profile_flush(torch, fn, captures: int = 1, need: str = "") -> dict:
    """One call of ``fn`` under torch.profiler: wall time, summed kernel
    time on the device, the device's busy share of the wall time, the
    eight longest kernels, the number of kernels launched and how many of
    them are ``fused_step``'s.  A capture that holds no device activity at
    all, or no kernel whose name holds ``need`` (the profiler now and then
    drops the activity of a call that launched kernels), is taken again
    with another call, up to ``captures`` calls; ``captures`` in the
    result counts them.  Dead CUDA graphs are collected first, so none is
    destroyed during a capture."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    for n in range(1, captures + 1):
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
        if kernels and any(need in k[0] for k in kernels):
            break
    dev_us = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3, "captures": n,
            "busy_share": (dev_us / 1e6) / wall if kernels else None,
            "launches": sum(k[2] for k in kernels),
            "fused_step_kernels": sum(k[2] for k in kernels
                                      if "fused_step" in k[0]),
            "kernels": [{"name": k[0][:60], "us": k[1], "count": k[2]}
                        for k in top]}


def b1_mma_per_s(torch, _build) -> float:
    """m16n8k256 .b1 products per second: ``b1_mma_probe`` on 2 blocks of
    8 warps an SM, each warp running its chains of back-to-back products,
    timed with CUDA events over 3 launches after a warm one."""
    import ctypes
    lib, fn = _build.entry("packed_clause", "dtm_b1_mma_probe",
                           [ctypes.c_void_p] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
    chains = _build.load("packed_clause").dtm_b1_mma_probe_chains()
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    warps, iters, reps = 8, 2048, 3
    out = torch.empty(blocks * warps * 32, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    for i in range(reps + 1):
        if i == 1:
            s.record()
        _build.check(lib, fn(out.data_ptr(), blocks, warps, iters, stream),
                     "dtm_b1_mma_probe")
    e.record()
    torch.cuda.synchronize()
    return blocks * warps * chains * iters * reps / (s.elapsed_time(e) * 1e-3)


def lfsr_step_clocks(torch, _build, taps: int) -> float:
    """Clocks of one dependent Galois step of an lfsr lane
    (``lfsr_chain_probe``: one warp, 2^16 steps between two clock64
    reads, after a warm launch)."""
    import ctypes
    lib, fn = _build.entry("lfsr", "dtm_lfsr_chain_probe",
                           [ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 3)
    iters = 1 << 16
    clocks = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.empty(32, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        _build.check(lib, fn(taps, iters, clocks.data_ptr(), sink.data_ptr(),
                             stream), "dtm_lfsr_chain_probe")
    torch.cuda.synchronize()
    return int(clocks) / iters


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


def percentile_ms(np, seconds, q: float):
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


# Phase 17: per stage, the replays of each graph alive after
# served_sequence on fresh engines (sorted).  Their number per stage is
# what the JAX engine's cache_report counts after the same calls
# (tests/test_torch_served_graphs.py runs the JAX package through
# served_sequence and holds its report to SERVED_CACHE).
SERVED_REPLAYS = {"infer": [9], "train": [3, 3, 4], "infer_conv": [1],
                  "infer_conv_bank_list": [1], "predict_bank_list": [3, 3],
                  "train_bank": [3]}
SERVED_CACHE = {s: len(r) for s, r in SERVED_REPLAYS.items()}


def served_sequence(srv, csrv, bank, reqs, trains, creqs, bank_lits,
                    bank_labels) -> list:
    """The served calls of phase 17, through either package's API (a
    ``TMServer`` and a ``ProgramBank`` of the JAX package or of the
    port).  ``srv`` hosts the flat tenants of ``reqs`` (one full batch
    slot each), ``csrv`` the conv tenants of ``creqs``; ``trains`` lists
    (tenant, x, y) steps; ``bank`` is a train-capable flat bank whose
    K differs from 2.  In order: three tenants' ``predict``; a resident
    roster of the first two and a flush of all four (the other two take
    the cold path); the train steps; a flush; a restack to the last two
    at the same K and a flush; three bank train steps, each followed by
    a flush of the bank; a conv ``predict`` and a conv flush.  Returns
    every answer and stats in call order."""
    names = list(reqs)
    out = [srv.predict(n, reqs[n]) for n in names[:3]]

    def flush():
        for n in names:
            srv.enqueue(n, reqs[n])
        out.append(srv.flush())

    srv.set_resident(names[:2])
    flush()
    out += [srv.train(n, x, y) for n, x, y in trains]
    flush()
    srv.set_resident(names[2:])
    flush()
    for _ in range(3):
        out.append(bank.train(bank_lits, bank_labels))
        out.append(bank.predict(bank_lits))
    cnames = list(creqs)
    out.append(csrv.predict(cnames[0], creqs[cnames[0]]))
    for n in cnames:
        csrv.enqueue(n, creqs[n])
    out.append(csrv.flush())
    return out


def scheduled_serving(torch, np, api, ops, datasets, roster, progs, cpu,
                      card: str, seed: int):
    """Phase 13: ``api.serve`` of the four paper models at full width
    behind the scheduler, with a durable directory, on the card.  Returns
    (report, the kernel launches of the scheduled path, the captures of
    its kernel calls, the scheduler of the live stack, (the drain's plan
    of rounds of (kind, tenant, x, y), its answers in submission order)).

    The launch counts run from 0 at the first scheduled request to the
    end of the fault stacks; the synchronous twins, the CPU round and
    the cold-started stack run after them."""
    import shutil
    import tempfile
    from repro_torch.launch.scheduler import (BATCH, GOLD, SchedulerConfig,
                                              TMScheduler)
    from repro_torch.launch.serve_tm import TMServer
    from repro_torch.runtime.fault import (FaultInjector, FaultPlan,
                                           InjectedFault)
    t_phase = time.perf_counter()
    B = 32
    names = list(roster)
    specs = {n: paper_spec(api, c, "lfsr") for n, (c, _) in roster.items()}
    slas = {"mnist_cotm": GOLD, "kws6_vanilla": BATCH}
    seeds = {n: seed + i for i, n in enumerate(names)}
    pool = {n: datasets.make_bool_dataset(task, 64 * B, seed=seed + 500 + i)
            for i, (n, (_, task)) in enumerate(roster.items())}
    cursor = {n: 0 for n in names}

    def request(n, size):
        """The next ``size`` rows of tenant n's request pool."""
        k = cursor[n] % 48
        cursor[n] += 1
        return pool[n][0][k * B:k * B + size]

    def train_rows(n, k):
        x, y = pool[n]
        return x[(56 + k) * B:(57 + k) * B], y[(56 + k) * B:(57 + k) * B]

    def register_motifs(srv_or_sched, **kw):
        for n in names:
            srv_or_sched.register(n, specs[n], program=progs[n],
                                  seed=seeds[n], **kw.get(n, {}))

    def twin(engine):
        srv = TMServer(engine, batch_slot=B)
        register_motifs(srv)
        return srv

    durable = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    cfg = SchedulerConfig(pipeline_depth=2, resident_slots=2,
                          membership_every=2, promote_margin=1.2,
                          ckpt_interval_s=0.05)
    sched = api.serve(specs, batch_slot=B, config=cfg, slas=slas, seed=seed,
                      durable_dir=durable)
    srv = sched.server
    eng = srv.engine
    check((eng.L, eng.R, eng.H, eng.W) == (3200, 4224, 16, 100),
          f"scheduled engine geometry {(eng.L, eng.R, eng.H, eng.W)}")
    register_motifs(sched, **{n: {"sla": slas.get(n)} for n in names})
    check(srv.resident_names(False) == names[:2],
          f"resident roster {srv.resident_names(False)}")

    # drain mode: 16 rounds of one 32- or 16-row request per tenant (the
    # hot tenant, KWS-6 CoTM, sends a second one), 4 training steps of
    # MNIST CoTM and one of every other tenant on the same cycles
    mn_trains = {1: 0, 5: 1, 9: 2, 13: 3}
    one_train = {"mnist_vanilla": 3, "kws6_cotm": 7, "kws6_vanilla": 11}
    plan = []
    for r in range(16):
        rnd = []
        for i, n in enumerate(names):
            if n == "mnist_cotm" and r in mn_trains:
                rnd.append(("train", n, *train_rows(n, mn_trains[r])))
            elif one_train.get(n) == r:
                rnd.append(("train", n, *train_rows(n, 0)))
            rnd.append(("infer", n, request(n, B if (r + i) % 2 == 0
                                            else B // 2), None))
            if n == "kws6_cotm":
                rnd.append(("infer", n, request(n, B // 2), None))
        plan.append(rnd)
    done_at = {}

    def stamp(key):
        return lambda _f: done_at.__setitem__(key, time.perf_counter())

    def submit(sch, kind, n, x, y, key, submitted):
        submitted[key] = time.perf_counter()
        fut = (sch.submit_train(n, x, y) if kind == "train"
               else sch.submit(n, x))
        fut.add_done_callback(stamp(key))
        return fut

    ops.reset_launch_counts()
    drain_sub, drain_futs, round_ms = {}, [], []
    t0 = time.perf_counter()
    for r, rnd in enumerate(plan):
        t_r = time.perf_counter()
        for j, (kind, n, x, y) in enumerate(rnd):
            drain_futs.append(submit(sched, kind, n, x, y,
                                     ("d", r, j), drain_sub))
        sched.drain()
        round_ms.append((time.perf_counter() - t_r) * 1e3)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    drain_graphs = eng.graph_report()     # captured in the drain
    drain_out = [f.result(timeout=60) for f in drain_futs]
    # the bank flushes, the cold path and train-while-serve all replay
    # graphs (a replay calls no wrapper): the kernel checks take their
    # arguments from eager calls of the engine's building blocks on the
    # live tenants' state, at the path's shapes (not counted): the
    # resident bank's inference (K=2), a cold tenant's (K=1) and a step
    # of MNIST CoTM on its last batch
    bank_names, bank_ = srv._bank_for(False)
    cold_name = next(n for n in names if n not in bank_names)
    mn = srv.tenants["mnist_cotm"]
    x_mn, y_mn = train_rows("mnist_cotm", mn_trains[max(mn_trains)])
    counted = ops.launch_counts()
    caps = {k: Capture(ops, k) for k in ("fused_step", "ta_update_sparse",
                                         "packed_clause_tile", "class_sum")}
    for c_ in caps.values():
        c_.__enter__()
    try:
        eng.predict_bank(bank_.progs, [
            eng.encode(specs[n], pool[n][0][:B]) for n in bank_names])
        eng.infer(srv.tenants[cold_name].program,
                  eng.encode(specs[cold_name], pool[cold_name][0][:B]))
        eng.train_step(mn.program, mn.prng, eng.encode(specs["mnist_cotm"],
                                                       x_mn),
                       specs["mnist_cotm"].encode_labels(y_mn).cuda())
        torch.cuda.synchronize()
    finally:
        for c_ in caps.values():
            c_.__exit__()
    ops.set_launch_counts(counted)

    # thread mode: 64 requests per tenant submitted open loop, the driver
    # and the checkpoint writer on their own threads
    thread_sub, thread_items, thread_futs = {}, [], []
    sched.start()
    try:
        check(sched.stats()["checkpoint"]["running"],
              "the checkpoint writer did not start with the driver")
        t0 = time.perf_counter()
        for j in range(64):
            for n in names:
                x = request(n, B)
                thread_items.append((n, x))
                thread_futs.append(submit(sched, "infer", n, x, None,
                                          ("t", j, n), thread_sub))
        thread_out = [f.result(timeout=120) for f in thread_futs]
        thread_s = max(done_at[k] for k in thread_sub) - t0
    finally:
        sched.stop()
    st = sched.stats()
    check(st["rejected"] == 0 and st["failed"] == 0,
          f"scheduled serving rejected {st['rejected']}, failed "
          f"{st['failed']}")

    # faults: transient launch faults at 3 indices (all tenants gold), then
    # a plan that exhausts a budget of 2 re-attempts
    fault_idx = (1, 3, 5)
    fsrv = twin(eng)
    fs = TMScheduler(fsrv, SchedulerConfig(retries=3), injector=FaultInjector(
        FaultPlan(fail={"launch": fault_idx})))
    xsrv = twin(eng)
    xs = TMScheduler(xsrv, SchedulerConfig(retries=2, max_batch_tenants=2),
                     injector=FaultInjector(FaultPlan(
                         fail={"launch": (0, 1, 2)})))
    for n in names:
        fs.set_sla(n, GOLD)
        xs.set_sla(n, GOLD)
    f_items, f_futs = [], []
    for r in range(4):
        for n in names:
            x = request(n, B)
            f_items.append((n, x))
            f_futs.append(fs.submit(n, x))
        fs.drain()
    x_items = [(n, request(n, B)) for n in names]
    x_futs = [xs.submit(n, x) for n, x in x_items]
    xs.drain()
    x_items2 = [(n, request(n, B)) for n in names]
    x_futs2 = [xs.submit(n, x) for n, x in x_items2]
    xs.drain()
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    # ---- checks against the synchronous twin (not counted) ---------------
    ref = twin(eng)
    want = {}
    for r, rnd in enumerate(plan):            # per tenant, in its order
        for j, (kind, n, x, y) in enumerate(rnd):
            want.setdefault(n, []).append((("d", r, j), kind, x, y))
    for j, (n, x) in enumerate(thread_items):
        want[n].append((("t", j // len(names), n), "infer", x, None))
    got = dict(zip([("d", r, j) for r, rnd in enumerate(plan)
                    for j in range(len(rnd))], drain_out))
    got.update(zip([k for k in thread_sub], thread_out))
    for n in names:
        for key, kind, x, y in want[n]:
            if kind == "train":
                w = ref.train(n, x, y)
                check(got[key]["applied"]
                      and {k: got[key][k] for k in w} == w,
                      f"scheduled training step {key} of {n} differs")
            else:
                ref.enqueue(n, x)
                check(np.array_equal(got[key], ref.flush()[n]),
                      f"scheduled answer {key} of {n} differs from the "
                      "synchronous flush")
    for n in names:
        a, b = srv.tenants[n], ref.tenants[n]
        check(a.steps == b.steps and same_state(torch, a.program, b.program)
              and same_state(torch, a.prng, b.prng),
              f"{n} after train-while-serve differs from sequential train")
    check(srv.tenants["mnist_cotm"].steps == 4, "MNIST CoTM trained "
          f"{srv.tenants['mnist_cotm'].steps} steps")
    # the first round against the CPU engine's answers
    cref = TMServer(cpu, batch_slot=B)
    register_motifs(cref)
    firsts = {}
    for j, (kind, n, x, _) in enumerate(plan[0]):
        if kind == "infer" and n not in firsts:
            firsts[n] = j
            cref.enqueue(n, x)
    cwant = cref.flush()
    for n, j in firsts.items():
        check(np.array_equal(got[("d", 0, j)], cwant[n]),
              f"scheduled answer of {n} differs from the CPU engine")
    answers = np.concatenate([np.asarray(v) for k, v in got.items()
                              if not isinstance(v, dict)])
    check(len(np.unique(answers)) > 1, "scheduled answers are all one class")
    check(srv.cold_requests > 0 and sched.promotions >= 1,
          f"cold requests {srv.cold_requests}, promotions "
          f"{sched.promotions}: the membership paths did not run")
    # faults
    fref = twin(eng)
    for (n, x), f in zip(f_items, f_futs):
        fref.enqueue(n, x)
        check(np.array_equal(f.result(timeout=60), fref.flush()[n]),
              f"{n} answer under transient faults differs")
    check(fs.retries == len(fault_idx) and fs.faults == 0
          and fs.failed == 0 and fs.completed == len(f_items)
          and fs.injector.stats()["injected"]["launch"] == len(fault_idx),
          f"transient faults: retries {fs.retries}, faults {fs.faults}, "
          f"failed {fs.failed}")
    failed = [n for (n, _), f in zip(x_items, x_futs)
              if isinstance(f.exception(timeout=60), InjectedFault)]
    check(failed == names[:2] and xs.faults == 1 and xs.failed == 2
          and not xsrv._pending,
          f"exhausted retries failed {failed}, faults {xs.faults}")
    for (n, x), f in list(zip(x_items, x_futs))[2:] + list(
            zip(x_items2, x_futs2)):
        fref.enqueue(n, x)
        check(np.array_equal(f.result(timeout=60), fref.flush()[n]),
              f"{n} answer after exhausted retries differs")

    # ---- crash and cold start ---------------------------------------------
    sched.checkpoint_now()
    ck = sched.stats()["checkpoint"]
    check(ck["failures"] == 0 and ck["dirty"] == 0
          and set(ck["last_saved"]) == set(names),
          f"checkpoint writer {ck}")
    nbytes = {}
    for n in names:
        d_ = os.path.join(durable, "tenants", n,
                          f"step_{ck['last_saved'][n]:08d}")
        nbytes[n] = sum(os.path.getsize(os.path.join(d_, f))
                        for f in os.listdir(d_))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = api.serve(None, durable_dir=durable)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    for n in names:
        a, b = srv.tenants[n], cold.server.tenants[n]
        check(a.steps == b.steps and same_state(torch, a.program, b.program)
              and same_state(torch, a.prng, b.prng),
              f"{n} cold-started differs from the live tenant")
    check(cold.sla_of("mnist_cotm").name == "gold"
          and cold.sla_of("kws6_vanilla").name == "batch",
          "cold start lost the SLAs")
    outs = []
    for stack in (sched, cold):
        futs = []
        for r in range(2):
            for n in names:
                x, y = train_rows(n, 4 + r)
                futs.append(stack.submit_train(n, x, y))
                futs.append(stack.submit(n, pool[n][0][r * B:(r + 1) * B]))
            stack.drain()
        outs.append([f.result(timeout=60) for f in futs])
    for u, v in zip(*outs):
        check(u == v if isinstance(u, dict) else np.array_equal(u, v),
              "the cold-started stack continues differently")
    for n in names:
        a, b = srv.tenants[n], cold.server.tenants[n]
        check(a.steps == b.steps and same_state(torch, a.program, b.program)
              and same_state(torch, a.prng, b.prng),
              f"{n} after the continuation differs between the stacks")

    # one scheduled cycle: a request per tenant, launched and collected
    cyc = {n: pool[n][0][:B] for n in names}

    def cycle():
        for n in names:
            sched.submit(n, cyc[n])
        sched.drain()
    cycle_prof = profile_flush(torch, cycle, captures=3)
    shutil.rmtree(durable, ignore_errors=True)

    def lat(sub, skip_first=False):
        """Submit-to-result seconds; ``skip_first``: without the first
        round (drain) or the first request of each tenant (thread mode),
        whose cycles may capture a graph."""
        return [done_at[k] - t for k, t in sub.items()
                if not (skip_first and k[1] == 0)]
    n_drain = sum(len(rnd) for rnd in plan)
    report = {
        "card": card, "tenants": names, "batch_slot": B,
        "engine": {"L": eng.L, "R": eng.R, "H": eng.H, "W": eng.W},
        "slas": {n: sched.sla_of(n).name for n in names},
        "resident_slots": 2, "pipeline_depth": 2,
        "drain": {"requests": n_drain, "seconds": drain_s,
                  "requests_per_s": n_drain / drain_s,
                  "latency_ms_p50": percentile_ms(np, lat(drain_sub), 50),
                  "latency_ms_p99": percentile_ms(np, lat(drain_sub), 99),
                  "latency_ms_p50_after_first": percentile_ms(
                      np, lat(drain_sub, True), 50),
                  "latency_ms_p99_after_first": percentile_ms(
                      np, lat(drain_sub, True), 99),
                  "round_ms": round_ms, "graphs": drain_graphs},
        "thread": {"requests": len(thread_items), "seconds": thread_s,
                   "requests_per_s": len(thread_items) / thread_s,
                   "latency_ms_p50": percentile_ms(np, lat(thread_sub), 50),
                   "latency_ms_p99": percentile_ms(np, lat(thread_sub), 99),
                   "latency_ms_p50_after_first": percentile_ms(
                       np, lat(thread_sub, True), 50),
                   "latency_ms_p99_after_first": percentile_ms(
                       np, lat(thread_sub, True), 99)},
        "launches": st["launches"], "trains": st["trains"],
        "cold_requests": st["server"]["cold_requests"],
        "membership_swaps": st["server"]["membership_swaps"],
        "promotions": st["promotions"], "demotions": st["demotions"],
        "resident_after": st["server"]["resident"],
        "faults": {"transient_at": list(fault_idx), "retries": fs.retries,
                   "exhausted_failed": failed},
        "checkpoint_save_ms": ck["save_ms"], "checkpoint_bytes": nbytes,
        "checkpoint_saves": ck["saves"], "cold_start_ms": cold_ms,
        "cycle_profile": cycle_prof, "kernel_launches": counts,
        "phase_s": time.perf_counter() - t_phase}
    return report, counts, caps, sched, (plan, drain_out)


def threefry_phase(torch, np, api, ops, tm_paper, eng, eng_cpu, x_tr, y_tr,
                   card: str, seed: int):
    """Phase 14: the MNIST CoTM at full width with ``prng_backend=
    "threefry"`` on the training engine (L=1664, R=2048, H=16, W=52).
    Returns (report, the launches of its main paths, the kernel's largest
    difference from its plain version, the keys its kernel row times)."""
    from repro_torch.core import threefry
    from repro_torch.core.dtm import STAT_KEYS
    from repro_torch.core.prng import PRNG
    from repro_torch.kernels.threefry import threefry_bits, threefry_bits_plain
    t_phase = time.perf_counter()
    spec = paper_spec(api, tm_paper.TM_MNIST_COTM, "threefry")
    spec_v = paper_spec(api, tm_paper.TM_MNIST_VANILLA, "threefry")
    cfg = spec.tm_config()
    rows, lits = cfg.total_clauses, cfg.literals
    sel = 2 * 32 * eng.R

    # the program draw on the card, timed, and the CPU engine's
    lower_s = []
    for _ in range(5):
        t = time.perf_counter()
        prog = eng.lower(spec, threefry.key(seed, "cuda"))
        torch.cuda.synchronize()
        lower_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    prog_cpu = eng_cpu.lower(spec, threefry.key(seed, "cpu"))
    lower_cpu_s = time.perf_counter() - t
    check(same_state(torch, prog, prog_cpu),
          "the card's program draw differs from the CPU engine's")
    tm = api.TM(spec, engine=eng, seed=seed)
    p0, r0 = tm.program.to("cpu"), tm.prng.to("cpu")
    check(same_state(torch, tm.program, prog)
          and same_state(torch, r0, PRNG.create(cfg, seed + 1, device="cpu")),
          "TM(spec, seed) did not lower from PRNGKey(seed)")

    # the kernel against its plain version: the flat step's three draws
    # from the fit's starting key, the program draw (TA words without the
    # split, the weights' with it), a K=2 bank, sizes off the block, word
    # widths and seeds past 32 bits and below zero
    k_fit = tm.prng.state[None]
    k_prog = threefry.key(seed, "cuda")[None]
    k_ta = threefry.split(k_prog)[0]
    cases = [(k_fit, n_, 16, True) for n_ in (32, sel, 2)]
    cases += [(k_ta, rows * lits, 1, False),
              (k_prog, cfg.classes * cfg.clauses, 1, True),
              (torch.stack([threefry.key(seed + k, "cuda") for k in (0, 1)]),
               sel, 16, True)]
    for s_ in (0, 1, -5, 2 ** 32 + 5):
        for n_ in (1, 255, 1025):
            for rb in (8, 16, 32):
                cases.append((threefry.key(s_, "cuda")[None], n_, rb, True))
    err = 0
    for keys, size, rb, split in cases:
        got = threefry_bits(keys, size, rb, split)
        want = threefry_bits_plain(keys, size, rb, split)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"threefry_bits differs from its plain version at keys "
                  f"{tuple(keys.shape)} size {size} rand_bits {rb} split "
                  f"{split}")
            err = max(err, int((g - w).abs().max()) if g.numel() else 0)

    # the fit (counts from 0 just before, read just after)
    ops.reset_launch_counts()
    t = time.perf_counter()
    hist = tm.fit(x_tr, y_tr, epochs=2, batch=32,
                  rng=np.random.default_rng(seed), sync_guard=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts_fit = ops.launch_counts()
    steps = 2 * (len(x_tr) // 32)
    check(counts_fit["fused_step"] == steps
          and counts_fit["ta_update_sparse"] == steps
          and counts_fit["step_prologue"] == steps
          and counts_fit["step_epilogue"] == steps
          and counts_fit["threefry_bits"] == 3 * steps
          and counts_fit["lfsr_bits"] == 0,
          f"the threefry fit launched {counts_fit}")
    paths = eng.cache_report()["path_per_stage"]
    check({k: paths[k] for k in ("train", "train_ta", "train_prng")} == {
        "train": "fused", "train_ta": "compact",
        "train_prng": "counter-inkernel"}, f"threefry fit paths {paths}")
    check(hist[-1]["train_acc"] > 1.0 / spec.classes,
          f"threefry fit accuracy {hist[-1]['train_acc']}")
    plan = np.random.default_rng(seed).permutation(len(x_tr)).reshape(-1, 32)
    pg, rg, pc, rc = p0.to("cuda"), r0.to("cuda"), p0, r0
    for s_ in range(2):
        xb, lab = x_tr[plan[s_]], spec.encode_labels(y_tr[plan[s_]])
        pg, rg, sg = eng.train_step(pg, rg, eng.encode(spec, xb), lab.cuda())
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec, xb), lab)
        check(same_state(torch, pg, pc) and same_state(torch, rg, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"threefry fit step {s_} on the card differs from the CPU "
              "engine")

    # edge: 4 partial_fit steps at B=1, each against the CPU engine
    tm_e = api.TM(spec, engine=eng, seed=seed + 1)
    pc, rc = tm_e.program.to("cpu"), tm_e.prng.to("cpu")
    ops.reset_launch_counts()
    for i in range(4):
        xb, yb = x_tr[i:i + 1], y_tr[i:i + 1]
        sg = tm_e.partial_fit(xb, yb)
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec, xb),
                                        spec.encode_labels(yb))
        check(same_state(torch, tm_e.program, pc)
              and same_state(torch, tm_e.prng, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"threefry edge step {i} differs from the CPU engine")
    counts_edge = ops.launch_counts()
    check(counts_edge["packed_clause_eval"] == 4
          and counts_edge["threefry_bits"] == 12
          and counts_edge["ta_update_sparse"] == 4,
          f"threefry edge training launched {counts_edge}")

    # bank: MNIST CoTM + MNIST Vanilla, K=2, lowered on the card from keys
    b_specs = (spec, spec_v)
    b_progs = [eng.lower(sp, threefry.key(seed + 2 + k, "cuda"))
               for k, sp in enumerate(b_specs)]
    b_prngs = [PRNG.create(sp.tm_config(), seed + 4 + k, device="cuda")
               for k, sp in enumerate(b_specs)]
    bank = api.stack(b_progs, eng, prngs=b_prngs)
    cpu_bank = api.stack([q.to("cpu") for q in b_progs], eng_cpu,
                         prngs=[q.to("cpu") for q in b_prngs])
    b_lits = torch.stack([eng.encode(sp, x_tr[32 * k:32 * (k + 1)])
                          for k, sp in enumerate(b_specs)])
    b_y = np.stack([y_tr[32 * k:32 * (k + 1)] for k in range(2)])
    ops.reset_launch_counts()
    bst = bank.train(b_lits, b_y)
    counts_bank = ops.launch_counts()
    check(counts_bank["fused_step"] == 1 and counts_bank["ta_update"] == 1
          and counts_bank["threefry_bits"] == 3,
          f"the threefry bank step launched {counts_bank}")
    cst = cpu_bank.train(b_lits.cpu(), b_y)
    check(same_state(torch, bank.progs, cpu_bank.progs)
          and same_state(torch, bank.prngs, cpu_bank.prngs)
          and all(torch.equal(bst[k].cpu(), cst[k]) for k in STAT_KEYS),
          "the threefry bank step on the card differs from the CPU engine")

    # the step's host time and one profiled step, from the fit's end
    lits32 = eng.encode(spec, x_tr[:32])
    lab32 = spec.encode_labels(y_tr[:32]).cuda()
    step_s = []
    for _ in range(10):
        t = time.perf_counter()
        eng.train_step(tm.program, tm.prng, lits32, lab32)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    prof = profile_flush(torch, lambda: eng.train_step(
        tm.program, tm.prng, lits32, lab32), captures=3)
    report = {
        "card": card, "model": "MNIST CoTM (784 f, 2000 clauses, 10 "
        "classes, T=500, s=10, ta_bits 8), prng_backend threefry",
        "engine": {"L": eng.L, "R": eng.R, "H": eng.H, "W": eng.W},
        "kernel_cases": len(cases), "fit_s": fit_s,
        "steps_per_s": steps / fit_s,
        "train_acc": [h["train_acc"] for h in hist],
        "step_ms_median": float(np.median(step_s) * 1e3),
        "step_ms": [s_ * 1e3 for s_ in step_s], "step_profile": prof,
        "lower_ms": [s_ * 1e3 for s_ in lower_s],
        "lower_ms_median_after_first": float(np.median(lower_s[1:]) * 1e3),
        "lower_cpu_ms": lower_cpu_s * 1e3,
        "launches": {"fit": counts_fit, "edge": counts_edge,
                     "bank": counts_bank},
        "phase_s": time.perf_counter() - t_phase}
    launches = sum(c["threefry_bits"] for c in (counts_fit, counts_edge,
                                                 counts_bank))
    return report, launches, err, {"fit": k_fit, "prog": k_prog, "ta": k_ta,
                                   "sel": sel, "ta_words": rows * lits,
                                   "w_words": cfg.classes * cfg.clauses}


def ref_phase(torch, np, api, ops, tile, server, reqs, want_answers, eng,
              p0, r0, spec, x_tr, y_tr, bank_start, bank_end, card: str):
    """Phase 15: the forced plain datapath, ``compile(kernel_path="ref")``,
    on the card: one stacked flush of the serving roster (K=4, B=32,
    L=3200, R=4224), 8 train steps of phase 7's model from its starting
    program and PRNG and one K=2 bank step, each against the default
    engine's.  The counts run from 0 at the flush to the bank step: no
    clause or TA kernel may launch, the PRNG's still do."""
    from repro_torch.core.dtm import STAT_KEYS
    t_phase = time.perf_counter()
    B, n_steps = 32, 8
    plan = np.random.default_rng(7).permutation(len(x_tr))[:n_steps * B]
    batches = [(eng.encode(spec, x_tr[ib]), spec.encode_labels(
        y_tr[ib]).cuda()) for ib in plan.reshape(n_steps, B)]
    # the default engine's steps first, outside the counted window
    want = []
    pg, rg = p0.to("cuda"), r0.to("cuda")
    for lits_, lab_ in batches:
        pg, rg, st = eng.train_step(pg, rg, lits_, lab_)
        want.append((pg, rg, st))
    ref_serve = api.compile(tile, device="cuda", kernel_path="ref")
    ref_train = api.compile(eng.tile, device="cuda", kernel_path="ref")
    srv = server(ref_serve, B)
    (b_progs, b_prngs, b_lits, b_y), (bank_progs, bank_prngs, bst) = \
        bank_start, bank_end
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for n, x in reqs.items():
        srv.enqueue(n, x[:B])
    t = time.perf_counter()
    got = srv.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t
    for n in reqs:
        check(np.array_equal(got[n], want_answers[n]),
              f"the ref flush's answers of {n} differ from the default's")
    pg, rg = p0.to("cuda"), r0.to("cuda")
    step_s = []
    for s_, (lits_, lab_) in enumerate(batches):
        t = time.perf_counter()
        pg, rg, st = ref_train.train_step(pg, rg, lits_, lab_)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        wp, wr, ws = want[s_]
        check(same_state(torch, pg, wp) and same_state(torch, rg, wr)
              and all(int(st[k]) == int(ws[k]) for k in STAT_KEYS),
              f"ref step {s_} differs from the default engine's")
    rbank = api.stack(b_progs, ref_train, prngs=b_prngs)
    t = time.perf_counter()
    rst = rbank.train(b_lits, b_y)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t
    counts = ops.launch_counts()
    check(same_state(torch, rbank.progs, bank_progs)
          and same_state(torch, rbank.prngs, bank_prngs)
          and all(torch.equal(rst[k], bst[k]) for k in STAT_KEYS),
          "the ref bank step differs from the default engine's")
    kernels = ("packed_clause_eval", "packed_clause_tile", "class_sum",
               "fused_step", "ta_update", "ta_update_sparse", "clause_eval",
               "tm_infer", "ta_update_streamed", "step_prologue",
               "step_epilogue")
    check(all(counts[k] == 0 for k in kernels)
          and counts["lfsr_bits"] == 3 * n_steps,
          f"the ref phase launched {counts}")
    paths = {**ref_serve.cache_report()["path_per_stage"],
             **ref_train.cache_report()["path_per_stage"]}
    check(paths == {"infer_bank": "ref", "train": "ref",
                    "train_ta": "compact", "train_prng": "lfsr-inkernel",
                    "train_bank": "ref", "train_bank_ta": "dense",
                    "train_bank_prng": "counter-inkernel"},
          f"ref paths {paths}")
    return {"card": card, "flush_ms": flush_s * 1e3,
            "step_ms": [s_ * 1e3 for s_ in step_s],
            "step_ms_median": float(np.median(step_s) * 1e3),
            "bank_step_ms": bank_s * 1e3, "launches": counts,
            "path_per_stage": paths,
            "phase_s": time.perf_counter() - t_phase}


def graphs_phase(torch, np, api, ops, fits, edge, flat, conv_flat,
                 scheduled, card: str, seed: int):
    """Phase 16: the session and bank executables as CUDA graphs.

    ``fits``: (name, engine, spec, x, y) of the six fits (compacted,
    skip-off, ``mxu``, streamed, conv, threefry); each runs as ``TM.fit``
    (2 epochs of 32-row batches, replayed, under
    ``set_sync_debug_mode("error")``) and as the eager chain of the
    engine's step from the same program, PRNG and shuffle: programs,
    PRNGs and histories must be equal, the first epoch's per-step stats
    from ``_fit_epoch_impl`` equal the chain's, the launch counts of that
    epoch equal steps × its graph's counts, and the program and PRNG the
    caller held must not change.  ``edge``: (engine, spec, x, y, conv
    engine, conv spec, conv images, labels): ``partial_fit`` steps
    (flat B=1, conv B=1) against the eager step.  ``flat``: (tile,
    specs, programs, requests) of the serving roster, ``conv_flat``:
    (conv tile, spec, programs, requests): stacked flushes on fresh
    engines across three ``swap_in`` calls and a ``swap_resident``
    against the eager bank inference, with ``cache_report`` at 1 a
    stage.  ``scheduled``: (phase 13's profiled cycle, its scheduler,
    one request a tenant): 20 cycles timed without the profiler.  Times: host ms a replayed step, epoch s, steps/s, fit s,
    capture ms a graph, the eager chain's ms a step, the device time of
    an epoch from CUDA events with the host held off by a sleep kernel
    (so the events read device time) against the epoch's host time,
    flush and ``partial_fit`` wall ms against eager."""
    from repro_torch.core.dtm import STAT_KEYS
    from repro_torch.core.evaluate import epoch_record
    from repro_torch.launch.serve_tm import TMServer
    t_phase = time.perf_counter()
    B = 32
    report = {"card": card, "fits": {}, "graphs": []}

    def tagged(engine, label):
        return [{"engine": label, **g} for g in engine.graph_report()]

    for name, e, spec, x, y in fits:
        conv = spec.kind == "conv"
        tm = api.TM(spec, engine=e, seed=seed)
        p0, r0 = tm.program, tm.prng
        held = [t.clone() for t in p0.leaves() + r0.leaves()]
        torch.cuda.synchronize()
        t = time.perf_counter()
        hist = tm.fit(x, y, epochs=2, batch=B,
                      rng=np.random.default_rng(seed), sync_guard=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        check(all(torch.equal(a, b) for a, b in zip(
            held, p0.leaves() + r0.leaves())),
            f"the {name} fit changed the program or PRNG its caller held")
        # the eager chain: the engine's step in a loop, same shuffle
        lits, lab = e.encode(spec, x), spec.encode_labels(y).cuda()
        n = len(x) - len(x) % B
        steps = n // B
        step_fn = e.train_conv if conv else e.train_step
        rng = np.random.default_rng(seed)
        p, r, rows, recs = p0, r0, [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for ep in range(2):
            idx = torch.from_numpy(rng.permutation(len(x))[:n].reshape(
                steps, B)).cuda()
            ep_rows = []
            for ib in idx:
                p, r, st = step_fn(p, r, lits.index_select(0, ib),
                                   lab.index_select(0, ib))
                ep_rows.append(torch.stack([st[k] for k in STAT_KEYS]))
            per = torch.stack(ep_rows).cpu().numpy()
            recs.append(epoch_record(ep, {
                k: int(per[:, i].sum(dtype=np.int64))
                for i, k in enumerate(STAT_KEYS)}, n, None))
            rows.append(torch.stack(ep_rows))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t
        check(same_state(torch, tm.program, p)
              and same_state(torch, tm.prng, r) and hist == recs,
              f"the replayed {name} fit differs from the eager chain")
        # the first epoch again through _fit_epoch_impl: per-step stats
        # and launch counts (counts from 0 just before)
        impl = e._fit_epoch_conv_impl if conv else e._fit_epoch_impl
        idx0 = np.random.default_rng(seed).permutation(len(x))[:n].reshape(
            steps, B)
        ops.reset_launch_counts()
        t = time.perf_counter()
        p1, r1, st1 = impl(p0, r0, lits, lab, idx0, sync_guard=True)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        counts = ops.launch_counts()
        graph = next(g_ for g_ in e._graphs.values()
                     if g_.stage.startswith("fit_epoch")
                     and g_.holds("data", lits, lab))
        check(torch.equal(st1, rows[0]), f"the {name} epoch's per-step "
              "stats differ from the eager chain's")
        check(all(counts[k] == steps * graph.launches.get(k, 0)
                  for k in counts) and counts["lfsr_bits"]
              + counts["threefry_bits"] > 0,
              f"the {name} epoch launched {counts}, not {steps} x "
              f"{graph.launches}")
        # device time of that epoch, the host held off by a sleep kernel
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        impl(p0, r0, lits, lab, idx0)
        ev[1].record()
        torch.cuda.synchronize()
        dev_ms = ev[0].elapsed_time(ev[1])
        report["fits"][name] = {
            "steps_per_epoch": steps, "fit_s": fit_s,
            "steps_per_s": 2 * steps / fit_s,
            "host_ms_per_replayed_step": host_ms / steps,
            "eager_ms_per_step": eager_s * 1e3 / (2 * steps),
            "epoch_device_ms": dev_ms,
            "busy_share": dev_ms / host_ms,
            "launches_per_step": graph.launches}

    # edge partial_fit: flat and conv, B=1, against the eager step
    e, spec, x, y, ec, spec_c, xc, yc = edge
    edge_rep = {}
    for label, eng_, sp, xs, ys, n_steps in (("flat", e, spec, x, y, 8),
                                             ("conv", ec, spec_c, xc, yc, 3)):
        tm = api.TM(sp, engine=eng_, seed=seed + 1)
        p, r = tm.program, tm.prng
        step_fn = eng_.train_conv if sp.kind == "conv" else eng_.train_step
        fit_ms, eager_ms = [], []
        for i in range(n_steps):
            xb, yb = xs[i:i + 1], ys[i:i + 1]
            torch.cuda.synchronize()
            t = time.perf_counter()
            sg = tm.partial_fit(xb, yb)
            torch.cuda.synchronize()
            fit_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            p, r, se = step_fn(p, r, eng_.encode(sp, xb),
                               sp.encode_labels(yb).cuda())
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t) * 1e3)
            check(same_state(torch, tm.program, p)
                  and same_state(torch, tm.prng, r)
                  and all(int(sg[k]) == int(se[k]) for k in STAT_KEYS),
                  f"{label} partial_fit step {i} differs from the eager "
                  "step")
        edge_rep[label] = {"partial_fit_ms": fit_ms,
                           "partial_fit_ms_median_after_first":
                               float(np.median(fit_ms[1:])),
                           "eager_step_ms_median_after_first":
                               float(np.median(eager_ms[1:]))}
    report["edge"] = edge_rep

    # stacked flushes on fresh engines, across swaps
    def flushes(label, tile, specs, progs, reqs, conv):
        g = api.compile(tile)
        srv = TMServer(g, batch_slot=B)
        names = list(progs)
        for n_ in names:
            srv.register(n_, specs[n_], program=progs[n_])
        stage = "infer_conv_bank_list" if conv else "predict_bank_list"
        lits = {n_: g.encode(specs[n_], reqs[n_][:B]) for n_ in names}
        wall, eager = [], []

        def one():
            for n_ in srv.resident_names(conv):
                srv.enqueue(n_, lits[n_], encoded=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = srv.flush()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
            bn, bank = srv._bank_for(conv)
            t = time.perf_counter()
            want = (g.infer_conv_bank if conv else g.predict_bank)(
                bank.progs, [lits[n_] for n_ in bn])
            [w.cpu() for w in want]
            eager.append((time.perf_counter() - t) * 1e3)
            out = bank.infer([lits[n_] for n_ in bn]) if conv else \
                bank.predict([lits[n_] for n_ in bn])
            check(all(torch.equal(a, b) for a, b in zip(out, want)),
                  f"the {label} flush graph differs from the eager bank")
            check(g.cache_report()[stage] == 1,
                  f"{label} flush graphs {g.cache_report()}")
            return got

        for _ in range(3):
            one()
        swaps = [(names[0], progs[names[1]]), (names[1], progs[names[0]]),
                 (names[0], progs[names[0]])]
        for n_, prog in swaps:          # three in-place slot writes
            srv.swap_in(n_, prog)
            one()
        if len(names) > 2:              # a resident roster, then a swap
            srv.set_resident(names[:2], conv=conv)
            one()
            srv.swap_resident(names[1], names[2])
            one()
        return {"flush_ms": wall, "eager_ms": eager,
                "flush_ms_median_after_first": float(np.median(wall[1:])),
                "eager_ms_median_after_first": float(np.median(eager[1:])),
                "graphs": tagged(g, label)}

    report["flush"] = flushes("flat", *flat, conv=False)
    report["flush_conv"] = flushes("conv", *conv_flat, conv=True)
    cycle_profile, sched, cyc = scheduled
    cycle_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for n_, x_ in cyc.items():
            sched.submit(n_, x_)
        sched.drain()
        torch.cuda.synchronize()
        cycle_ms.append((time.perf_counter() - t) * 1e3)
    report["scheduled_cycle"] = {
        "host_ms": cycle_ms,
        "host_ms_median_after_first": float(np.median(cycle_ms[1:])),
        "profiled": {k: cycle_profile[k] for k in (
            "wall_ms", "device_ms", "busy_share", "launches")}}
    seen = set()
    for name, e, *_ in fits:          # each engine's graphs once
        if id(e) not in seen:
            seen.add(id(e))
            report["graphs"] += tagged(e, name)
    report["phase_s"] = time.perf_counter() - t_phase
    return report


def eager_engine(engine):
    """``engine`` with its graphs off: every graph body runs eagerly on
    the card, the chain of launches a replay stands for (phase 17's and
    the card tests' reference)."""
    engine.__class__ = type("EagerDTMEngine", (type(engine),),
                            {"graphed": False})
    return engine


def same_answer(torch, np, a, b) -> bool:
    """Equality of two served answers or stats: arrays, tensors, ints,
    and dicts or tuples of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            same_answer(torch, np, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(
            same_answer(torch, np, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return np.array_equal(np.asarray(a), np.asarray(b))


def served_graphs_phase(torch, np, api, ops, datasets, roster, progs, conv,
                        sched, card: str, seed: int):
    """Phase 17: the served stage executables as CUDA graphs, on fresh
    engines at full width.

    The serving roster (``roster``, the motif ``progs`` of phase 2) with
    PRNG backends lfsr, counter, threefry and lfsr, the conv tenants of
    ``conv`` (tile, spec, programs, requests) and a K=3 bank of three
    roster programs with counter PRNGs go through
    :func:`served_sequence` twice: on engines that replay graphs (the
    launch counts from 0 just before, read just after) and on their
    eager twins (:func:`eager_engine`).  Every answer, train step and
    bank step, every tenant's program, PRNG and steps and the bank's
    programs and PRNGs must be equal; the bank's program and PRNG
    tensors keep their objects and storage; the programs a caller held
    do not change; ``cache_report`` is :data:`SERVED_CACHE` (JAX's after
    the same calls) and each graph's replays :data:`SERVED_REPLAYS` (a
    flush after a bank train step or a restack at an unchanged K that
    captured anew would leave a graph of fewer replays); the counts are
    the replays times each graph's captured counts.  Then host ms beside
    the eager twin, in the same call: ``predict`` (flat, conv), a
    cold-path request, ``TMServer.train`` (lfsr, threefry),
    ``ProgramBank.train`` at K=2, the first flush after a bank train
    step and after a restack at an unchanged K (and, once, at a new K,
    which captures); capture ms and pool bytes per graph; and 20
    scheduled cycles of phase 13's scheduler (``sched``) with and
    without a train request, broken down into encode, bank replay, cold
    path, the rest of the flush, train, collect and the scheduler's own
    time (the cycle's time less the server calls')."""
    from repro_torch.core.prng import PRNG
    from repro_torch.launch.serve_tm import TMServer
    t_phase = time.perf_counter()
    B = 32
    names = list(roster)
    backends = dict(zip(names, ("lfsr", "counter", "threefry", "lfsr")))
    specs = {n: paper_spec(api, c, backends[n])
             for n, (c, _) in roster.items()}
    ctile, cspec, cprogs, creqs_all = conv
    pool = {n: datasets.make_bool_dataset(task, 16 * B, seed=seed + 600 + i)
            for i, (n, (_, task)) in enumerate(roster.items())}

    def rows(n, k):
        x, y = pool[n]
        return x[k * B:(k + 1) * B], y[k * B:(k + 1) * B]

    reqs = {n: rows(n, 0)[0] for n in names}
    order = names[:3]                    # lfsr, counter, threefry
    trains = [(n, *rows(n, 1 + k))
              for k, n in enumerate(order * 3 + order[:1])]
    creqs = {n: creqs_all[n][:B] for n in cprogs}
    bspecs = [paper_spec(api, roster[n][0], "counter") for n in order]

    def build(eng, ceng, members):
        srv = TMServer(eng, batch_slot=B)
        for i, n in enumerate(names):
            srv.register(n, specs[n], program=progs[n], seed=seed + i)
        csrv = TMServer(ceng, batch_slot=B)
        for i, n in enumerate(cprogs):
            csrv.register(n, cspec, program=cprogs[n], seed=seed + 10 + i)
        bank = api.stack([progs[n] for n in members], eng, prngs=[
            PRNG.create(bspecs[k].tm_config(), seed + 20 + k,
                        device=eng.device)
            for k in range(len(members))])
        lits = torch.stack([eng.encode(bspecs[k], rows(n, 12)[0])
                            for k, n in enumerate(members)])
        labels = np.stack([rows(n, 12)[1] for n in members])
        return srv, csrv, bank, lits, labels

    tile = api.tile_for(*specs.values())
    eng, ceng = api.compile(tile), api.compile(ctile)
    e_eng, e_ceng = (eager_engine(api.compile(tile)),
                     eager_engine(api.compile(ctile)))
    srv, csrv, bank, blits, blabels = build(eng, ceng, order)
    t_srv, t_csrv, t_bank, _, _ = build(e_eng, e_ceng, order)
    bank_objs = (bank.progs, bank.prngs)
    bank_ptrs = [t.data_ptr() for t in bank.progs.leaves()
                 + bank.prngs.leaves()]
    held = {n: (srv.tenants[n].program,
                [t.clone() for t in srv.tenants[n].program.leaves()])
            for n in names}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = served_sequence(srv, csrv, bank, reqs, trains, creqs, blits,
                          blabels)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    want = served_sequence(t_srv, t_csrv, t_bank, reqs, trains, creqs,
                           blits, blabels)
    torch.cuda.synchronize()
    eager_seq_s = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(got, want)):
        check(same_answer(torch, np, g, w),
              f"served call {i}: the replay differs from the eager chain")
    check(len(got) == len(want) == 24, f"{len(got)} served calls")
    for a_srv, b_srv in ((srv, t_srv), (csrv, t_csrv)):
        for n, a in a_srv.tenants.items():
            b = b_srv.tenants[n]
            check(a.steps == b.steps
                  and same_state(torch, a.program, b.program)
                  and same_state(torch, a.prng, b.prng),
                  f"{n} after the served calls differs from the eager twin")
    check(same_state(torch, bank.progs, t_bank.progs)
          and same_state(torch, bank.prngs, t_bank.prngs),
          "the bank after three replayed train steps differs from eager")
    check((bank.progs, bank.prngs) == bank_objs and bank_ptrs == [
        t.data_ptr() for t in bank.progs.leaves() + bank.prngs.leaves()],
        "ProgramBank.train rebound the bank's program or PRNG tensors")
    for n, (p_, c_) in held.items():
        check(all(torch.equal(a, b) for a, b in zip(p_.leaves(), c_)),
              f"a program of {n} held before the calls changed")
    graphs = [g for e in (eng, ceng) for s_ in e._captured.values()
              for g in s_]
    cache = {s_: eng.cache_report()[s_] + ceng.cache_report()[s_]
             for s_ in SERVED_CACHE}
    others = {k: v for e in (eng, ceng) for k, v in e.cache_report().items()
              if k not in SERVED_CACHE and k != "path_per_stage" and v}
    check(cache == SERVED_CACHE and not others,
          f"cache_report {cache} {others}, JAX's {SERVED_CACHE}")
    replays = {}
    for g in graphs:
        replays.setdefault(g.stage, []).append(g.replays)
    replays = {k: sorted(v) for k, v in replays.items()}
    check(replays == SERVED_REPLAYS,
          f"replays per graph {replays}, not {SERVED_REPLAYS}: a graph "
          "was captured anew")
    expect = {}
    for g in graphs:
        for k, v in g.launches.items():
            expect[k] = expect.get(k, 0) + v * g.replays
    check({k: v for k, v in counts.items() if v} == expect,
          f"served launches {counts}, the replays' captured {expect}")
    check(all(v == 0 for e in (e_eng, e_ceng)
              for k, v in e.cache_report().items() if k != "path_per_stage"),
          "the eager twin captured a graph")
    cache_checked = {**{k: v for k, v in eng.cache_report().items()
                        if k != "path_per_stage"}}

    # ---- host ms beside the eager twin, in the same call ----------------
    def host_ms(fn, n: int = 12):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    def pair(live, eager, n: int = 12):
        a, b = host_ms(live, n), host_ms(eager, n)
        return {"replay_ms": a, "eager_ms": b,
                "replay_ms_median": float(np.median(a[1:])),
                "eager_ms_median": float(np.median(b[1:]))}

    times = {}
    mn, tf = names[0], names[2]
    times["predict_flat"] = pair(lambda: srv.predict(mn, reqs[mn]),
                                 lambda: t_srv.predict(mn, reqs[mn]))
    cn = next(iter(cprogs))
    times["predict_conv"] = pair(lambda: csrv.predict(cn, creqs[cn]),
                                 lambda: t_csrv.predict(cn, creqs[cn]))
    check(mn not in srv.resident_names(False), "MNIST CoTM is resident")

    def cold(s_):
        s_.enqueue(mn, reqs[mn])
        return s_.flush()
    times["cold_request"] = pair(lambda: cold(srv), lambda: cold(t_srv))
    for label, n in (("train_lfsr", mn), ("train_threefry", tf)):
        x, y = rows(n, 13)
        times[label] = pair(lambda: srv.train(n, x, y),
                            lambda: t_srv.train(n, x, y))
    for n in names:
        a, b = srv.tenants[n], t_srv.tenants[n]
        check(same_state(torch, a.program, b.program)
              and same_state(torch, a.prng, b.prng),
              f"{n} after the timed train steps differs from eager")
    # ProgramBank.train at K=2 on new banks (its first call captures)
    bank2, lits2, lab2 = build(eng, ceng, order[:2])[2:]
    t_bank2 = build(e_eng, e_ceng, order[:2])[2]
    times["bank_train_k2"] = pair(lambda: bank2.train(lits2, lab2),
                                  lambda: t_bank2.train(lits2, lab2))
    check(same_state(torch, bank2.progs, t_bank2.progs)
          and same_state(torch, bank2.prngs, t_bank2.prngs),
          "the K=2 bank after its timed steps differs from eager")
    # the first flush after a bank train step (K=3: its graph exists)
    flush_graph = next(iter(bank._flush_graphs.values()))
    first_after, first_after_eager = [], []
    for _ in range(6):
        bank.train(blits, blabels)
        t_bank.train(blits, blabels)
        first_after += host_ms(lambda: bank.predict(blits), 1)
        first_after_eager += host_ms(lambda: t_bank.predict(blits), 1)
    check(next(iter(bank._flush_graphs.values())) is flush_graph
          and flush_graph.replays == 3 + 6,
          "a flush after a bank train step captured anew")
    times["first_flush_after_bank_train"] = {
        "replay_ms": first_after, "eager_ms": first_after_eager}

    # the first flush after a restack at an unchanged K, then at a new K
    names_k, bank_k = srv._bank_for(False)
    k_graph = next(iter(bank_k._flush_graphs.values()))

    def full_flush(s_):
        for n in names:
            s_.enqueue(n, reqs[n])
        return s_.flush()
    steady = pair(lambda: full_flush(srv), lambda: full_flush(t_srv), 6)
    restack, restack_eager = [], []
    for r in range(6):
        roster_ = names[:2] if r % 2 == 0 else names[2:]
        for s_ in (srv, t_srv):
            s_.set_resident(roster_)
        restack += host_ms(lambda: full_flush(srv), 1)
        restack_eager += host_ms(lambda: full_flush(t_srv), 1)
    check(srv._bank_for(False)[1] is bank_k
          and next(iter(bank_k._flush_graphs.values())) is k_graph,
          "a restack at an unchanged K made a new bank or graph")
    srv.add_resident(names[0])
    t_srv.add_resident(names[0])
    new_k = host_ms(lambda: full_flush(srv), 1)
    new_k_eager = host_ms(lambda: full_flush(t_srv), 1)
    check(same_answer(torch, np, full_flush(srv), full_flush(t_srv)),
          "the flush after a new-K restack differs from eager")
    times["first_flush_after_restack"] = {
        "replay_ms": restack, "eager_ms": restack_eager,
        "steady_flush": steady,
        "new_k_capture_flush_ms": new_k, "new_k_eager_ms": new_k_eager}

    # ---- the scheduled cycle of phase 13, broken down ---------------------
    srv13 = sched.server
    acc: dict = {}
    patched = []

    def timed(obj, name, key, cls=False):
        fn = getattr(obj, name)

        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
        setattr(obj, name, wrapper)
        patched.append((obj, name, fn if cls else None))

    timed(srv13, "enqueue", "encode")
    timed(api.ProgramBank, "_flush", "bank_replay", cls=True)
    timed(srv13.engine, "served_infer", "cold_path")
    timed(srv13, "flush_async", "flush_async")
    timed(srv13, "train", "train")
    timed(srv13, "collect", "collect")
    cycles = {}
    trains_before = sched.trains
    try:
        for label, with_train in (("infer", False), ("infer_train", True)):
            rec = []
            for c in range(20):
                acc.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for n in names:
                    sched.submit(n, reqs[n])
                if with_train:
                    sched.submit_train(mn, *rows(mn, 14 + c % 2))
                sched.drain()
                torch.cuda.synchronize()
                total = (time.perf_counter() - t) * 1e3
                ms = {k: v * 1e3 for k, v in acc.items()}
                rec.append({
                    "total": total, "encode": ms.get("encode", 0.0),
                    "bank_replay": ms.get("bank_replay", 0.0),
                    "cold_path": ms.get("cold_path", 0.0),
                    "flush_rest": ms.get("flush_async", 0.0)
                    - ms.get("bank_replay", 0.0) - ms.get("cold_path", 0.0),
                    "train": ms.get("train", 0.0),
                    "collect": ms.get("collect", 0.0),
                    "scheduler": total - ms.get("encode", 0.0)
                    - ms.get("flush_async", 0.0) - ms.get("train", 0.0)
                    - ms.get("collect", 0.0)})
            cycles[label] = {k: float(np.median([r_[k] for r_ in rec[1:]]))
                             for k in rec[0]}
            cycles[label]["total_ms"] = [r_["total"] for r_ in rec]
    finally:
        for obj, name, fn in patched:
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
    cycles["trains_applied"] = sched.trains - trains_before

    def tagged(e, label):
        return [{"engine": label, **g} for g in e.graph_report()]
    return {
        "card": card, "batch_slot": B,
        "engine": {"L": eng.L, "R": eng.R, "H": eng.H, "W": eng.W},
        "conv_engine": {"L": ceng.L, "R": ceng.R, "P": ceng.P},
        "backends": backends, "sequence_s": seq_s,
        "eager_sequence_s": eager_seq_s, "launches": counts,
        "cache_report_checked": cache_checked,
        "cache_report_conv": {k: v for k, v in ceng.cache_report().items()
                              if k != "path_per_stage"},
        "cache_report_after": {k: v for k, v in eng.cache_report().items()
                               if k != "path_per_stage"},
        "replays": replays, "host_ms": times, "scheduled_cycle": cycles,
        "graphs": tagged(eng, "flat") + tagged(ceng, "conv"),
        "phase_s": time.perf_counter() - t_phase}


TUNE_WIDTHS = {"roster": (3200, 4224, 16), "training": (1664, 2048, 16)}
TUNE_EVAL = (1, 2, 4, 8, 16, 32, 64)     # eval batch buckets measured
TUNE_TRAIN = (1, 4, 8, 32)               # train batch buckets measured
TUNE_TA = 32


def tuned_phase(torch, np, api, ops, tm_paper, x_tr, y_tr, card: str,
                seed: int) -> dict:
    """Phase 18: the launch checker on this card, ``measure`` plans at the
    roster and training widths against the seed model, the three modes
    answering the same, the trace audit on the card and the
    reconfiguration benchmark at ``demo_specs(small=False)``."""
    import shutil
    import tempfile
    from repro_torch.analysis import kernel_check, trace_audit
    from repro_torch.kernels import _build, autotune
    from repro_torch.launch import tm_perf
    from repro_torch.launch.mesh import HardwareModel
    from repro_torch.launch.serve_tm import reconfig_benchmark
    t_phase = time.perf_counter()
    report = {"card": card}

    # (a) the launch checker at this card's limits
    hw = HardwareModel.from_device(0)
    n_plans, violations, findings = kernel_check.check_all(hw)
    check(not violations, "launch violations: "
          + "; ".join(v.render() for v in violations[:5]))
    _, smem_fn = _build.entry("fused_step", "dtm_fused_step_smem",
                              [ctypes.c_int] * 3, ctypes.c_size_t)
    for H, W in ((16, 100), (16, 52), (10, 12), (16, 32), (4, 8)):
        for bulk in (False, True):
            check(smem_fn(H, W, int(bulk)) == kernel_check.fused_smem(
                H, W, bulk), f"fused_step shared memory H={H} W={W}")
    report["kernel_check"] = {
        "hw": {"name": hw.name, "sms": hw.sms,
               "smem_per_block_optin": hw.smem_per_block_optin},
        "plans": n_plans, "violations": 0,
        "findings": [f.render() for f in findings]}

    # (b) measured plans against the seed model's picks
    tmp = tempfile.mkdtemp(prefix="tuned-")
    try:
        cache = os.path.join(tmp, "autotune.json")
        fresh = os.path.join(tmp, "none.json")    # never written: seed only
        autotune.clear_cache()
        rows, plans = [], {}
        t0 = time.perf_counter()
        for width, shape in TUNE_WIDTHS.items():
            L, R, _ = shape
            for stage, buckets in (("eval", TUNE_EVAL),
                                   ("train", TUNE_TRAIN), ("ta", (TUNE_TA,))):
                for b in buckets:
                    plan = autotune.lookup(stage, b, shape, mode="measure",
                                           cache=cache, device="cuda")
                    plans[stage, b, shape] = plan
                    sp = autotune.seed_plan(stage, b, shape)
                    row = {"width": width, "stage": stage, "bucket": b,
                           "candidates_ms": {
                               path: {g: us / 1e3 for g, us in by.items()}
                               for path, by in
                               plan["candidates_us"].items()},
                           "rejected": plan["rejected"],
                           "measured": plan["path"],
                           "seed": None if sp is None else sp["path"],
                           "tiles": plan["tiles"],
                           "planned_tiles": autotune.planned_tiles(
                               stage, b, shape, mode="measure",
                               cache=cache, device="cuda")}
                    check(row["planned_tiles"] == plan["tiles"],
                          f"planned_tiles {stage}/{b}/{shape}")
                    # the path is the fastest at its own geometry (the
                    # one the engine launches); ``tiles`` its best swept
                    own_us = {p: by[autotune.geometry_key(
                        autotune.geometries(stage, p, b, shape, hw.sms)[0])]
                        for p, by in plan["candidates_us"].items()}
                    row["own_geometry_ms"] = {p: v / 1e3
                                              for p, v in own_us.items()}
                    check(plan["path"] == min(own_us, key=own_us.get)
                          and plan["us"] == own_us[plan["path"]],
                          f"measured path {stage}/{b}/{shape}: {own_us}")
                    # the sweep: three geometries a packed eval leg, the
                    # fused cluster sizes at R=4224
                    n_geo = {k: len(v) for k, v in
                             plan["candidates_us"].items()}
                    if stage == "eval":
                        check(n_geo["packed_vpu"] == 3
                              and n_geo["mxu_popcount"] == 3,
                              f"eval sweep {b}/{shape}: {n_geo}")
                    if stage == "train" and b > 4 and R == 4224:
                        check(n_geo["fused"] == 3,
                              f"fused sweep {b}/{shape}: {n_geo}")
                    if stage == "eval":
                        c = tm_perf.packed_eval_costs(b, L, R)
                        row["seed_model_s"] = {"packed_vpu": c["vpu_s"],
                                               "mxu_popcount": c["mxu_s"]}
                    rows.append(row)
        measure_s = time.perf_counter() - t0
        autotune.clear_cache()
        for (stage, b, shape), plan in plans.items():
            again = autotune.lookup(stage, b, shape, mode="measure",
                                    cache=cache, device="cuda")
            check(again == plan, f"reloaded plan {stage}/{b}/{shape}")
        report["plans"] = rows
        report["measure_s"] = measure_s

        # the three modes answer and train the same
        spec = paper_spec(api, tm_paper.TM_MNIST_COTM, "lfsr")
        tile = api.tile_for(spec)
        # seed on an empty cache file: the model's own picks
        engs = {m: api.compile(tile, autotune=m, autotune_cache=(
                    fresh if m == "seed" else cache))
                for m in autotune.MODES}
        tm = api.TM(spec, engine=engs["off"], seed=seed)
        paths = {}
        for B in (1, 8, 32):
            outs = {}
            for m, e in engs.items():
                lits = e.encode(spec, x_tr[:B])
                lab = spec.encode_labels(y_tr[:B]).to(e.device)
                sums, cl = e.infer(tm.program, lits)
                prog, prng, st = e.train_step(tm.program, tm.prng, lits, lab)
                outs[m] = (sums, cl, *prog.leaves(), *prng.leaves(),
                           *st.values())
                pps = e.cache_report()["path_per_stage"]
                paths[f"{m} B={B}"] = {k: pps[k] for k in
                                       ("infer", "train", "train_ta")}
            for m in ("seed", "measure"):
                check(all(torch.equal(a, b_) for a, b_ in
                          zip(outs[m], outs["off"])),
                      f"autotune={m} differs from off at B={B}")
        report["mode_paths"] = paths

        # (c) the trace audit on the card
        audits = []
        for leg in ({}, {"kernel_path": "packed_vpu"}):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = trace_audit.run_audit(device="cuda", autotune_cache=fresh,
                                        **leg)
            audits.append({"leg": rep.leg, "s": time.perf_counter() - t0,
                           "session_caches": rep.session_caches,
                           "serving_caches": rep.serving_caches,
                           "launches": {k: v for k, v in
                                        ops.launch_counts().items() if v}})
        report["audit"] = audits

        # (d) the reconfiguration benchmark at full demo width
        ops.reset_launch_counts()
        rc = reconfig_benchmark(small=False,
                                out=os.path.join(tmp, "reconfig.json"),
                                autotune_cache=fresh)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        check(any(launches.get(k, 0) for k in ("packed_clause_eval",
                                                "packed_clause_tile",
                                                "clause_eval")),
              f"the reconfiguration benchmark launched {launches}")
        report["reconfig"] = {
            k: rc[k] for k in ("device", "batch_slot", "n_models", "rounds",
                               "engine_compile_s", "train_compile_s",
                               "steady_us", "swap_us", "swap_overhead_us",
                               "train_swap_us", "resynthesis_baseline_s",
                               "speedup_vs_resynthesis")}
        report["reconfig"]["cache"] = rc["server"]["cache"]
        report["reconfig"]["launches"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        autotune.clear_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    return report


# Phase 19: the pods over torch.distributed, one rank a card (NCCL).
POD_STEPS = 4                # ShardedTM train steps of the lfsr model
POD_FLUSHES = 3              # PodBank flushes of the serving roster
POD_TRAINS = 2               # PodBank train steps (the first captures)
DP_TIMED = 3                 # dp_train_step calls timed after the first


def pods_work(rank: int, world: int, init_file: str, inp: dict) -> dict:
    """Phase 19's SPMD body, the same on every rank (rank 0 in the main
    process, the others spawned by :func:`pods_phase`): an NCCL group of
    ``world`` ranks, one a card, then (a) ``ShardedTM`` over a
    ``clauses`` mesh: an inference and ``POD_STEPS`` train steps of the
    lfsr training model, each against the engine's own ``infer`` and
    ``train_step`` from the same program and PRNG; (b) ``pod_stack`` of
    the serving roster (K=4) over a ``tenants`` mesh: ``POD_FLUSHES``
    flushes and ``POD_TRAINS`` train steps against ``api.stack``'s bank;
    (c)
    ``api.serve(mesh=)`` draining phase 13's 87 requests (trains and
    inferences), answers equal to phase 13's.  ``inp`` holds numpy data
    only (the spawn pickles it).  The references run before the launch
    counts are set to 0 and the pod path after; returns the counts, the
    timings and what the checks compared."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import api, convert
    from repro_torch.core.prng import PRNG
    from repro_torch.kernels import ops
    from repro_torch.launch import pod
    from repro_torch.launch.mesh import make_clause_mesh, make_tenant_mesh
    from repro_torch.launch.scheduler import SchedulerConfig
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        return _pods_body(np, torch, api, convert, PRNG, ops, pod,
                          make_clause_mesh, make_tenant_mesh,
                          SchedulerConfig, rank, world, inp)
    finally:
        dist.destroy_process_group()


def _pods_body(np, torch, api, convert, PRNG, ops, pod, make_clause_mesh,
               make_tenant_mesh, SchedulerConfig, rank, world, inp):
    from repro_torch.core import (TMConfig, feedback, init_state, threefry,
                                  to_literals)
    from repro_torch.core.distributed import _shard_prng, dp_train_step
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    sync = torch.cuda.synchronize
    # ---- references (not counted) ------------------------------------------
    tspec = api.TMSpec.from_dict(inp["train_spec"])
    eng = api.compile(api.tile_for(tspec))
    p0 = convert.program_from_numpy(inp["p0"])
    r0 = convert.prng_from_numpy(inp["r0"])
    batches = [(eng.encode(tspec, x), tspec.encode_labels(y).cuda())
               for x, y in inp["train_batches"]]
    ref_sums, ref_cl = eng.infer(p0, batches[0][0])
    ref_steps, p_, r_ = [], p0, r0
    for lits, lab in batches:
        p_, r_, st = eng.train_step(p_, r_, lits, lab)
        ref_steps.append((p_, r_, st))
    # the eager twin: ShardedTM on an engine with its graphs off, the
    # chain of launches each replay stands for, with its launches a call
    cmesh = make_clause_mesh()
    tstm = pod.ShardedTM(eager_engine(api.compile(api.tile_for(tspec))),
                         cmesh)
    tp = tstm.shard(p0)
    twin = {"infer_ms": [], "step_ms": [], "infer_launches": [],
            "step_launches": [], "steps": []}
    for _ in range(2):
        c0, t = ops.launch_counts(), time.perf_counter()
        twin_sums, twin_cl = tstm.infer(tp, batches[0][0])
        sync()
        twin["infer_ms"].append((time.perf_counter() - t) * 1e3)
        twin["infer_launches"].append(launch_delta(ops, c0))
    tr = r0
    for lits, lab in batches:
        c0, t = ops.launch_counts(), time.perf_counter()
        tp, tr, tst = tstm.train_step(tp, tr, lits, lab)
        sync()
        twin["step_ms"].append((time.perf_counter() - t) * 1e3)
        twin["step_launches"].append(launch_delta(ops, c0))
        twin["steps"].append((tstm.gather(tp), tr, tst))
    specs = {n: api.TMSpec.from_dict(d) for n, d in inp["specs"].items()}
    names = list(specs)
    gpu = api.compile(api.tile_for(*specs.values()))
    progs = [convert.program_from_numpy(inp["progs"][n]) for n in names]

    def bank_prngs():
        return [PRNG.create(specs[n].tm_config(), 40 + i)
                for i, n in enumerate(names)]
    blits = [gpu.encode(specs[n], inp["bank_x"][n]) for n in names]
    blab = torch.as_tensor(inp["bank_y"]).cuda()
    ref_bank = api.stack(progs, gpu, prngs=bank_prngs())
    # the pod bank's roster padded to a multiple of the world (pad slots
    # replay the first program; only the real slots are compared)
    fill = [0 if n is None else names.index(n)
            for n in pod.pad_roster(names, world)]
    ref_pred = ref_bank.predict(blits)
    ref_bst = [ref_bank.train(blits, blab) for _ in range(POD_TRAINS)]
    ref_slots = ref_bank.unstack()
    # the legacy core at the MNIST CoTM's widths with the kernels
    # (compute_backend="pallas"), counter streams: dp_train_step over the
    # world's data axis (8 rows a rank: the dense clause kernel) and a
    # sequential step of 2 rows (the edge kernel a row); rank 0 replays
    # both on the CPU (the dp step as the sum of every shard's deltas)
    lcfg = TMConfig(tm_type="coalesced", features=784, clauses=2000,
                    classes=10, T=500, s=10.0, prng_backend="counter",
                    compute_backend="pallas")
    lx, ly = inp["legacy_batch"]
    lb = 8 * world
    lx, ly = lx[:lb], ly[:lb]
    if rank == 0:
        st_c = init_state(lcfg, threefry.key(inp["seed"], "cpu"),
                          device="cpu")
        lit_c, lab_c = to_literals(lx), torch.from_numpy(ly)
        acc = None
        for i in range(world):
            _, *parts = feedback.batched_deltas(
                lcfg, st_c, _shard_prng(lcfg, inp["seed"], i, "cpu"),
                lit_c[8 * i:8 * (i + 1)], lab_c[8 * i:8 * (i + 1)], 4)
            acc = parts if acc is None else [a + b for a, b in zip(acc,
                                                                  parts)]
        ref_dp, _ = feedback.apply_deltas(lcfg, st_c, *acc)
        ref_seq, ref_seq_prng, _ = feedback.train_step(
            lcfg, st_c, PRNG.create(lcfg, inp["seed"], device="cpu"),
            (lit_c[:2], lab_c[:2]), mode="sequential")
    sync()

    # ---- the pod path (counted from 0 here) --------------------------------
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    lstate = init_state(lcfg, threefry.key(inp["seed"]))
    llit, llab = to_literals(lx).cuda(), torch.from_numpy(ly).cuda()
    # the mesh is made before the clock starts; the first call (the
    # group's first collectives) is timed apart from the median of three
    # more from the same state (the step is pure: each returns the same)
    hmesh = make_host_mesh(1)
    dp_ms, dp_states = [], []
    for _ in range(1 + DP_TIMED):
        t = time.perf_counter()
        dp_state, _ = dp_train_step(lcfg, lstate, llit, llab, hmesh,
                                    seed=inp["seed"], chunk=4,
                                    compact_frac=0.25)
        sync()
        dp_ms.append((time.perf_counter() - t) * 1e3)
        dp_states.append(dp_state)
    check(all(torch.equal(d.ta, dp_states[0].ta)
              and torch.equal(d.weights, dp_states[0].weights)
              for d in dp_states),
          "dp_train_step from one state differs between calls")
    legacy_ms = {"dp_train_step_first": dp_ms[0],
                 "dp_train_step_median": float(np.median(dp_ms[1:])),
                 "dp_train_step": dp_ms}
    t = time.perf_counter()
    seq_state, seq_prng, _ = feedback.train_step(
        lcfg, lstate, PRNG.create(lcfg, inp["seed"]), (llit[:2], llab[:2]),
        mode="sequential")
    sync()
    legacy_ms["sequential"] = (time.perf_counter() - t) * 1e3
    stm = pod.ShardedTM(eng, cmesh)
    check(stm.capture, "the clauses axis of an NCCL group does not capture")
    p = stm.shard(p0)
    infer_ms, infer_launches = [], []
    for _ in range(2):          # the first warms up and captures
        c0, t = ops.launch_counts(), time.perf_counter()
        sums, cl = stm.infer(p, batches[0][0])
        sync()
        infer_ms.append((time.perf_counter() - t) * 1e3)
        infer_launches.append(launch_delta(ops, c0))
    r, got_steps, step_ms, step_launches = r0, [], [], []
    for lits, lab in batches:   # the first warms up and captures
        c0, t = ops.launch_counts(), time.perf_counter()
        p, r, st = stm.train_step(p, r, lits, lab)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        step_launches.append(launch_delta(ops, c0))
        got_steps.append((stm.gather(p), r, st))
    sharded_graphs = [g for g in eng.graph_report()
                      if g["stage"].endswith("_sharded")]
    # the forced dense clause kernel in the sharded inference
    eng_mxu = api.compile(api.tile_for(tspec), kernel_path="mxu")
    stm_mxu = pod.ShardedTM(eng_mxu, cmesh)
    sums_mxu, cl_mxu = stm_mxu.infer(stm_mxu.shard(p0), batches[0][0])
    tmesh = make_tenant_mesh()
    prngs_ = bank_prngs()
    pbank = pod.pod_stack([progs[i] for i in fill], gpu, tmesh,
                          prngs=[prngs_[i] for i in fill])
    plits, plab = [blits[i] for i in fill], blab[fill]
    flush_ms, preds = [], None
    for _ in range(POD_FLUSHES):
        t = time.perf_counter()
        preds = pbank.predict(plits)
        sync()
        flush_ms.append((time.perf_counter() - t) * 1e3)
    pbst, bank_train_ms = [], []
    for _ in range(POD_TRAINS):  # the first captures the bank's graph
        t = time.perf_counter()
        pbst.append(pbank.train(plits, plab))
        sync()
        bank_train_ms.append((time.perf_counter() - t) * 1e3)
    pslots = pbank.unstack()[:len(names)]
    sched = api.serve(specs, batch_slot=32, mesh=tmesh,
                      config=SchedulerConfig(pipeline_depth=2),
                      seed=inp["seed"])
    for i, n in enumerate(names):
        sched.register(n, specs[n], program=progs[i], seed=inp["seed"] + i)
    futs = []
    t = time.perf_counter()
    for rnd in inp["plan"]:
        for kind, n, x, y in rnd:
            futs.append(sched.submit_train(n, x, y) if kind == "train"
                        else sched.submit(n, x))
        sched.drain()
    sync()
    drain_s = time.perf_counter() - t
    drained = [f.result(timeout=60) for f in futs]
    sync()
    out["launches"] = ops.launch_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    # the compressed reductions over the data axis of every rank (one
    # NCCL rank a card), against a CPU reference of the world's inputs
    from repro_torch.runtime import compressed_psum, exact_int8_psum
    grp = make_host_mesh(1).get_group("data")
    xs = [compression_inputs(np, r) for r in range(world)]
    cx, ce, cd = (torch.from_numpy(a).cuda() for a in xs[rank])
    t = time.perf_counter()
    comp = {"plain": compressed_psum(cx, grp),
            "error": compressed_psum(cx, grp, ce)}
    isum = exact_int8_psum(cd, grp)
    sync()
    comp_ms = (time.perf_counter() - t) * 1e3
    for name, (tot, res) in comp.items():
        w_tot, w_res = compression_reference(torch, xs, rank,
                                             name == "error")
        check(torch.allclose(tot.cpu(), w_tot, rtol=1e-6, atol=0)
              and torch.allclose(res.cpu(), w_res, rtol=1e-6, atol=1e-7),
              f"compressed_psum ({name}) differs from its CPU reference")
    check(torch.equal(isum.cpu(), torch.from_numpy(
        sum(x[2] for x in xs)).to(torch.int32)),
        "exact_int8_psum differs from the sum of the ranks' deltas")

    # ---- checks --------------------------------------------------------------
    check(torch.equal(sums, ref_sums) and torch.equal(cl, ref_cl)
          and torch.equal(sums_mxu, ref_sums) and torch.equal(cl_mxu, ref_cl),
          "ShardedTM.infer differs from the engine's infer")
    # the replays against the eager twin, bit for bit, launches included
    check(torch.equal(sums, twin_sums) and torch.equal(cl, twin_cl),
          "the replayed ShardedTM.infer differs from its eager twin")
    for i, ((gp, gr, gst), (wp, wr, wst)) in enumerate(zip(
            got_steps, twin["steps"])):
        check(same_state(torch, gp, wp) and same_state(torch, gr, wr)
              and all(torch.equal(gst[k], wst[k]) for k in wst),
              f"the replayed ShardedTM step {i} differs from its eager twin")
    check(infer_launches == twin["infer_launches"]
          and step_launches == twin["step_launches"],
          f"replayed launches {infer_launches} {step_launches} differ from "
          f"the eager twin's {twin['infer_launches']} "
          f"{twin['step_launches']}")
    check(sorted((g["stage"], g["captured"]) for g in sharded_graphs)
          == [("infer_sharded", True), ("train_sharded", True)]
          and all(g["replays"] == (2 if g["stage"] == "infer_sharded"
                                   else len(batches))
                  for g in sharded_graphs),
          f"ShardedTM's graphs: {sharded_graphs}")
    if rank == 0:
        for what, got, want in (("dp_train_step", dp_state, ref_dp),
                                ("sequential train_step", seq_state,
                                 ref_seq)):
            check(torch.equal(got.ta.cpu(), want.ta)
                  and torch.equal(got.weights.cpu(), want.weights),
                  f"the legacy {what} on the card differs from the CPU's")
        check(same_state(torch, seq_prng, ref_seq_prng),
              "the legacy sequential step's PRNG differs from the CPU's")
    for i, ((gp, gr, gst), (wp, wr, wst)) in enumerate(zip(got_steps,
                                                           ref_steps)):
        check(same_state(torch, gp, wp) and same_state(torch, gr, wr)
              and all(int(gst[k]) == int(wst[k]) for k in wst),
              f"ShardedTM step {i} differs from the engine's train_step")
    real = len(names)
    check(all(torch.equal(a[:real], b) for a, b in zip(preds, ref_pred)),
          "PodBank flush differs from ProgramBank's")
    check(all(torch.equal(a[k][:real], b[k]) for a, b in zip(pbst, ref_bst)
              for k in b), "PodBank train stats differ from ProgramBank's")
    check(all(same_state(torch, a, b) for a, b in zip(pslots, ref_slots)),
          "PodBank programs after train differ from ProgramBank's")
    want = inp["drain13"]
    check(len(drained) == len(want), "the pod drain lost requests")
    for k, (a, b) in enumerate(zip(drained, want)):
        check(a == b if isinstance(b, dict) else np.array_equal(a, b),
              f"pod-served request {k} differs from phase 13's")
    st = sched.stats()
    out.update({
        "world": world, "clause_shards": stm.shards,
        "r_loc": eng.R // stm.shards,
        "sharded_infer_ms": infer_ms, "sharded_step_ms": step_ms,
        "sharded_twin": {"infer_ms": twin["infer_ms"],
                         "step_ms": twin["step_ms"],
                         "infer_launches": twin["infer_launches"][-1],
                         "step_launches": twin["step_launches"][-1],
                         "checks": "replays equal the eager twin bit for "
                                   "bit, launch counts included"},
        "sharded_graphs": sharded_graphs,
        "compression": {"shape": list(cx.shape), "ms_three_calls": comp_ms,
                        "checks": "compressed_psum (plain, error "
                        "feedback) rtol 1e-6, exact_int8_psum exact"},
        "legacy": {"model": "MNIST CoTM widths, counter streams, "
                   "compute_backend=pallas", "dp_rows": lb,
                   "host_ms": legacy_ms},
        "sharded_paths": {k: v for k, v in
                          eng.cache_report()["path_per_stage"].items()
                          if "sharded" in k},
        "bank": {"k": pbank.k, "slots_per_rank": pbank.spd,
                 "flush_ms": flush_ms, "train_ms": bank_train_ms},
        "drain": {"requests": len(drained), "seconds": drain_s,
                  "requests_per_s": len(drained) / drain_s,
                  "pod_devices": st["server"]["pod_devices"],
                  "stacked_launches": st["server"]["stacked_launches"]}})
    return out


def launch_delta(ops, before: dict) -> dict:
    """The launches counted since ``before`` (``ops.launch_counts()``)."""
    now = ops.launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def compression_inputs(np, rank: int):
    """Rank ``rank``'s inputs of phase 19's compressed reductions: a
    float32 tensor (its absmax grows with the rank), an error-feedback
    residual, and int32 deltas in [-100, 100]."""
    rng = np.random.default_rng(1900 + rank)
    x = (rng.standard_normal((256, 64)) * (rank + 1)).astype(np.float32)
    err = (rng.standard_normal((256, 64)) * 0.01).astype(np.float32)
    return x, err, rng.integers(-100, 101, (128, 64)).astype(np.int32)


def compression_reference(torch, xs, rank: int, error: bool):
    """``compressed_psum``'s (sum, residual) for ``rank`` computed on the
    CPU from every rank's inputs ``xs``, without a collective."""
    xf = [torch.from_numpy(x) + (torch.from_numpy(e) if error else 0)
          for x, e, _ in xs]
    scale = torch.stack([torch.clamp(x.abs().max() / 127.0, min=1e-20)
                         for x in xf]).max()
    q = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
         for x in xf]
    total = torch.stack([v.to(torch.int32) for v in q]).sum(0)
    return (total.to(torch.float32) * scale,
            xf[rank] - q[rank].to(torch.float32) * scale)


def pods_child(rank: int, world: int, init_file: str, inp: dict,
               src: str) -> None:
    """A spawned rank of phase 19 (ranks 1 .. world-1)."""
    sys.path.insert(0, src)
    pods_work(rank, world, init_file, inp)


def ta_windows(torch, ops, a, kw):
    """The roster train shape's TA updates (phase 13's captured compacted
    update ``a``, ``kw``) on the clause window [3R/4, R) with ``row0`` =
    3R/4, as the last of 4 clause shards runs them, and at full width:
    ((sparse window, full), (dense window, full)), each an (args, kwargs)
    pair.  The window's group list is its own."""
    ta, lits, cl, t1, t2, l_mask, inc, idx, count = a[:9]
    seed, p_ta, boost, n_states = a[9:13]
    C = ta.shape[1]
    row0 = 3 * C // 4
    w = slice(row0, C)

    def win(t):
        return t[..., w].contiguous()
    t1w, t2w = win(t1), win(t2)
    w_idx, w_count = ops.active_groups(t1w, t2w)
    ta_w, inc_w = ta[:, w].contiguous(), inc[:, w].contiguous()
    kw_s = {**kw, "inplace": False}
    kw_d = {k: kw[k] for k in ("rand_bits", "prng", "lfsr_bits",
                               "seed_refresh")}
    scal = (seed, p_ta, boost, n_states)
    sparse = (((ta_w, lits, win(cl), t1w, t2w, l_mask, inc_w, w_idx,
                w_count, *scal, row0), kw_s),
              ((ta, lits, cl, t1, t2, l_mask, inc, idx, count, *scal, 0),
               kw_s))
    dense = (((ta_w, lits, win(cl), t1w, t2w, l_mask, *scal, row0), kw_d),
             ((ta, lits, cl, t1, t2, l_mask, *scal, 0), kw_d))
    return row0, C - row0, sparse, dense


def pods_phase(torch, np, api, ops, inp: dict, plan_specs: dict,
               card: str) -> dict:
    """Phase 19: :func:`pods_work` over the largest power of two of
    ``torch.cuda.device_count()`` ranks, rank 0 here and the others
    spawned (NCCL init through a file
    under ``$TMPDIR``; every child is joined, or terminated if rank 0
    fails), and ``plan_for`` on the H100 budget for the serving roster
    and the training model, on this world's mesh and on a 4-device one.
    Returns the ``pods`` report (with rank 0's launch counts)."""
    import multiprocessing
    import shutil
    import tempfile
    import types
    from repro_torch.launch.mesh import H100
    # the largest power of two of the cards: it splits the training
    # model's R = 2048 clause rows (the serving roster is padded)
    world = 1 << (torch.cuda.device_count().bit_length() - 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pods_")
    init_file = os.path.join(tmp, "init")
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    ctx = multiprocessing.get_context("spawn")
    kids = [ctx.Process(target=pods_child, args=(r, world, init_file, inp,
                                                 src), daemon=True)
            for r in range(1, world)]
    for k in kids:
        k.start()
    try:
        out = pods_work(0, world, init_file, inp)
        for k in kids:
            k.join(timeout=300)
            check(k.exitcode == 0, f"pod rank {kids.index(k) + 1} ended "
                  f"with {k.exitcode}")
    finally:
        for k in kids:
            if k.is_alive():
                k.terminate()
                k.join()
        shutil.rmtree(tmp, ignore_errors=True)
    plans = {}
    four = types.SimpleNamespace(mesh_dim_names=("tenants",), shape=(4,))
    for label, specs in plan_specs.items():
        for mesh_label, mesh in (("world", (world,)), ("4 devices", four)):
            if isinstance(mesh, tuple):
                mesh = types.SimpleNamespace(mesh_dim_names=("tenants",),
                                             shape=mesh)
            pl = api.plan_for(mesh, *specs)
            plans[f"{label} on {mesh_label}"] = {
                "mode": pl.mode, "shards": pl.shards,
                "program_bytes": pl.program_bytes,
                "budget_bytes": pl.budget_bytes, "reason": pl.reason}
            print(f"plan_for {label} on {mesh_label}: {pl.mode} "
                  f"({pl.reason})")
    check(plans["serving roster on 4 devices"]["mode"] == "tenants",
          f"the serving roster does not plan tenant-parallel: {plans}")
    check(H100.l2_bytes == plans["serving roster on 4 devices"][
        "budget_bytes"], "plan_for's default budget is not the H100's L2")
    out.update({"card": card, "cards": torch.cuda.device_count(),
                "plans": plans})
    return out


LEGACY_SEQ_ROWS = 64         # feedback_fit sequential rows (one epoch)
LEGACY_BATCH_ROWS = 1024     # feedback_fit batched rows, batch 64
CONV_IMAGES = 512            # conv_tm training images (batch 32), 128 more
HEAD_BATCHES = 12            # TMHead.train_batch calls of 32 rows
REG_STEPS = 4                # regression_tm steps of 32 rows
ADAM_STEPS = 5               # AdamW steps a moment dtype


def translated_motifs(np, n: int, seed: int):
    """``benchmarks/convtm_bench.py``'s images: one of three 3x3 motifs
    at a random place of an 8x8 image with 5 % background bits; the
    label is the motif."""
    rng = np.random.default_rng(seed)
    motifs = np.array([[[1, 1, 1], [0, 0, 0], [1, 1, 1]],
                       [[1, 0, 1], [1, 0, 1], [1, 0, 1]],
                       [[0, 1, 0], [1, 1, 1], [0, 1, 0]]], np.int8)
    y = rng.integers(0, 3, n).astype(np.int32)
    x = (rng.random((n, 8, 8)) < 0.05).astype(np.int8)
    for i in range(n):
        r, c = rng.integers(0, 6, 2)
        x[i, r:r + 3, c:c + 3] = motifs[y[i]]
    return x, y


def legacy_work(torch, np, datasets, dev: str) -> dict:
    """Phase 20's calls on ``dev``, each timed on the host (a synchronise
    after each on the card): ``feedback_fit`` at fig 7's config
    (MNIST-like, 784 features, 128 clauses, 10 classes, T=24, s=5,
    threefry), sequential over ``LEGACY_SEQ_ROWS`` rows and batched over
    ``LEGACY_BATCH_ROWS`` at batch 64, each with ``compute_backend``
    ``jnp`` and ``pallas``; ``conv_tm`` at convtm_bench's config (8x8,
    patch 3, 48 clauses, 3 classes, T=12, s=3) over ``CONV_IMAGES``
    translated-motif images at batch 32, then ``predict`` on 128;
    ``regression_tm`` at 128 clauses, T=128 (``REG_STEPS`` steps, then
    ``predict``); ``TMHead`` at the system test's config (16 features x 4
    thermometer bits, 32 clauses, 3 classes, T=16, s=4: ``HEAD_BATCHES``
    batches of 32, ``predict``) and ``pool_backbone_features``; AdamW
    ``ADAM_STEPS`` steps on a dict tree in each moment dtype.  Returns
    every result as numpy (states, PRNGs, histories, predictions, stats)
    and the host seconds."""
    from repro_torch import convert
    from repro_torch.core import (TMConfig, conv_tm, regression_tm,
                                  threefry, to_literals)
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.evaluate import feedback_fit
    from repro_torch.core.tm_head import TMHead, pool_backbone_features
    from repro_torch.optim import adam

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else t

    out, secs = {}, {}
    # ---- feedback_fit at fig 7's config -------------------------------------
    x7, y7 = datasets.make_bool_dataset(datasets.MNIST_LIKE,
                                        LEGACY_BATCH_ROWS, seed=7)
    fig7 = dict(tm_type="coalesced", features=784, clauses=128, classes=10,
                T=24, s=5.0, prng_backend="threefry")
    for mode, rows in (("sequential", LEGACY_SEQ_ROWS),
                       ("batched", LEGACY_BATCH_ROWS)):
        for backend in ("jnp", "pallas"):
            cfg = TMConfig(compute_backend=backend, **fig7)
            t = time.perf_counter()
            st, pr, hist = feedback_fit(cfg, x7[:rows], y7[:rows], epochs=1,
                                        batch=64, seed=0, mode=mode,
                                        device=dev)
            sync()
            key = f"feedback_fit {mode} {backend}"
            secs[key] = time.perf_counter() - t
            out[key] = (convert.state_to_numpy(st), convert.prng_to_numpy(pr),
                        hist)
    # ---- conv_tm at convtm_bench's config -----------------------------------
    ccfg = conv_tm.ConvTMConfig(img_h=8, img_w=8, patch=3, clauses=48,
                                classes=3, T=12, s=3.0)
    xi, yi = translated_motifs(np, CONV_IMAGES + 128, 0)
    st, pr = conv_tm.init(ccfg, threefry.key(0, dev), device=dev)
    steps, correct = [], []
    for i in range(0, CONV_IMAGES, 32):
        t = time.perf_counter()
        st, pr, s_ = conv_tm.train_step(ccfg, st, pr, xi[i:i + 32],
                                        yi[i:i + 32])
        sync()
        steps.append(time.perf_counter() - t)
        correct.append(int(s_["correct"]))
    pred = conv_tm.predict(ccfg, st, xi[CONV_IMAGES:])
    out["conv_tm"] = (convert.state_to_numpy(st), convert.prng_to_numpy(pr),
                      correct, host(pred))
    secs["conv_tm steps"] = steps
    secs["conv_tm test_acc"] = float((host(pred) == yi[CONV_IMAGES:]).mean())
    # ---- regression_tm at 128 clauses, T=128 ------------------------------
    rcfg = regression_tm.RegressionTMConfig(features=32, clauses=128, T=128,
                                            s=3.0)
    rng = np.random.default_rng(20)
    xr = (rng.random((REG_STEPS * 32 + 64, 32)) < 0.5).astype(np.int8)
    tr = xr[:, :8].mean(axis=1).astype(np.float32)   # the share of 8 bits
    st, pr = regression_tm.init(rcfg, threefry.key(1, dev), device=dev)
    steps, maes = [], []
    for i in range(REG_STEPS):
        lits = to_literals(torch.from_numpy(xr[i * 32:(i + 1) * 32])).to(dev)
        t = time.perf_counter()
        st, pr, m_ = regression_tm.train_step(
            rcfg, st, pr, lits, torch.from_numpy(tr[i * 32:(i + 1) * 32]))
        sync()
        steps.append(time.perf_counter() - t)
        maes.append(float(m_["mae"]))
    pred = regression_tm.predict(
        rcfg, st, to_literals(torch.from_numpy(xr[-64:])).to(dev))
    out["regression_tm"] = (convert.state_to_numpy(st),
                            convert.prng_to_numpy(pr), maes, host(pred))
    secs["regression_tm steps"] = steps
    # ---- TMHead at the system test's config, and the pooling --------------
    rng = np.random.default_rng(0)
    protos = rng.standard_normal((3, 16))
    yh = rng.integers(0, 3, 512).astype(np.int32)
    feats = (protos[yh] + 0.3 * rng.standard_normal((512, 16))).astype(
        np.float32)
    head = TMHead.create(16, 3, calib=feats[:128], therm_bits=4, clauses=32,
                         T=16, s=4.0, seed=0, device=dev)
    steps, stats = [], []
    for i in range(HEAD_BATCHES):
        t = time.perf_counter()
        st_ = head.train_batch(feats[i * 32:(i + 1) * 32],
                               yh[i * 32:(i + 1) * 32])
        sync()
        steps.append(time.perf_counter() - t)
        stats.append([int(v) for v in (st_.selected_clauses,
                                       st_.active_groups, st_.total_groups,
                                       st_.correct)])
    pred = host(head.predict(feats[384:]))
    out["TMHead"] = (convert.state_to_numpy(head.state),
                     convert.prng_to_numpy(head.prng), stats, pred)
    secs["TMHead batches"] = steps
    secs["TMHead test_acc"] = float((pred == yh[384:]).mean())
    hidden = rng.standard_normal((8, 12, 16)).astype(np.float32)
    mask = (rng.random((8, 12)) < 0.7).astype(np.int32)
    out["pool"] = [host(pool_backbone_features(
        torch.from_numpy(hidden).to(dev),
        None if m is None else torch.from_numpy(m).to(dev)))
        for m in (None, mask)]
    # ---- AdamW in its three moment dtypes ---------------------------------
    rng = np.random.default_rng(21)
    shapes = {"w": (64, 32), "b": (32,), "layers": [{"k": (16, 16)}]}

    def normal_tree():
        return tree_lib.map(
            lambda s_: rng.standard_normal(s_).astype(np.float32), shapes,
            is_leaf=lambda s_: isinstance(s_, tuple))
    p_np = normal_tree()
    grads = [normal_tree() for _ in range(ADAM_STEPS)]

    def dev_tree(tr_):
        return tree_lib.map(lambda a: torch.from_numpy(a).to(dev), tr_)
    for dt in ("float32", "bfloat16", "int8"):
        cfg = adam.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                               state_dtype=dt)
        params = dev_tree(p_np)
        state = adam.init(cfg, params)
        t = time.perf_counter()
        for g in grads:
            params, state, met = adam.apply(cfg, params, dev_tree(g), state)
        sync()
        secs[f"adamw {dt}"] = (time.perf_counter() - t) / ADAM_STEPS
        out[f"adamw {dt}"] = (tree_lib.map(host, params),
                              convert.adam_state_to_numpy(state),
                              {k: float(v) for k, v in met.items()})
    return {"out": out, "secs": secs}


def _tree_equal(np, a, b, tol=None) -> bool:
    """Two numpy trees (dicts, lists, tuples, scalars) equal leaf for
    leaf: exactly, or for floating leaves within ``tol`` = (rtol, atol)."""
    from repro_torch.core import tree as tree_lib
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if tol is not None and x.dtype.kind == "f":
            if not np.allclose(x, y, rtol=tol[0], atol=tol[1]):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def _tree_err(np, a, b) -> float:
    """The largest absolute difference over the floating leaves of two
    numpy trees of one structure."""
    from repro_torch.core import tree as tree_lib
    return max([float(np.abs(np.asarray(x, np.float64)
                             - np.asarray(y, np.float64)).max())
                for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b))
                if np.asarray(x).dtype.kind == "f" and np.asarray(x).size]
               or [0.0])


def legacy_phase(torch, np, ops, datasets, card: str) -> dict:
    """Phase 20: :func:`legacy_work` on the card (launch counts from 0
    just before, read just after; the edge clause kernel's and the dense
    clause kernel's arguments captured) and on the CPU, every result held
    against the CPU's: integer results (TA states, weights, PRNGs,
    histories, stats, predictions) exactly, AdamW and the pooling at
    rtol=1e-6, atol=1e-6 (AdamW's int8 moment codes exactly).  Returns the
    ``legacy`` report, the counts and the captured arguments."""
    caps = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with Capture(ops, "packed_clause_eval") as cap_pe, \
            Capture(ops, "clause_eval") as cap_ce:
        gpu = legacy_work(torch, np, datasets, "cuda")
    phase_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    caps["packed_clause_eval"], caps["clause_eval"] = cap_pe.args, cap_ce.args
    t0 = time.perf_counter()
    cpu = legacy_work(torch, np, datasets, "cpu")
    cpu_s = time.perf_counter() - t0
    g, c = gpu["out"], cpu["out"]
    float_err, bad = {}, []
    for key in g:
        if key.startswith("adamw"):
            # float32 reductions, cos and pow round differently on the
            # card: rtol 1e-6 with atol 1e-6 for values near 0, as the
            # pooling; the int8 moment codes exactly
            params, st, met = g[key]
            cp, cst, cmet = c[key]
            float_err[key] = {"params": _tree_err(np, params, cp),
                              "state": _tree_err(np, tuple(st),
                                                 tuple(cst)),
                              "metrics": _tree_err(np, met, cmet)}
            print(f"legacy: {key} max abs err card vs CPU: "
                  f"{json.dumps(float_err[key])}")
            bad.extend([] if _tree_equal(np, params, cp, (1e-6, 1e-6))
                       and _tree_equal(np, tuple(st), tuple(cst),
                                       (1e-6, 1e-6))
                       and _tree_equal(np, met, cmet, (1e-6, 1e-6))
                       else [key])
        elif key == "pool":
            float_err[key] = _tree_err(np, g[key], c[key])
            check(_tree_equal(np, g[key], c[key], (1e-6, 1e-6)),
                  "pool_backbone_features on the card differs from the "
                  f"CPU's: {float_err[key]}")
        else:
            check(_tree_equal(np, list(g[key]), list(c[key])),
                  f"{key} on the card differs from the CPU's")
    check(not bad, f"{bad} on the card differ from the CPU's beyond rtol "
          f"1e-6, atol 1e-6: {float_err}")
    seq = g["feedback_fit sequential pallas"][2][0]
    bat = g["feedback_fit batched pallas"][2][0]
    check(seq["selected_clauses"] > 0 and bat["selected_clauses"] > 0,
          "feedback_fit selected no clause")
    check(counts["packed_clause_eval"] == LEGACY_SEQ_ROWS
          and counts["clause_eval"] == LEGACY_BATCH_ROWS // 64
          and counts["threefry_bits"] > 0,
          f"the legacy path launched {counts}")
    secs, csecs = gpu["secs"], cpu["secs"]

    def med_ms(v):
        return float(np.median(v) * 1e3)
    host_ms = {}
    for mode, rows, steps in (("sequential", LEGACY_SEQ_ROWS,
                               LEGACY_SEQ_ROWS),
                              ("batched", LEGACY_BATCH_ROWS,
                               LEGACY_BATCH_ROWS // 64)):
        for backend in ("jnp", "pallas"):
            k = f"feedback_fit {mode} {backend}"
            host_ms[k] = {"fit_s": secs[k], "cpu_fit_s": csecs[k],
                          "ms_per_step": secs[k] / steps * 1e3,
                          "steps": steps, "rows": rows}
    for k in ("conv_tm steps", "regression_tm steps", "TMHead batches"):
        host_ms[k] = {"median_ms": med_ms(secs[k]),
                      "cpu_median_ms": med_ms(csecs[k]),
                      "first_ms": secs[k][0] * 1e3, "n": len(secs[k])}
    for dt in ("float32", "bfloat16", "int8"):
        host_ms[f"adamw {dt} step"] = {"ms": secs[f"adamw {dt}"] * 1e3,
                                       "cpu_ms": csecs[f"adamw {dt}"] * 1e3}
    for k, v in host_ms.items():
        print(f"legacy: {k}: {json.dumps(v)}")
    report = {
        "card": card, "phase_s": phase_s, "cpu_s": cpu_s,
        "checks": "every result equal to the CPU's (AdamW and pooling "
                  "rtol 1e-6, atol 1e-6; int8 moment codes equal)",
        "float_max_abs_err": float_err,
        "host_ms": host_ms, "launches": counts,
        "conv_test_acc": secs["conv_tm test_acc"],
        "head_test_acc": secs["TMHead test_acc"],
        "feedback_fit_first_epoch": {"sequential": seq, "batched": bat}}
    return report, counts, caps


# Phase 21: the examples/ mirrors, each a main(argv) -> dict
MIRRORS = ("quickstart_torch", "tm_head_torch", "serve_stream_torch",
           "train_while_serve_torch", "dtm_reconfigure_torch")
# the tests' small sizes (tests/test_torch_examples.py), run on the card
# and on the CPU; serve_stream streams a fixed count, not for a time
MIRROR_SMALL = {
    "quickstart_torch": ["--n", "96", "--train", "64", "--features", "64",
                         "--clauses", "16", "--epochs", "2", "--batch", "16"],
    "tm_head_torch": ["--n", "96", "--calib", "32", "--train", "64",
                      "--clauses", "16", "--epochs", "2", "--batch", "16"],
    "serve_stream_torch": ["--requests", "16", "--scale", "4"],
    "train_while_serve_torch": ["--steps", "3", "--scale", "2"],
    "dtm_reconfigure_torch": ["--n", "0.125", "--scale", "4", "--features",
                              "64", "--epochs", "1", "--batch", "16"],
}


def mirror(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mirror_numbers(name: str, out: dict) -> dict:
    """What two runs of a mirror at one size must return alike: all but
    the device and the timing-dependent scheduler stats, and of
    ``dtm_reconfigure``'s cache report the paths (its graph counts are 1
    on the card, 0 on the CPU)."""
    nums = {k: v for k, v in out.items() if k not in ("device", "stats")}
    if name == "dtm_reconfigure_torch":
        nums["cache"] = out["cache"]["path_per_stage"]
    return nums


def examples_phase(torch, np, ops, card: str):
    """Phase 21: the five ``examples/*_torch.py`` mirrors on the card at
    their default sizes (the JAX scripts' sizes, where their assertions
    hold; launch counts from 0 just before, read just after, the
    quickstart's ``fused_step`` and ``ta_update_sparse`` arguments
    captured from its epoch graph's warm-up), then at the tests' small
    sizes on the card and on the CPU, whose returned numbers must be
    equal.  Returns the ``examples`` report, the counts and the captured
    arguments."""
    mods = {n: mirror(n) for n in MIRRORS}
    report, host_s = {"card": card}, {}
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    full = {}
    for name in MIRRORS:
        t = time.perf_counter()
        if name == "quickstart_torch":
            with Capture(ops, "fused_step") as cap_f, \
                    Capture(ops, "ta_update_sparse") as cap_s:
                full[name] = mods[name].main([])
            cap_f.freeze()
            cap_s.freeze()
        else:
            full[name] = mods[name].main([])
        torch.cuda.synchronize()
        host_s[name] = time.perf_counter() - t
    phase_s = time.perf_counter() - t_phase
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in (
        "packed_clause_eval", "packed_clause_tile", "class_sum", "fused_step",
        "ta_update_sparse")), f"the mirrors launched {counts}")
    check(all(out["device"].startswith("cuda") for out in full.values()),
          "a mirror ran off the card by default")
    cache = full["dtm_reconfigure_torch"]["cache"]
    check(cache["infer"] == cache["fit_epoch"] == cache["fit_epoch_conv"]
          == 1 and all(v <= 1 for v in cache.values() if isinstance(v, int)),
          f"dtm_reconfigure's graphs: {cache}")
    small, small_s = {}, {}
    for name in MIRRORS:
        got = {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            got[dev] = mods[name].main(MIRROR_SMALL[name]
                                       + ["--device", dev])
            small_s[f"{name} {dev}"] = time.perf_counter() - t
        check(mirror_numbers(name, got["cuda"])
              == mirror_numbers(name, got["cpu"]),
              f"{name} at the small size: the card's numbers differ from "
              "the CPU's")
        small[name] = mirror_numbers(name, got["cuda"])
    report.update({
        "phase_s": phase_s, "host_s": host_s, "small_s": small_s,
        "launches": counts,
        "default": {
            "quickstart_accuracy": full["quickstart_torch"]["accuracy"],
            "quickstart_history": full["quickstart_torch"]["history"],
            "tm_head_accuracy": full["tm_head_torch"]["accuracy"],
            "serve_stream": {k: full["serve_stream_torch"]["stats"][k]
                             for k in ("completed", "submitted", "launches",
                                       "promotions", "demotions")},
            "train_while_serve": full["train_while_serve_torch"]["stats"],
            "dtm_reconfigure_scores": full["dtm_reconfigure_torch"][
                "scores"],
            "dtm_reconfigure_cache": cache},
        "small_equal": "card == CPU for every mirror's returned numbers",
        "small": {k: v for k, v in small.items()
                  if k != "serve_stream_torch"}})
    return report, counts, {"fused_step": cap_f.args,
                            "ta_update_sparse": cap_s.args}


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
    from repro_torch.core import prng as tprng, threefry
    from repro_torch.core.prng import PRNG
    from repro_torch.kernels.lfsr import lfsr_bits, lfsr_bits_plain
    from repro_torch.kernels.threefry import threefry_bits, threefry_bits_plain
    from repro_torch.kernels.fused_step import (
        fused_bulk, fused_step, fused_step_plain, prepare_fused_step)
    from repro_torch.kernels.step_glue import (
        prepare_step_epilogue, prepare_step_prologue, step_epilogue,
        step_epilogue_plain, step_prologue, step_prologue_plain)
    from repro_torch.kernels.ta_update import (
        prepare_ta_update, prepare_ta_update_sparse,
        prepare_ta_update_streamed, stream_rands, ta_update, ta_update_plain,
        ta_update_sparse, ta_update_sparse_plain, ta_update_streamed,
        ta_update_streamed_plain)
    from repro_torch.core.booleanize import unpack_literals
    from repro_torch.kernels.clause_eval import clause_eval, clause_eval_plain
    from repro_torch.kernels.tm_infer import (prepare_tm_infer, tm_infer,
                                              tm_infer_plain)
    from repro_torch.launch.kernel_bench import graph_ms
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
    b1_rate = b1_mma_per_s(torch, _build)

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
    lit4 = lits[:1, :4]                  # four requests of the first tenant
    _, err_edge4 = compare(packed_clause_eval, packed_clause_eval_plain,
                           lit4, inc1, True, L)
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
    # the eager bank inference gives the clause kernel's arguments (the
    # flushes above replay a graph, whose buffers no capture records)
    with Capture(ops, "clause_eval") as cap_ce_serve:
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
    hist, fit_s = fit(tm_a)
    counts_fit = ops.launch_counts()
    ops.reset_launch_counts()
    hist_d, fit_d_s = fit(tm_b)
    counts_dense = ops.launch_counts()
    steps = 2 * (N_TRAIN // 32)
    check(counts_fit["fused_step"] == steps
          and counts_fit["ta_update_sparse"] == steps
          and counts_fit["ta_update"] == 0
          and counts_fit["step_prologue"] == steps
          and counts_fit["step_epilogue"] == steps,
          f"the compacted fit launched {counts_fit}")
    check(counts_dense["fused_step"] == steps
          and counts_dense["ta_update"] == steps
          and counts_dense["ta_update_sparse"] == 0
          and counts_dense["step_prologue"] == steps
          and counts_dense["step_epilogue"] == steps,
          f"the dense fit launched {counts_dense}")
    check(hist == hist_d, "compacted and dense fits give other histories")
    check(same_state(torch, tm_a.program, tm_b.program)
          and same_state(torch, tm_a.prng, tm_b.prng),
          "compacted and dense fits end in other programs or PRNGs")
    check(hist[-1]["train_acc"] > 1.0 / spec.classes,
          f"last epoch train accuracy {hist[-1]['train_acc']}")
    test_acc = tm_a.score(x_te, y_te)

    # the first two steps of the fit, on the card (eager, in place as the
    # fit's step: the kernel checks of phase 10 take their arguments from
    # these calls, the fits replay graphs) and on the CPU engine
    plan = np.random.default_rng(args.seed).permutation(N_TRAIN).reshape(
        -1, 32)
    pg, rg, pc, rc = p0.to("cuda"), r0.to("cuda"), p0, r0
    cpu_s = 0.0
    for s_ in range(2):
        xb, lab = x_tr[plan[s_]], spec.encode_labels(y_tr[plan[s_]])
        with Capture(ops, "fused_step") as cap_front, \
                Capture(ops, "ta_update_sparse") as cap_sparse, \
                Capture(ops, "step_prologue") as cap_pro, \
                Capture(ops, "step_epilogue", clone=True) as cap_epi:
            pg, rg, sg = eng.train_step(pg, rg, eng.encode(spec, xb),
                                        lab.cuda(), donate=True)
        t = time.perf_counter()
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec, xb), lab)
        cpu_s += time.perf_counter() - t
        check(same_state(torch, pg, pc) and same_state(torch, rg, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"fit step {s_} on the card differs from the CPU engine")

    xb0, lab0 = x_tr[plan[0]], spec.encode_labels(y_tr[plan[0]]).cuda()
    with Capture(ops, "ta_update") as cap_dense1:
        eng_dense.train_step(p0.to("cuda"), r0.to("cuda"),
                             eng_dense.encode(spec, xb0), lab0)

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
    hist_m, fit_m_s = fit(tm_m)
    counts_fit_mxu = ops.launch_counts()
    ops.reset_launch_counts()
    hist_s, fit_s_s = fit(tm_s)
    counts_fit_stream = ops.launch_counts()
    # each fit's first step, eager, gives its kernels' arguments
    with Capture(ops, "clause_eval") as cap_ce_train, \
            Capture(ops, "class_sum") as cap_cs_train:
        eng_mxu.train_step(p0.to("cuda"), r0.to("cuda"),
                           eng_mxu.encode(spec, xb0), lab0)
    with Capture(ops, "ta_update_op") as cap_stream_op, \
            Capture(ops, "ta_update_streamed") as cap_streamed1:
        eng_stream.train_step(p0.to("cuda"), r0.to("cuda"),
                              eng_stream.encode(spec, xb0), lab0)
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
        last = (pc, rc, xb, yb)
        pc, rc, sc = eng_cpu.train_step(pc, rc, eng_cpu.encode(spec_c, xb),
                                        spec_c.encode_labels(yb))
        check(same_state(torch, tm_e.program, pc)
              and same_state(torch, tm_e.prng, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"edge step {i} on the card differs from the CPU engine")
    counts_edge_train = ops.launch_counts()
    # the last step again, eager on the card, for phase 10's kernel check
    with Capture(ops, "packed_clause_eval") as cap_edge_train, \
            Capture(ops, "step_prologue") as cap_pro_edge, \
            Capture(ops, "step_epilogue", clone=True) as cap_epi_edge:
        eng.train_step(last[0].to("cuda"), last[1].to("cuda"),
                       eng.encode(spec_c, last[2]),
                       spec_c.encode_labels(last[3]).cuda())
    check(counts_edge_train["packed_clause_eval"] == EDGE_STEPS
          and counts_edge_train["class_sum"] == EDGE_STEPS
          and counts_edge_train["ta_update_sparse"] == EDGE_STEPS
          and counts_edge_train["step_prologue"] == EDGE_STEPS
          and counts_edge_train["step_epilogue"] == EDGE_STEPS
          and counts_edge_train["fused_step"] == 0,
          f"edge training launched {counts_edge_train}")

    # ---- 9. bank training: MNIST CoTM + MNIST Vanilla, K=2 -------------------
    b_progs = [eng.lower(sp, threefry.key(args.seed + 2 + k, "cuda"))
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
    # the bank step replays a graph: the dense TA check takes its
    # arguments from an eager train_bank on the same state (not counted)
    b_lab = torch.as_tensor(b_y, dtype=torch.int32, device="cuda")
    with Capture(ops, "ta_update") as cap_bank, \
            Capture(ops, "step_prologue") as cap_pro_bank, \
            Capture(ops, "step_epilogue", clone=True) as cap_epi_bank:
        eng.train_bank(bank.progs, bank.prngs, b_lits, b_lab)
    cap_bank.freeze()                # the bank's step below is in place
    ops.reset_launch_counts()
    bst = bank.train(b_lits, b_y)
    counts_bank = ops.launch_counts()
    check(counts_bank["fused_step"] == 1 and counts_bank["ta_update"] == 1
          and counts_bank["ta_update_sparse"] == 0
          and counts_bank["step_prologue"] == 1
          and counts_bank["step_epilogue"] == 1,
          f"the bank step launched {counts_bank}")
    t = time.perf_counter()
    cst = cpu_bank.train(b_lits.cpu(), b_y)
    cpu_s += time.perf_counter() - t
    check(same_state(torch, bank.progs, cpu_bank.progs)
          and same_state(torch, bank.prngs, cpu_bank.prngs)
          and all(torch.equal(bst[k].cpu(), cst[k]) for k in STAT_KEYS),
          "the bank step on the card differs from the CPU engine")
    s_bank = api.stack(b_progs, eng_stream, prngs=b_prngs)
    with Capture(ops, "ta_update_streamed") as cap_streamed2:
        eng_stream.train_bank(s_bank.progs, s_bank.prngs, b_lits, b_lab)
    cap_streamed2.freeze()
    ops.reset_launch_counts()
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

    def plain_kw(kw):
        """A glue wrapper's keywords as its plain version takes them."""
        return {k: v for k, v in kw.items() if k in ("y", "rand_bits")}

    # the step's glue at the fit's step (K=1 B=32, the epilogue in place),
    # the edge step (B=1) and the bank step (K=2): each wrapper against its
    # plain version on copies of the captured arguments
    err_pro = err_epi = 0
    for cap_p, cap_e in ((cap_pro, cap_epi), (cap_pro_edge, cap_epi_edge),
                         (cap_pro_bank, cap_epi_bank)):
        for kernel, plain, (a, kw) in ((step_prologue, step_prologue_plain,
                                        cap_p.args),
                                       (step_epilogue, step_epilogue_plain,
                                        cap_e.args)):
            check(all(t.is_cuda for t in a if isinstance(t, torch.Tensor)),
                  f"the captured {kernel.__name__} call is not on the card")
            got = kernel(*copies(a), **kw)
            want = plain(*copies(a), **plain_kw(kw))
            torch.cuda.synchronize()
            err = 0
            for g, w in zip(got, want):
                check(g.dtype == w.dtype and torch.equal(g, w),
                      f"{kernel.__name__} differs from its plain version at "
                      f"{tuple(a[0].shape)}")
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                                   .abs().max()) if g.numel() else 0)
            if kernel is step_prologue:
                err_pro = max(err_pro, err)
            else:
                err_epi = max(err_epi, err)
    check(cap_epi.args[1].get("inplace") is True,
          "the fit's epilogue did not run in place")
    s_a, s_kw = cap_sparse.args       # the fit's second step (eager)
    check(s_kw.get("inplace") is True,
          "the fit's compacted update did not run in place")
    s_a = copies(s_a)                 # timed below, in place
    _, err_sparse = compare_all(ta_update_sparse, ta_update_sparse_plain,
                                s_a, s_kw)
    d1_a, d1_kw = cap_dense1.args     # the dense fit's first step (K=1)
    _, err_d1 = compare_all(ta_update, ta_update_plain, d1_a, d1_kw)
    d2_a, d2_kw = cap_bank.args       # the bank step (K=2)
    _, err_d2 = compare_all(ta_update, ta_update_plain, d2_a, d2_kw)

    def compare_one(kernel, plain, a, kw):
        got, want = kernel(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        check(n_bad == 0, f"{kernel.__name__}: {n_bad} mismatches")
        return got, int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    pe_a, pe_kw = cap_edge_train.args     # the last edge step, eager
    pe_a = copies(pe_a)
    check(all(t.is_cuda for t in pe_a[:2]),
          "the captured edge training call is not on the card")
    _, err_edge_train = compare_one(packed_clause_eval,
                                    packed_clause_eval_plain, pe_a, pe_kw)
    ce4_a, ce4_kw = cap_ce_serve.args     # the dense bank's inference (K=4)
    _, err_ce4 = compare_one(clause_eval, clause_eval_plain, ce4_a, ce4_kw)
    ce1_a, ce1_kw = cap_ce_train.args     # the dense-front fit's first step
    _, err_ce1 = compare_one(clause_eval, clause_eval_plain, ce1_a, ce1_kw)
    tmi_a, tmi_kw = (lit8s[0], inc8, weights), {"eval_mode": True}
    _, err_tmi = compare_one(tm_infer, tm_infer_plain, tmi_a, tmi_kw)
    st1_a, st1_kw = cap_streamed1.args    # the streamed fit's first step
    st1, err_st1 = compare_all(ta_update_streamed, ta_update_streamed_plain,
                               st1_a, st1_kw)
    st2_a, st2_kw = cap_streamed2.args    # the streamed bank step (K=2)
    _, err_st2 = compare_all(ta_update_streamed, ta_update_streamed_plain,
                             st2_a, st2_kw)
    op_a, op_kw = cap_stream_op.args      # the same step's op call
    ik_kw = {k: v for k, v in op_kw.items() if k not in ("stream", "plain")}
    for g, w in zip(st1, ta_update(*copies(op_a), **ik_kw)):
        check(torch.equal(g, w), "streamed and in-kernel updates differ")

    # ---- 11. the lfsr cluster kernel against its plain loop -----------------
    # the flat step's draws and the full-width conv step's, from the fit's
    # starting cluster; every width with and without the refresh (started
    # two cycles short of it); rand_bits above and below the width; a K=2
    # bank; lane counts off the block
    r0g = r0.to("cuda").state
    lfsr_cases = [(r0g, 24, 16, True, s_)
                  for s_ in (32, 2 * 32 * 2048, 2, 32 * CONV_P * 2048,
                             2 * 32 * 2048 * 384)]
    for width in (4, 8, 12, 32):
        for refresh in (True, False):
            cl_ = tprng.make_cluster(args.seed + width, 8192, width, "cuda")
            cl_.cycles += (1 << width) - 3 if width < 32 else 0
            lfsr_cases.append((cl_, width, 16, refresh, 40 * 8192))
    for width, rb in ((8, 16), (4, 32), (24, 8), (32, 32)):
        cl_ = tprng.make_cluster(args.seed + 1, 8192, width, "cuda")
        lfsr_cases.append((cl_, width, rb, True, 3 * 8192 + 5))
    k2 = [tprng.make_cluster(args.seed + k, 8192, 4, "cuda")
          for k in range(2)]
    lfsr_cases.append((tprng.LFSRState(*(torch.stack(ls) for ls in zip(
        *((c.lanes, c.master, c.cycles) for c in k2)))), 4, 16, True,
        5 * 8192 + 17))
    for n_ in (1, 100, 8191):
        lfsr_cases.append((tprng.make_cluster(args.seed, n_, 4, "cuda"),
                           4, 16, True, 37 * n_ + 1))
    err_lfsr = 0
    for st_, width, rb, refresh, size in lfsr_cases:
        a_ = (st_.lanes, st_.master, st_.cycles, size, width, rb, refresh)
        got, want = lfsr_bits(*a_), lfsr_bits_plain(*a_)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"lfsr_bits differs from its plain loop at width {width} "
                  f"rand_bits {rb} refresh {refresh} size {size} lanes "
                  f"{tuple(st_.lanes.shape)}")
            err_lfsr = max(err_lfsr, int((g - w).abs().max()) if g.numel()
                           else 0)

    # ---- 12. conv at full width: fit, flush and edge request ----------------
    mc = tm_paper.TM_MNIST_COTM          # its widths and hyperparameters
    spec_cv = api.TMSpec.conv(28, 28, CONV_PATCH, classes=mc.classes,
                              clauses=mc.clauses, T=mc.T, s=mc.s,
                              ta_bits=mc.ta_bits, weight_bits=mc.weight_bits,
                              prng_backend="lfsr", lfsr_bits=mc.lfsr_bits,
                              rand_bits=mc.rand_bits)
    ctile = api.tile_for(spec_cv)
    eng_cv = api.compile(ctile, device="cuda")
    cpu_cv = api.compile(ctile, device="cpu")
    cgeo = (eng_cv.L, eng_cv.R, eng_cv.H, eng_cv.W, eng_cv.P)
    check(cgeo == (384, 2048, 16, 12, CONV_P), f"conv engine geometry {cgeo}")
    xc, yc = datasets.make_bool_dataset(task, N_CONV + N_CONV_TEST,
                                        seed=args.seed + 300)
    xc = xc.reshape(-1, 28, 28)
    xc_tr, yc_tr = xc[:N_CONV], yc[:N_CONV]
    xc_te, yc_te = xc[N_CONV:], yc[N_CONV:]
    tm_c = api.TM(spec_cv, engine=eng_cv, seed=args.seed)
    pc0, rc0 = tm_c.program.to("cpu"), tm_c.prng.to("cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    hist_c = tm_c.fit(xc_tr, yc_tr, epochs=2, batch=32,
                      rng=np.random.default_rng(args.seed), sync_guard=True)
    torch.cuda.synchronize()
    fit_c_s = time.perf_counter() - t
    conv_fit_peak = torch.cuda.max_memory_allocated()   # with its capture
    counts_conv_fit = ops.launch_counts()
    steps_c = 2 * (N_CONV // 32)
    check(counts_conv_fit["packed_clause_tile"] == steps_c
          and counts_conv_fit["class_sum"] == steps_c
          and counts_conv_fit["lfsr_bits"] == 4 * steps_c
          and counts_conv_fit["fused_step"] == 0
          and counts_conv_fit["ta_update_sparse"] == 0
          and counts_conv_fit["ta_update"] == 0
          and counts_conv_fit["conv_ta_update"] == 2 * steps_c,
          f"the conv fit launched {counts_conv_fit}")
    check(eng_cv.cache_report()["path_per_stage"] == {
        "train_conv": "mxu_popcount", "train_conv_ta": "conv_ta"},
        f"conv paths {eng_cv.cache_report()}")
    check(all(0.0 <= h["train_acc"] <= 1.0 for h in hist_c)
          and len(hist_c) == 2, f"conv history {hist_c}")
    test_acc_c = tm_c.score(xc_te, yc_te)
    # the conv fit's first two steps, on the card and on the CPU engine
    plan_c = np.random.default_rng(args.seed).permutation(N_CONV).reshape(
        -1, 32)
    pg, rg, pc, rc = pc0.to("cuda"), rc0.to("cuda"), pc0, rc0
    conv_cpu_s = 0.0
    for s_ in range(2):
        xb, lab = xc_tr[plan_c[s_]], spec_cv.encode_labels(yc_tr[plan_c[s_]])
        pg, rg, sg = eng_cv.train_conv(pg, rg, eng_cv.encode(spec_cv, xb),
                                       lab.cuda())
        t = time.perf_counter()
        pc, rc, sc = cpu_cv.train_conv(pc, rc, cpu_cv.encode(spec_cv, xb),
                                       lab)
        conv_cpu_s += time.perf_counter() - t
        check(same_state(torch, pg, pc) and same_state(torch, rg, rc)
              and all(int(sg[k]) == int(sc[k]) for k in STAT_KEYS),
              f"conv fit step {s_} on the card differs from the CPU engine")
    # a conv bank of two tenants (the trained model, one from another
    # seed): stacked flushes against the CPU engine's, then edge requests
    conv_progs = {"conv_trained": tm_c.program.to("cpu"),
                  "conv_seed": cpu_cv.lower(spec_cv, threefry.key(
                      args.seed + 7, "cpu"))}

    def conv_server(engine, slot):
        srv = TMServer(engine, batch_slot=slot)
        for n, prog_ in conv_progs.items():
            srv.register(n, spec_cv, program=prog_)
        return srv

    creqs = {n: datasets.make_bool_dataset(task, CONV_ROUNDS * 32 + EDGE,
                                           seed=args.seed + 400 + i)[0]
             .reshape(-1, 28, 28) for i, n in enumerate(conv_progs)}
    cflush = conv_server(eng_cv, 32)
    ops.reset_launch_counts()
    c_answers, cflush_s = [], []
    for r in range(CONV_ROUNDS):
        for n in conv_progs:
            cflush.enqueue(n, creqs[n][r * 32:(r + 1) * 32])
        t = time.perf_counter()
        c_answers.append(cflush.flush())
        torch.cuda.synchronize()
        cflush_s.append(time.perf_counter() - t)
    counts_conv_flush = ops.launch_counts()
    check(counts_conv_flush["packed_clause_tile"] == CONV_ROUNDS
          and counts_conv_flush["class_sum"] == CONV_ROUNDS,
          f"conv flushes launched {counts_conv_flush}")
    cedge = conv_server(eng_cv, 1)
    ops.reset_launch_counts()
    c_edge, cedge_s = [], []
    for i in range(EDGE):
        xi = creqs["conv_trained"][CONV_ROUNDS * 32 + i:][:1]
        t = time.perf_counter()
        c_edge.append(cedge.predict("conv_trained", xi))
        cedge_s.append(time.perf_counter() - t)
    counts_conv_edge = ops.launch_counts()
    check(counts_conv_edge["packed_clause_tile"] == EDGE
          and counts_conv_edge["class_sum"] == EDGE
          and counts_conv_edge["packed_clause_eval"] == 0,
          f"conv edge requests launched {counts_conv_edge}")
    cref, cref_edge = conv_server(cpu_cv, 32), conv_server(cpu_cv, 1)
    for r in range(CONV_ROUNDS):
        for n in conv_progs:
            cref.enqueue(n, creqs[n][r * 32:(r + 1) * 32])
        want = cref.flush()
        for n in conv_progs:
            check(np.array_equal(c_answers[r][n], want[n]),
                  f"conv flush answers of {n} differ from the CPU engine")
    for i in range(EDGE):
        xi = creqs["conv_trained"][CONV_ROUNDS * 32 + i:][:1]
        check(np.array_equal(c_edge[i], cref_edge.predict("conv_trained",
                                                          xi)),
              "an edge conv answer differs from the CPU engine")
    check(cflush.stats()["cache"]["path_per_stage"]["infer_conv_bank"]
          == "mxu_popcount" and cedge.stats()["cache"]["path_per_stage"][
              "infer_conv"] == "mxu_popcount",
          f"conv serving paths {cflush.stats()['cache']}")
    # conv step time (host clock), a profiled conv step and conv flush
    lits_c = eng_cv.encode(spec_cv, xc_tr[:32])
    lab_c = spec_cv.encode_labels(yc_tr[:32]).cuda()
    conv_step_s = []
    for _ in range(5):
        t = time.perf_counter()
        eng_cv.train_conv(tm_c.program, tm_c.prng, lits_c, lab_c)
        torch.cuda.synchronize()
        conv_step_s.append(time.perf_counter() - t)
    conv_step_prof = profile_flush(torch, lambda: eng_cv.train_conv(
        tm_c.program, tm_c.prng, lits_c, lab_c), captures=3)
    for n in conv_progs:
        cflush.enqueue(n, creqs[n][:32])
    conv_flush_prof = profile_flush(torch, cflush.flush, captures=3)
    torch.cuda.reset_peak_memory_stats()
    eng_cv.train_conv(tm_c.program, tm_c.prng, lits_c, lab_c)
    torch.cuda.synchronize()
    conv_step_peak = torch.cuda.max_memory_allocated()

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
        tm_a.program, tm_a.prng, lits32, lab32), captures=3,
        need="fused_step")
    check(step_prof["fused_step_kernels"] == 1,
          f"the profiled step ran {step_prof['fused_step_kernels']} "
          "fused_step kernels")
    fs_prof = profile_flush(torch, lambda: fused_step(*f_a, **f_kw),
                            captures=3, need="fused_step")
    check(fs_prof["launches"] == 1 and fs_prof["fused_step_kernels"] == 1,
          f"a fused_step call launched {fs_prof['launches']} kernels "
          f"({fs_prof['kernels']})")
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

    # ---- 13. scheduled durable serving: api.serve on the card --------------
    sched_report, counts13, caps13, sched13, drain13 = scheduled_serving(
        torch, np, api, ops, datasets, roster, progs, cpu, card, args.seed)

    # ---- 14. threefry: the MNIST CoTM with prng_backend="threefry" --------
    tf_report, tf_launches, err_tf, tf_keys = threefry_phase(
        torch, np, api, ops, tm_paper, eng, eng_cpu, x_tr, y_tr, card,
        args.seed)

    # ---- 15. the forced plain datapath: compile(kernel_path="ref") --------
    ref_report = ref_phase(
        torch, np, api, ops, tile, server,
        {n: reqs[n][:B] for n in roster}, answers[0], eng, p0, r0, spec,
        x_tr, y_tr, (b_progs, b_prngs, b_lits, b_y),
        (bank.progs, bank.prngs, bst), card)

    # ---- 16. the session and bank executables as CUDA graphs ---------------
    graphs_report = graphs_phase(
        torch, np, api, ops,
        [("compact", eng, spec, x_tr, y_tr),
         ("dense", eng_dense, spec, x_tr, y_tr),
         ("mxu", eng_mxu, spec, x_tr, y_tr),
         ("stream", eng_stream, spec, x_tr, y_tr),
         ("conv", eng_cv, spec_cv, xc_tr, yc_tr),
         ("threefry", eng, paper_spec(api, tm_paper.TM_MNIST_COTM,
                                      "threefry"), x_tr, y_tr)],
        (eng, spec_c, x_tr, y_tr, eng_cv, spec_cv, xc_tr, yc_tr),
        (tile, specs, progs, reqs),
        (ctile, {n: spec_cv for n in conv_progs}, conv_progs, creqs),
        (sched_report["cycle_profile"], sched13,
         {n: reqs[n][:B] for n in roster}), card, args.seed)
    graphs_report["conv_fit_peak_bytes"] = conv_fit_peak

    # ---- 17. the served stage executables as CUDA graphs ------------------
    served_report = served_graphs_phase(
        torch, np, api, ops, datasets, roster, progs,
        (ctile, spec_cv, conv_progs, creqs), sched13, card, args.seed)

    # ---- 18. the plan cache, the launch checker, the audit, reconfiguration -
    tuned_report = tuned_phase(torch, np, api, ops, tm_paper, x_tr, y_tr,
                               card, args.seed)

    # ---- 19. pods: ShardedTM, PodBank and api.serve(mesh=) on NCCL ranks ----
    from repro_torch import convert
    specs13 = {n: paper_spec(api, c, "lfsr") for n, (c, _) in roster.items()}
    brng = np.random.default_rng(args.seed + 19)
    pods_inp = {
        "seed": args.seed, "train_spec": spec.to_dict(),
        "p0": convert.program_to_numpy(p0), "r0": convert.prng_to_numpy(r0),
        "train_batches": [(x_tr[i * 32:(i + 1) * 32],
                           y_tr[i * 32:(i + 1) * 32])
                          for i in range(POD_STEPS)],
        "specs": {n: s_.to_dict() for n, s_ in specs13.items()},
        "progs": {n: convert.program_to_numpy(progs[n]) for n in roster},
        "bank_x": {n: reqs[n][:B] for n in roster},
        "bank_y": np.stack([brng.integers(0, specs13[n].classes, B)
                            for n in roster]).astype(np.int32),
        "plan": drain13[0], "drain13": drain13[1],
        "legacy_batch": (x_tr[:64], y_tr[:64].astype(np.int32))}
    pods_report = pods_phase(
        torch, np, api, ops, pods_inp,
        {"serving roster": list(specs13.values()), "training model": [spec]},
        card)
    counts19 = pods_report["launches"]
    check(all(counts19[k] > 0 for k in (
        "packed_clause_eval", "packed_clause_tile", "class_sum", "fused_step",
        "ta_update_sparse", "ta_update", "clause_eval", "lfsr_bits",
        "threefry_bits")), f"the pod path launched {counts19}")
    # the TA update on the last of four clause windows of the roster's
    # train shape (row0 = 3R/4), against its plain version and the rows
    # of the full-width launch: the arguments of an eager KWS-6 Vanilla
    # step at the roster tile (700 x 6 = 4200 clause rows, so the window
    # gets feedback), not counted
    srv13 = sched13.server
    kv = srv13.tenants["kws6_vanilla"]
    xk, yk = datasets.make_bool_dataset(datasets.KWS6_LIKE, B,
                                        seed=args.seed + 1900)
    counted = ops.launch_counts()
    with Capture(ops, "ta_update_sparse") as cap_win:
        srv13.engine.train_step(
            kv.program, kv.prng,
            srv13.engine.encode(specs13["kws6_vanilla"], xk),
            specs13["kws6_vanilla"].encode_labels(yk).cuda())
        torch.cuda.synchronize()
    ops.set_launch_counts(counted)
    row0_w, r_loc_w, win_sparse, win_dense = ta_windows(
        torch, ops, copies(cap_win.args[0]), cap_win.args[1])
    w_t1 = win_sparse[0][0][3]
    check(int(win_sparse[0][0][8].sum()) > 0 and bool((w_t1 > 0).any()),
          "the window's rows got no Type I feedback")
    win_err = {}
    for name, kern, plain, ((wa, wkw), (fa, fkw)) in (
            ("ta_update_sparse", ta_update_sparse, ta_update_sparse_plain,
             win_sparse),
            ("ta_update", ta_update, ta_update_plain, win_dense)):
        got_w, win_err[name] = compare_all(kern, plain, wa, wkw)
        full = kern(*copies(fa), **fkw)
        torch.cuda.synchronize()
        check(all(torch.equal(g, f_[:, row0_w:])
                  for g, f_ in zip(got_w, full)),
              f"{name} on the window at row0={row0_w} differs from the "
              "full-width launch's rows")
    pods_report["ta_window"] = {"row0": row0_w, "r_loc": r_loc_w,
                                "max_abs_err": win_err}

    # ---- 20. the legacy variants, feedback_fit and AdamW, card vs CPU -------
    legacy_report, counts20, caps20 = legacy_phase(torch, np, ops, datasets,
                                                   card)

    # ---- 21. the examples/ mirrors: defaults on the card, card vs CPU -------
    examples_report, counts21, caps21 = examples_phase(torch, np, ops, card)

    # ---- 6. timing -------------------------------------------------------------
    cold = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    it = ITERS
    K, R, W, H = lits.shape[0], inc.shape[1], inc.shape[2], weights.shape[1]
    wf = weights.float()
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
            library_note=None, bare=None, nops_before=None, extra=None,
            iters=None):
        """One kernels-line entry.  The plain version is timed by graph
        replay, or (``plain_graph=False``: it reads the device on the
        host) with events around back-to-back calls.  ``rate`` is the
        operations rate of the bound (default: the integer rate).
        ``bare``: the kernel's bare launch, operands and scalars prepared
        outside the graph (``kernel_ms``); ``nops_before``: the operations
        of the earlier bound (``bound_ms_before``, ``ta_cost``);
        ``extra``: more keys of the row; ``iters``: calls a timing graph
        holds (default ``ITERS``)."""
        it = iters or ITERS
        b_ms, b_by = bound(nbytes, nops, rate or int_rate)
        extra = dict(extra or {})
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
        4 * (K * B * W + K * R * W + K * B * R),
        K * -(-B // 8) * -(-R // 16) * -(-W // 8), f"K={K} B={B} R={R} W={W}",
        rate=b1_rate, library_note=f"torch._int_mm x{K} on the unpacked "
        "operands (violation counts)",
        extra={"b1_mma_per_s": b1_rate,
               "b1_bit_macs_per_s": b1_rate * 16 * 8 * 256,
               "bound_ms_before": bound(
                   4 * (K * B * W + K * R * W + K * B * R),
                   K * B * R * W + K * B * R, int_rate)[0]})
    # packed_clause_eval: the serving edge request (the row), four requests
    # of one tenant and the edge training step; launches over edge serving
    # and edge training
    pe_lit, pe_inc = pe_a[:2]
    _, pe_B, pe_W = pe_lit.shape
    pe_R = pe_inc.shape[1]
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    edge_extra = {
        "floor_ms": graph_ms(torch, one.zero_, it),
        "ms_b4": graph_ms(torch, lambda: packed_clause_eval(
            lit4, inc1, True, L), it),
        "ms_cold_l2_b4": graph_ms(torch, lambda: packed_clause_eval(
            lit4, inc1, True, L), it // 4, cold),
        "bound_ms_b4": bound(4 * (4 * W + R * W + 4 * R), 4 * (R * W + R),
                             int_rate)[0],
        "shape_training": f"K=1 B={pe_B} R={pe_R} W={pe_W} "
                          f"eval_mode={pe_kw.get('eval_mode')}",
        "ms_training": graph_ms(torch, lambda: packed_clause_eval(
            *pe_a, **pe_kw), it),
        "ms_cold_l2_training": graph_ms(torch, lambda: packed_clause_eval(
            *pe_a, **pe_kw), it // 4, cold),
        "bound_ms_training": bound(
            4 * (pe_B * pe_W + pe_R * pe_W + pe_B * pe_R),
            pe_B * (pe_R * pe_W + pe_R), int_rate)[0]}
    row("packed_clause_eval", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:107",
        counts_edge["packed_clause_eval"]
        + counts_edge_train["packed_clause_eval"],
        max(err_edge, err_edge4, err_edge_train),
        lambda: packed_clause_eval(lit1, inc1, True, L),
        lambda: packed_clause_eval_plain(lit1, inc1, True, L), lib_edge,
        4 * (W + R * W + R), R * W + R, f"K=1 B=1 R={R} W={W}",
        library_note="torch.matmul float32, TF32 off, on the unpacked "
        "operands (violation counts)", extra=edge_extra)
    # class_sum: the serving bank (K=4) and the mxu fit's step (K=1); its
    # launches are every main path's: serving stacked, dense and edge, the
    # mxu fit and edge training
    cs_launches = (counts_stacked["class_sum"] + counts_edge["class_sum"]
                   + counts_dense_serve["class_sum"]
                   + counts_fit_mxu["class_sum"]
                   + counts_edge_train["class_sum"])
    cst_a = copies(cap_cs_train.args[0])
    _, err_cst = compare_one(class_sum, class_sum_plain, cst_a, {})
    for label, (c_, w_), err in (("serving", (cl, weights),
                                  max(err_sum, err_sum1)),
                                 ("training", cst_a, err_cst)):
        k_, b_, r_ = c_.shape
        h_ = w_.shape[1]
        c_f, w_f = c_.float(), w_.float()
        row("class_sum", cu + "class_sum.cu",
            "src/repro/kernels/class_sum.py:57", cs_launches, err,
            lambda c_=c_, w_=w_: class_sum(c_, w_),
            lambda c_=c_, w_=w_: class_sum_plain(c_, w_),
            lambda c_f=c_f, w_f=w_f: torch.matmul(c_f, w_f.transpose(-1, -2)),
            4 * (k_ * b_ * r_ + k_ * h_ * r_ + k_ * b_ * h_),
            k_ * b_ * r_ * h_, f"{label} K={k_} B={b_} R={r_} H={h_}")
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
        + counts_fit_stream["fused_step"] + counts_bank["fused_step"]
        + counts_bank_stream["fused_step"], err_front,
        lambda: fused_step(*f_a, **f_kw),
        lambda: fused_step_plain(*f_a, **f_kw), None,
        4 * (fK * fB * fW + fK * fR * fW + fK * fH * fR + 2 * fK * fB
             + 2 * fK * fB * fR + fK * fR + fK * fH + 2 * fK
             + 3 * fK * fB * fR + fK * fB * fH),
        fK * fB * fR * fW + fK * fB * fR + fired_front * fH
        + 2 * 3 * fK * fB * fR,
        f"K={fK} B={fB} R={fR} W={fW} H={fH}",
        bare=prepare_fused_step(*f_a, **f_kw)[0])
    # the step's glue at the fit's step: bytes of the operands read and the
    # outputs written (the prologue's selection words: 8 read, 4 written;
    # the epilogue's: cl, both selections, the weights, cl_mask, the sums
    # and the literals read; cl2, t1, t2, lit2 and the weights written); one
    # operation an output word
    p_a, p_kw = copies(cap_pro.args[0]), cap_pro.args[1]
    pK, pB = p_a[1].shape
    pR, pH = p_a[3].shape[-1], p_a[4].shape[1]
    row("step_prologue", cu + "step_glue.cu",
        "src/repro/core/dtm.py:528",
        counts_fit["step_prologue"] + counts_dense["step_prologue"]
        + counts_edge_train["step_prologue"] + counts_bank["step_prologue"],
        err_pro, lambda: step_prologue(*p_a, **p_kw),
        lambda: step_prologue_plain(*p_a, **p_kw), None,
        12 * 2 * pK * pB * pR + 8 * 3 * pK * pB + 4 * pK * pH + 24 * pK,
        2 * pK * pB * pR + 3 * pK * pB, f"K={pK} B={pB} R={pR} H={pH}",
        bare=prepare_step_prologue(*p_a, **p_kw)[0])
    e_a, e_kw = copies(cap_epi.args[0]), cap_epi.args[1]
    eK, eB, eW = e_a[0].shape
    eR, eH = e_a[1].shape[2], e_a[9].shape[1]
    row("step_epilogue", cu + "step_glue.cu",
        "src/repro/core/dtm.py:528",
        counts_fit["step_epilogue"] + counts_dense["step_epilogue"]
        + counts_edge_train["step_epilogue"] + counts_bank["step_epilogue"],
        err_epi, lambda: step_epilogue(*e_a, **e_kw),
        lambda: step_epilogue_plain(*e_a, **plain_kw(e_kw)), None,
        4 * (3 * eK * eB * eR + 2 * eK * eH * eR + eK * eR + eK * eB * eH
             + 3 * eK * eB * eW + 6 * eK * eB * eR),
        6 * eK * eB * eR + eK * eH * eR,
        f"K={eK} B={eB} R={eR} W={eW} H={eH} inplace={e_kw.get('inplace')}",
        bare=prepare_step_epilogue(*e_a, **e_kw)[0])

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
        f"({k_ + 1} calls: violation counts, then clauses x weights)",
        bare=prepare_tm_infer(*tmi_a, **tmi_kw)[0])
    # the lfsr cluster kernel at the conv step's largest draw (the row),
    # the conv patch draw and the flat step's selection draw, from the flat
    # fit's starting cluster; bound: the words' bytes, or `steps` dependent
    # Galois steps of one lane at the probe's clocks per step
    clk_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    step_clk = lfsr_step_clocks(torch, _build, tprng._TAPS[24])
    n_lanes = r0g.lanes.shape[-1]

    def lfsr_at(size, fn=lfsr_bits):
        return lambda: fn(r0g.lanes, r0g.master, r0g.cycles, size, 24, 16,
                          True)

    def lfsr_cost(size):
        """(bytes, steps): the int64 words written and the state read and
        written once; the cycles of one lane."""
        return 8 * size + 2 * 8 * (n_lanes + 2), -(-size // n_lanes)

    lfsr_sizes = {"ta_rand": 2 * 32 * 2048 * 384,
                  "patch_rand": 32 * CONV_P * 2048,
                  "flat_sel_rand": 2 * 32 * 2048}
    lfsr_extra = {"step_clocks": step_clk, "max_sm_clock_hz": clk_hz}
    for label in ("patch_rand", "flat_sel_rand"):
        size = lfsr_sizes[label]
        lfsr_extra[f"ms_{label}"] = graph_ms(torch, lfsr_at(size), 20)
        lfsr_extra[f"ms_cold_l2_{label}"] = graph_ms(torch, lfsr_at(size), 5,
                                                     cold)
        lfsr_extra[f"bound_ms_{label}"] = bound(*lfsr_cost(size),
                                                clk_hz / step_clk)[0]
        lfsr_extra[f"plain_ms_{label}"] = call_ms(
            torch, lfsr_at(size, lfsr_bits_plain), 2)
    lfsr_launches = sum(c["lfsr_bits"] for c in (
        counts_fit, counts_dense, counts_fit_mxu, counts_fit_stream,
        counts_edge_train, counts_bank, counts_bank_stream, counts_conv_fit))
    size = lfsr_sizes["ta_rand"]
    row("lfsr_bits", cu + "lfsr.cu", "src/repro/core/prng.py:222",
        lfsr_launches, err_lfsr, lfsr_at(size), lfsr_at(size, lfsr_bits_plain),
        None, *lfsr_cost(size),
        f"ta_rand K=1 size={size} lanes={n_lanes} steps={-(-size // n_lanes)}"
        " lfsr_bits=24 rand_bits=16", plain_graph=False,
        rate=clk_hz / step_clk, iters=20, extra=lfsr_extra)

    # the threefry kernel at the flat step's selection draw (the row) and
    # at the program draw: the TA words without the split, the weights'
    # with it; bound: the words' bytes, or THREEFRY_OPS a word
    def tf_at(keys, size, rb, split=True, fn=threefry_bits):
        return lambda: fn(keys, size, rb, split)

    def tf_cost(size):
        return 8 * size + 2 * 16, THREEFRY_OPS * size
    issue_rate = int_rate * ISSUE_PER_CLOCK_PER_SM / INT_OPS_PER_CLOCK_PER_SM
    tf_extra = {}
    for label, keys, size, split in (
            ("ta_draw", tf_keys["ta"], tf_keys["ta_words"], False),
            ("weight_draw", tf_keys["prog"], tf_keys["w_words"], True)):
        tf_extra[f"shape_{label}"] = f"K=1 size={size} rand_bits=1 " \
            f"split={split}"
        tf_extra[f"ms_{label}"] = graph_ms(torch, tf_at(keys, size, 1,
                                                        split), 20)
        tf_extra[f"ms_cold_l2_{label}"] = graph_ms(
            torch, tf_at(keys, size, 1, split), 5, cold)
        tf_extra[f"bound_ms_{label}"] = bound(*tf_cost(size), issue_rate)[0]
        tf_extra[f"plain_ms_{label}"] = call_ms(
            torch, tf_at(keys, size, 1, split, threefry_bits_plain), 3)
    size = tf_keys["sel"]
    row("threefry_bits", cu + "threefry.cu",
        "no Pallas: src/repro/core/prng.py:214-220",
        tf_launches + counts13["threefry_bits"], err_tf,
        tf_at(tf_keys["fit"], size, 16),
        tf_at(tf_keys["fit"], size, 16, fn=threefry_bits_plain), None,
        *tf_cost(size), f"sel_rand K=1 size={size} rand_bits=16 split=True",
        plain_graph=False, rate=issue_rate, extra=tf_extra)

    # packed_clause_tile and class_sum at the conv shapes: the conv flush
    # (K=2, B·P = 11,552 rows), the conv train step (K=1, train mode) and
    # the edge conv request (K=1, 361 rows)
    cbank = api.stack([conv_progs[n].to("cuda") for n in conv_progs], eng_cv,
                      conv=True)
    clits = torch.stack([eng_cv.encode(spec_cv, creqs[n][:32])
                         for n in conv_progs])
    cK, cB, cP, cW = clits.shape
    cv = clits.reshape(cK, cB * cP, cW)
    cinc, cwt, cL = cbank.progs.inc, cbank.progs.weights, eng_cv.L
    cR, cH = cinc.shape[1], cwt.shape[1]
    _, err_ct = compare(packed_clause_tile, packed_clause_tile_plain, cv,
                        cinc, True, cL)
    ct_train = (cv[:1].contiguous(), cinc[:1], False, cL)
    ct_edge = (cv[:1, :cP].contiguous(), cinc[:1], True, cL)
    _, err_ct_t = compare(packed_clause_tile, packed_clause_tile_plain,
                          *ct_train)
    _, err_ct_e = compare(packed_clause_tile, packed_clause_tile_plain,
                          *ct_edge)

    def tile_cost(k_, b_):
        return (4 * (k_ * b_ * cW + k_ * cR * cW + k_ * b_ * cR),
                k_ * -(-b_ // 8) * -(-cR // 16) * -(-cW // 8))
    conv_tile_launches = sum(c["packed_clause_tile"] for c in (
        counts_conv_fit, counts_conv_flush, counts_conv_edge))
    cneg8 = (unpack_literals(cv, cL) == 0).to(torch.int8)
    cinc8 = unpack_literals(cinc, cL)
    row("packed_clause_tile", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:184", conv_tile_launches,
        max(err_ct, err_ct_t, err_ct_e),
        lambda: packed_clause_tile(cv, cinc, True, cL),
        lambda: packed_clause_tile_plain(cv, cinc, True, cL),
        yardstick(int_mm(cneg8, cinc8), "_int_mm"), *tile_cost(cK, cB * cP),
        f"conv serving K={cK} B={cB * cP} (B={cB} x P={cP}) R={cR} W={cW}",
        rate=b1_rate, library_note=f"torch._int_mm x{cK} on the unpacked "
        "operands (violation counts)",
        extra={"ms_training": graph_ms(
                   torch, lambda: packed_clause_tile(*ct_train), it),
               "ms_cold_l2_training": graph_ms(
                   torch, lambda: packed_clause_tile(*ct_train), it // 4,
                   cold),
               "bound_ms_training": bound(*tile_cost(1, cB * cP),
                                          b1_rate)[0],
               "ms_edge": graph_ms(
                   torch, lambda: packed_clause_tile(*ct_edge), it),
               "ms_cold_l2_edge": graph_ms(
                   torch, lambda: packed_clause_tile(*ct_edge), it // 4,
                   cold),
               "bound_ms_edge": bound(*tile_cost(1, cP), b1_rate)[0]})
    _, ccl = eng_cv.infer_conv_bank(cbank.progs, clits)
    _, err_ccs = compare(class_sum, class_sum_plain, ccl, cwt)
    ccl1 = ccl[:1, :1].contiguous()
    _, err_ccs1 = compare(class_sum, class_sum_plain, ccl1, cwt[:1])
    ccl_f, cwt_f = ccl.float(), cwt.float()
    row("class_sum", cu + "class_sum.cu", "src/repro/kernels/class_sum.py:57",
        sum(c["class_sum"] for c in (counts_conv_fit, counts_conv_flush,
                                     counts_conv_edge)),
        max(err_ccs, err_ccs1), lambda: class_sum(ccl, cwt),
        lambda: class_sum_plain(ccl, cwt),
        lambda: torch.matmul(ccl_f, cwt_f.transpose(-1, -2)),
        4 * (cK * cB * cR + cK * cH * cR + cK * cB * cH), cK * cB * cR * cH,
        f"conv serving K={cK} B={cB} R={cR} H={cH}",
        library_note="torch.matmul float32",
        extra={"ms_edge": graph_ms(torch, lambda: class_sum(ccl1, cwt[:1]),
                                   it)})
    # the scheduled path's shapes (phase 13): the tile and class sums of
    # the resident bank (K=2) and the cold path (K=1), training at the
    # roster tile (fused_step, ta_update_sparse, the selection draw)
    def by_k(cap):
        """The captured calls of one wrapper, most programs first."""
        return sorted(cap.by_shape.values(), key=lambda c: -c[0][0].shape[0])

    t_calls = by_k(caps13["packed_clause_tile"])
    err_t13 = max(compare_one(packed_clause_tile, packed_clause_tile_plain,
                              *c_)[1] for c_ in t_calls)
    (t_a, t_kw), t_cold = t_calls[0], t_calls[-1]
    tK, tB, tW = t_a[0].shape
    tR = t_a[1].shape[1]
    c1_a, c1_kw = t_cold
    c1K, c1B = c1_a[0].shape[:2]
    t_neg8 = (unpack_literals(t_a[0], L) == 0).to(torch.int8)
    row("packed_clause_tile", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:184",
        counts13["packed_clause_tile"], err_t13,
        lambda: packed_clause_tile(*t_a, **t_kw),
        lambda: packed_clause_tile_plain(*t_a, **t_kw),
        yardstick(int_mm(t_neg8, unpack_literals(t_a[1], L)), "_int_mm"),
        4 * (tK * tB * tW + tK * tR * tW + tK * tB * tR),
        tK * -(-tB // 8) * -(-tR // 16) * -(-tW // 8),
        f"scheduled K={tK} B={tB} R={tR} W={tW}", rate=b1_rate,
        library_note=f"torch._int_mm x{tK} on the unpacked operands "
        "(violation counts)",
        extra={"shape_cold_path": f"K={c1K} B={c1B}",
               "ms_cold_path": graph_ms(torch, lambda: packed_clause_tile(
                   *c1_a, **c1_kw), it),
               "bound_ms_cold_path": bound(
                   4 * (c1K * c1B * tW + c1K * tR * tW + c1K * c1B * tR),
                   c1K * -(-c1B // 8) * -(-tR // 16) * -(-tW // 8),
                   b1_rate)[0]})
    s_calls = by_k(caps13["class_sum"])
    err_s13 = max(compare_one(class_sum, class_sum_plain, *c_)[1]
                  for c_ in s_calls)
    (sc_a, _), (sc1_a, _) = s_calls[0], s_calls[-1]
    sK, sB, sR = sc_a[0].shape
    sH = sc_a[1].shape[1]
    sc_f, sw_f = sc_a[0].float(), sc_a[1].float()
    row("class_sum", cu + "class_sum.cu", "src/repro/kernels/class_sum.py:57",
        counts13["class_sum"], err_s13, lambda: class_sum(*sc_a),
        lambda: class_sum_plain(*sc_a),
        lambda: torch.matmul(sc_f, sw_f.transpose(-1, -2)),
        4 * (sK * sB * sR + sK * sH * sR + sK * sB * sH), sK * sB * sR * sH,
        f"scheduled K={sK} B={sB} R={sR} H={sH}",
        library_note="torch.matmul float32",
        extra={"shape_cold_path": f"K={sc1_a[0].shape[0]}",
               "ms_cold_path": graph_ms(torch, lambda: class_sum(*sc1_a),
                                        it)})
    f13_a, f13_kw = caps13["fused_step"].args     # MNIST CoTM's last step
    front13, err_f13 = compare_all(fused_step, fused_step_plain, f13_a,
                                   f13_kw)
    gl, gi, gw = f13_a[0], f13_a[1], f13_a[2]
    gK, gB, gW = gl.shape
    gR, gH = gi.shape[1], gw.shape[1]
    _, smem_fn = _build.entry("fused_step", "dtm_fused_step_smem",
                              [ctypes.c_int] * 3, ctypes.c_size_t)
    bulk13 = fused_bulk(gW, gR, all(f13_a[i].data_ptr() % 16 == 0
                                    for i in (1, 2, 5, 6)),
                        smem_fn(gH, gW, 1))
    row("fused_step", cu + "fused_step.cu",
        "src/repro/kernels/fused_step.py:150", counts13["fused_step"],
        err_f13, lambda: fused_step(*f13_a, **f13_kw),
        lambda: fused_step_plain(*f13_a, **f13_kw), None,
        4 * (gK * gB * gW + gK * gR * gW + gK * gH * gR + 2 * gK * gB
             + 2 * gK * gB * gR + gK * gR + gK * gH + 2 * gK
             + 3 * gK * gB * gR + gK * gB * gH),
        gK * gB * gR * gW + gK * gB * gR + int(front13[0].sum()) * gH
        + 2 * 3 * gK * gB * gR,
        f"scheduled roster tile K={gK} B={gB} R={gR} W={gW} H={gH} "
        f"bulk={bulk13}",
        bare=prepare_fused_step(*f13_a, **f13_kw)[0])
    s13_a, s13_kw = caps13["ta_update_sparse"].args
    s13_a = copies(s13_a)
    _, err_sp13 = compare_all(ta_update_sparse, ta_update_sparse_plain,
                              s13_a, s13_kw)
    k_, c_, l_ = s13_a[0].shape
    nb, no = ta_cost(s13_a, s13_kw, sparse=True)
    row("ta_update_sparse", cu + "ta_update.cu",
        "src/repro/kernels/ta_update.py:238", counts13["ta_update_sparse"],
        err_sp13, lambda: ta_update_sparse(*s13_a, **s13_kw),
        lambda: ta_update_sparse_plain(*s13_a, **s13_kw), None, nb, no,
        f"scheduled roster tile K=1 2B={s13_a[1].shape[1]} C={c_} L={l_} "
        f"active_groups={int(s13_a[8].sum())}/{-(-c_ // 128)} "
        f"prng={s13_kw['prng']} inplace={s13_kw.get('inplace', False)}",
        plain_graph=False, bare=prepare_ta_update_sparse(*s13_a, **s13_kw)[0],
        nops_before=ta_cost(s13_a, s13_kw, sparse=True, earlier=True)[1])
    size13 = 2 * 32 * gR                      # the selection draw at R
    err_l13 = 0
    for g, w in zip(lfsr_at(size13)(), lfsr_at(size13, lfsr_bits_plain)()):
        check(torch.equal(g, w), "lfsr_bits differs from its plain loop at "
              "the scheduled selection draw")
        err_l13 = max(err_l13, int((g - w).abs().max()))
    row("lfsr_bits", cu + "lfsr.cu", "src/repro/core/prng.py:222",
        counts13["lfsr_bits"], err_l13, lfsr_at(size13),
        lfsr_at(size13, lfsr_bits_plain), None, *lfsr_cost(size13),
        f"scheduled sel_rand K=1 size={size13} lanes={n_lanes} "
        f"steps={-(-size13 // n_lanes)} lfsr_bits=24 rand_bits=16",
        plain_graph=False, rate=clk_hz / step_clk, iters=20)
    check(all(counts13[k] > 0 for k in (
        "packed_clause_tile", "class_sum", "fused_step", "ta_update_sparse",
        "lfsr_bits")), f"the scheduled path launched {counts13}")
    # the pod window rows: the TA update of the last of four clause shards
    # at the roster's train shape.  Phase 19's pod path never runs that
    # shape (its clause-sharded steps are the training model's, its bank
    # trains at full R), so ``launches`` is 0; ``path_launches`` counts
    # the kernel's launches on the pod path at its own shapes
    w19 = pods_report["world"]
    for name, kern, plain, prep, ((wa, wkw), (fa, fkw)), sparse, line in (
            ("ta_update_sparse", ta_update_sparse, ta_update_sparse_plain,
             prepare_ta_update_sparse, win_sparse, True, 238),
            ("ta_update", ta_update, ta_update_plain, prepare_ta_update,
             win_dense, False, 285)):
        k_, c_, l_ = wa[0].shape
        nb, no = ta_cost(wa, wkw, sparse=sparse)
        row(name, cu + "ta_update.cu", f"src/repro/kernels/ta_update.py:"
            f"{line}", 0, win_err[name],
            lambda k=kern, a=wa, kw=wkw: k(*a, **kw),
            lambda p_=plain, a=wa, kw=wkw: p_(*a, **kw), None, nb, no,
            f"pod window row0={row0_w} of R={fa[0].shape[1]} K={k_} "
            f"2B={wa[1].shape[1]} C={c_} L={l_} prng={wkw['prng']}"
            + (f" active_groups={int(wa[8].sum())}/{-(-c_ // 128)}"
               if sparse else ""),
            plain_graph=False, bare=prep(*wa, **wkw)[0],
            extra={"path_launches": counts19[name],
                   "path_launches_shapes": (
                       f"phase 19 at world {w19}: ShardedTM train steps "
                       f"of the training model at r_loc={2048 // w19}, "
                       f"row0=rank*r_loc, and PodBank.train of "
                       f"{pods_report['bank']['slots_per_rank']} roster "
                       f"slots a rank at full R"),
                   "full_width_ms": graph_ms(
                       torch, lambda k=kern, a=fa, kw=fkw: k(*a, **kw), it),
                   "full_width_bound_ms": bound(
                       *ta_cost(fa, fkw, sparse=sparse), int_rate)[0]})

    # phase 20's kernels at its shapes (fig 7's feedback_fit with
    # compute_backend="pallas"): the edge clause kernel of a sequential
    # datapoint (B=1), the dense clause kernel of a batched step (B=64),
    # threefry_bits at a sequential datapoint's TA draw; launches are
    # phase 20's, counted from 0 just before it
    lp_a, lp_kw = copies(caps20["packed_clause_eval"][0]), \
        caps20["packed_clause_eval"][1]
    _, err_lp = compare_one(packed_clause_eval, packed_clause_eval_plain,
                            lp_a, lp_kw)
    lk, lb, lw = lp_a[0].shape
    lr, lbits = lp_a[1].shape[1], lp_kw.get("n_bits") or 32 * lw
    lneg = (unpack_literals(lp_a[0], lbits) == 0).to(torch.float32)
    linc = unpack_literals(lp_a[1], lbits).to(torch.float32)
    row("packed_clause_eval", cu + "packed_clause.cu",
        "src/repro/kernels/packed_clause.py:107",
        counts20["packed_clause_eval"], err_lp,
        lambda: packed_clause_eval(*lp_a, **lp_kw),
        lambda: packed_clause_eval_plain(*lp_a, **lp_kw),
        yardstick(lambda: torch.matmul(lneg, linc.transpose(-1, -2)),
                  "matmul"),
        4 * (lb * lw + lr * lw + lb * lr), lb * (lr * lw + lr),
        f"legacy feedback_fit sequential K={lk} B={lb} R={lr} W={lw} "
        f"n_bits={lbits} eval_mode={lp_kw.get('eval_mode')}",
        library_note="torch.matmul float32, TF32 off, on the unpacked "
        "operands (violation counts)")
    lc_a, lc_kw = copies(caps20["clause_eval"][0]), caps20["clause_eval"][1]
    _, err_lc = compare_one(clause_eval, clause_eval_plain, lc_a, lc_kw)
    k_, b_, l_ = lc_a[0].shape
    c_ = lc_a[1].shape[1]
    row("clause_eval", cu + "clause_eval.cu",
        "src/repro/kernels/clause_eval.py:72", counts20["clause_eval"],
        err_lc, lambda: clause_eval(*lc_a, **lc_kw),
        lambda: clause_eval_plain(*lc_a, **lc_kw),
        yardstick(int_mm((lc_a[0] == 0).to(torch.int8), lc_a[1]), "_int_mm"),
        k_ * b_ * l_ + k_ * c_ * l_ + 4 * k_ * b_ * c_, 2 * k_ * b_ * c_ * l_,
        f"legacy feedback_fit batched K={k_} B={b_} C={c_} L={l_} "
        f"eval_mode={lc_kw.get('eval_mode')}", rate=INT8_TC_OPS_PER_S,
        library_note=f"torch._int_mm x{k_} (violation counts)")
    lkey = threefry.key(args.seed, "cuda")
    lsize = 2 * 128 * 2 * 784            # a datapoint's ta_rand, fig 7
    _, err_ltf = compare_all(threefry_bits, threefry_bits_plain,
                             (lkey, lsize, 16), {})
    row("threefry_bits", cu + "threefry.cu",
        "no Pallas: src/repro/core/prng.py:214-220",
        counts20["threefry_bits"], err_ltf, tf_at(lkey, lsize, 16),
        tf_at(lkey, lsize, 16, fn=threefry_bits_plain), None,
        *tf_cost(lsize), f"legacy feedback_fit ta_rand K=1 size={lsize} "
        "rand_bits=16 split=True", plain_graph=False, rate=issue_rate)

    # phase 21's training kernels at the quickstart mirror's shapes (the
    # MNIST geometry, 256 clauses, batch 32), their arguments from its
    # epoch graph's warm-up; launches are phase 21's, counted from 0 just
    # before it
    f21_a, f21_kw = caps21["fused_step"]
    front21, err_f21 = compare_all(fused_step, fused_step_plain, f21_a,
                                   f21_kw)
    hK, hB, hW = f21_a[0].shape
    hR, hH = f21_a[1].shape[1], f21_a[2].shape[1]
    row("fused_step", cu + "fused_step.cu",
        "src/repro/kernels/fused_step.py:150", counts21["fused_step"],
        err_f21, lambda: fused_step(*f21_a, **f21_kw),
        lambda: fused_step_plain(*f21_a, **f21_kw), None,
        4 * (hK * hB * hW + hK * hR * hW + hK * hH * hR + 2 * hK * hB
             + 2 * hK * hB * hR + hK * hR + hK * hH + 2 * hK
             + 3 * hK * hB * hR + hK * hB * hH),
        hK * hB * hR * hW + hK * hB * hR + int(front21[0].sum()) * hH
        + 2 * 3 * hK * hB * hR,
        f"examples quickstart K={hK} B={hB} R={hR} W={hW} H={hH}",
        bare=prepare_fused_step(*f21_a, **f21_kw)[0])
    s21_a, s21_kw = copies(caps21["ta_update_sparse"][0]), \
        caps21["ta_update_sparse"][1]
    _, err_sp21 = compare_all(ta_update_sparse, ta_update_sparse_plain,
                              s21_a, s21_kw)
    k_, c_, l_ = s21_a[0].shape
    nb, no = ta_cost(s21_a, s21_kw, sparse=True)
    row("ta_update_sparse", cu + "ta_update.cu",
        "src/repro/kernels/ta_update.py:238", counts21["ta_update_sparse"],
        err_sp21, lambda: ta_update_sparse(*s21_a, **s21_kw),
        lambda: ta_update_sparse_plain(*s21_a, **s21_kw), None, nb, no,
        f"examples quickstart K={k_} 2B={s21_a[1].shape[1]} C={c_} L={l_} "
        f"active_groups={int(s21_a[8].sum())}/{-(-c_ // 128)} "
        f"prng={s21_kw['prng']} inplace={s21_kw.get('inplace', False)}",
        plain_graph=False,
        bare=prepare_ta_update_sparse(*s21_a, **s21_kw)[0])

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

    # the streamed TA update: the streamed fit's first step (K=1, lfsr) and
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
        "steps_per_s": {"compact": steps / fit_s, "dense": steps / fit_d_s},
        "step_ms_median": float(np.median(step_s) * 1e3),
        "edge_step_ms_median": float(np.median(edge_train_s) * 1e3),
        "skip_frac": tm_a.skip_frac,
        "ta_ms_by_listed_groups": ta_ms_by_groups,
        "train_acc": [h["train_acc"] for h in hist],
        "group_skip_frac": [h["group_skip_frac"] for h in hist],
        "test_acc": test_acc, "step_profile": step_prof,
        "fused_step_call_profile": fs_prof,
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
    conv = {
        "card": card, "model": "conv CoTM on 28x28, 10x10 window (361 "
        "patches, 136 features), 2000 clauses, 10 classes, T=500, s=10, "
        "ta_bits 8, lfsr_bits 24, rand_bits 16",
        "engine": {"L": eng_cv.L, "R": eng_cv.R, "H": eng_cv.H,
                   "W": eng_cv.W, "P": eng_cv.P},
        "rows": {"train": N_CONV, "test": N_CONV_TEST}, "batch": 32,
        "fit_s": fit_c_s, "steps_per_s": 2 * (N_CONV // 32) / fit_c_s,
        "step_ms_median": float(np.median(conv_step_s) * 1e3),
        "step_ms": [s_ * 1e3 for s_ in conv_step_s],
        "step_peak_bytes": conv_step_peak,
        "step_profile": conv_step_prof,
        "flush_ms": [s_ * 1e3 for s_ in cflush_s],
        "flush_profile": conv_flush_prof,
        "edge_predict_ms": [s_ * 1e3 for s_ in cedge_s],
        "edge_predict_ms_median": float(np.median(cedge_s) * 1e3),
        "train_acc": [h["train_acc"] for h in hist_c],
        "test_acc": test_acc_c, "cpu_reference_s": conv_cpu_s,
        "launches": {"fit": counts_conv_fit, "flush": counts_conv_flush,
                     "edge": counts_conv_edge}}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"conv": conv}))
    print(json.dumps({"scheduler": sched_report}))
    print(json.dumps({"threefry": tf_report}))
    print(json.dumps({"ref_path": ref_report}))
    print(json.dumps({"graphs": graphs_report}))
    print(json.dumps({"served_graphs": served_report}))
    print(json.dumps({"tuned": tuned_report}))
    print(json.dumps({"pods": pods_report}))
    print(json.dumps({"legacy": legacy_report}))
    print(json.dumps({"examples": examples_report}))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
