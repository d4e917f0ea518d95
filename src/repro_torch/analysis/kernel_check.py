"""Static CUDA launch checker for the port's kernels (``kernels`` command).

The port's counterpart of ``repro/analysis/kernel_check.py``, retargeted
from Pallas block specs and VMEM at CUDA launch geometry.  For every
kernel wrapper of ``repro_torch/kernels/`` it rebuilds the launch the
wrapper would make, from the wrapper's own pure split functions and
constants (``edge_geometry``, ``tile_warps``, ``class_sum_split``,
``fused_split``/``fused_bulk``, ``clause_split``, ``sparse_blocks``/
``sparse_smem``) and the launch arithmetic of ``csrc/*.cu`` restated
here (its shared-memory layouts), and verifies WITHOUT a card:

* **threads**: at most ``max_threads_per_block`` threads a block;
* **smem**: dynamic (plus static) shared memory within the block limit
  the kernel opts into (``fused_step.SMEM_LIMIT``, the hardware's
  opt-in limit for the kernels that raise theirs) or, for a kernel that
  never opts in, the default 48 KB (``ta_update._SMEM_LIMIT``);
* **cluster**: a thread-block cluster of at most 8 blocks, or 16 where
  the kernel sets the non-portable attribute (``class_sum``,
  ``fused_step``: ``MAX_CLUSTER = 16``), and a grid x that is a multiple
  of the cluster;
* **grid**: ``grid.y`` and ``grid.z`` within 65,535;
* **coverage**: along every axis of the output (and of an axis a cluster
  reduces), each element is covered by exactly one block, cluster or
  grid-stride turn: none uncovered, none twice.

It also reports a **finding** (not a violation): the work items a block
takes, max against mean, where one block takes at least 1.5 times the
mean (``fused_step`` at R = 4224: 17 clause tiles on a 16-block cluster,
so block 0 runs two).

The audit space is the JAX checker's: its ``_audit_shapes`` (the
autotune bench grid and the paper tiles), plus the card's two widths
(the serving roster L=3200, R=4224, H=16 and the MNIST CoTM's training
width L=1664, R=2048, H=16), its ``AUDIT_BATCHES`` and
``STREAMED_BATCHES``, and K in {1, 4}.  Every kernel of every path the
autotuner can emit (each stage's ``measure`` candidates, a superset of
the ``seed`` plans) is planned at every bucket; the PRNG kernels at the
engine's draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.launch.mesh import H100, HardwareModel

__all__ = ["Cover", "LaunchPlan", "Violation", "Finding", "check_plan",
           "balance", "build_plans", "check_all", "main"]

# csrc launch arithmetic restated (each constant names its source)
EDGE_ROWS = 4                 # packed_clause.cu kEdgeRows
TILE_RING_STAGES = 4          # packed_clause.cu kRingStages
TILE_ROW_WORDS = 36           # packed_clause.cu kRowWords (32 + 4)
CE_THREADS = 128              # clause_eval.cu kThreads
CE_RING_BYTES = 4 * 4 * 32 * (128 + 16)   # kWarps · kStages · kStageBytes
CE_WORDS_PER_CHUNK = 4        # clause_eval.cu kWordsPerChunk
CE_STATIC_BYTES = 8 * 8 * 128  # s_part: kMaxSplits · kTileC u64
TM_INFER_EPI_BYTES = (16 * 129 + 32 * 4) * 4   # ClassSums::kSmem
CS_THREADS = 128              # class_sum.cu kThreads
FS_THREADS = 256              # fused_step.cu kThreads (= kTile)
FS_WCHUNK = 64                # fused_step.cu kWChunk
FS_WSTRIDE = 256 + 4          # fused_step.cu kWStride
FS_CLASSES = 16               # fused_step.cu kClasses
TA_THREADS = 128              # ta_update.cu kThreads
TA_ITEM_WORDS = 8             # 4 warps × kWordsPerItem words an item
LFSR_THREADS = 64             # lfsr.cu kThreads
TF_THREADS = 256              # threefry.cu kThreads
TF_BLOCKS_PER_SM = 8          # threefry.cu kBlocksPerSm
TF_SMS = 132                  # threefry.cu kSms
DEFAULT_SMEM = 48 * 1024      # without cudaFuncAttributeMaxDynamicSharedMemorySize
BALANCE = 1.5                 # max/mean work a block at which a finding fires


@dataclasses.dataclass(frozen=True)
class Cover:
    """One axis of the output (or of a reduced input): its extent and the
    half-open ranges each writer (block, cluster or grid-stride turn)
    covers along it."""
    name: str
    extent: int
    spans: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    kernel: str
    desc: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int = 0                 # dynamic shared memory, bytes
    smem_limit: int = DEFAULT_SMEM
    static_smem: int = 0
    cluster: int = 1
    nonportable: bool = False
    covers: Tuple[Cover, ...] = ()
    work: Tuple[int, ...] = ()    # work items per block (balance finding)


@dataclasses.dataclass(frozen=True)
class Violation:
    kernel: str
    desc: str
    kind: str         # threads | smem | cluster | grid | coverage
    detail: str

    def render(self) -> str:
        return f"{self.kernel} [{self.desc}] {self.kind}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Finding:
    kernel: str
    desc: str
    max_work: int
    mean_work: float

    def render(self) -> str:
        return (f"{self.kernel} [{self.desc}] balance: a block takes "
                f"{self.max_work} work items against a mean of "
                f"{self.mean_work:.3g}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocks_of(n: int, size: int) -> Tuple[Tuple[int, int], ...]:
    """Consecutive ranges of ``size`` over ``n``: one per writer."""
    return tuple((i, min(n, i + size)) for i in range(0, n, size))


def _strided(n: int, writers: int) -> List[List[int]]:
    """The items each of ``writers`` takes in a stride of ``writers``."""
    return [list(range(w, n, writers)) for w in range(writers)]


# --------------------------------------------------------------------------- #
# plan builders: one per kernel wrapper                                       #
# --------------------------------------------------------------------------- #

def plan_edge(K, B, R, W, sms, geometry=None) -> LaunchPlan:
    from repro_torch.kernels.packed_clause import edge_geometry
    lanes, rpw, warps, (blocks, groups) = edge_geometry(
        B, R, W, sms, **(geometry or {}))
    return LaunchPlan(
        "packed_clause_eval",
        f"K{K} B{B} R{R} W{W} lanes{lanes} warps{warps}",
        (blocks, groups, K), 32 * warps,
        covers=(Cover("R", R, _blocks_of(R, rpw * warps)[:blocks]),
                Cover("B", B, _blocks_of(B, EDGE_ROWS)[:groups])))


def plan_tile(K, B, R, W, sms, hw=H100, geometry=None) -> LaunchPlan:
    from repro_torch.kernels.packed_clause import MMA_ROWS, TILE_B, tile_warps
    warps = (geometry or {}).get("warps") or tile_warps(K, B, R, sms)
    rows = MMA_ROWS * warps
    smem = 4 * TILE_RING_STAGES * (rows + TILE_B) * TILE_ROW_WORDS
    return LaunchPlan(
        "packed_clause_tile", f"K{K} B{B} R{R} W{W} warps{warps}",
        (_cdiv(R, rows), _cdiv(B, TILE_B), K), 32 * warps, smem,
        hw.smem_per_block_optin,
        covers=(Cover("R", R, _blocks_of(R, rows)),
                Cover("B", B, _blocks_of(B, TILE_B))))


def plan_class_sum(K, B, R, H, sms, hw=H100) -> LaunchPlan:
    from repro_torch.kernels.class_sum import MAX_CLASSES, class_sum_split
    rows, cs, span = class_sum_split(K, B, R, sms)
    spans = tuple((q * span, min(R, (q + 1) * span)) for q in range(cs))
    return LaunchPlan(
        "class_sum", f"K{K} B{B} R{R} H{H} cs{cs}",
        (cs, _cdiv(B, rows), K), CS_THREADS, 4 * rows * min(H, MAX_CLASSES),
        hw.smem_per_block_optin, cluster=cs, nonportable=True,
        covers=(Cover("R (reduced)", R, spans),
                Cover("B", B, _blocks_of(B, rows))),
        work=tuple(max(0, hi - lo) for lo, hi in spans))


def fused_smem(H: int, W: int, bulk: bool) -> int:
    """``dtm_fused_step_smem`` (csrc/fused_step.cu ``Layout``): the
    include rows, the literal words, a tile's weights, random words,
    cl_mask, h_mask and the partial class sums, in bytes."""
    from repro_torch.kernels.fused_step import ROWS, TILE
    chunk, stride = (W, W) if bulk else (FS_WCHUNK, FS_WCHUNK + 1)
    words = (TILE * stride + ((chunk + 7) & ~7) * ROWS
             + FS_CLASSES * FS_WSTRIDE + 2 * ROWS * TILE + TILE + H
             + ROWS * H)
    return 4 * words


def plan_fused(K, B, R, W, H, geometry=None) -> LaunchPlan:
    from repro_torch.kernels.fused_step import (ROWS, SMEM_LIMIT, TILE,
                                                fused_bulk, fused_split)
    cs = (geometry or {}).get("cluster") or fused_split(R)
    bulk = fused_bulk(W, R, True, fused_smem(H, W, True))
    tiles = _strided(_cdiv(R, TILE), cs)
    spans = tuple((t * TILE, min(R, (t + 1) * TILE))
                  for q in tiles for t in q)
    return LaunchPlan(
        "fused_step", f"K{K} B{B} R{R} W{W} H{H} cs{cs} bulk{int(bulk)}",
        (cs, _cdiv(B, ROWS), K), FS_THREADS, fused_smem(H, W, bulk),
        SMEM_LIMIT, cluster=cs, nonportable=True,
        covers=(Cover("R", R, spans), Cover("B", B, _blocks_of(B, ROWS))),
        work=tuple(len(q) for q in tiles))


def _clause_stream(kernel, K, B, C, L, sms, epi_bytes, hw, extra=""):
    from repro_torch.kernels.clause_eval import (CHUNK, MAX_CHUNKS, TILE_B,
                                                 TILE_C, clause_split)
    splits, cps = clause_split(K, B, C, L, sms)
    nchunks = max(_cdiv(L, CHUNK), 1)
    parts = [(s * cps, min(nchunks, (s + 1) * cps)) for s in range(splits)]
    smem = (CE_RING_BYTES + epi_bytes
            + min(cps, MAX_CHUNKS) * CE_WORDS_PER_CHUNK * TILE_B * 4)
    return LaunchPlan(
        kernel, f"K{K} B{B} L{L} C{C}{extra} splits{splits} cps{cps}",
        (_cdiv(C, TILE_C) * splits, _cdiv(B, TILE_B), K), CE_THREADS, smem,
        hw.smem_per_block_optin, CE_STATIC_BYTES, cluster=splits,
        covers=(Cover("C", C, _blocks_of(C, TILE_C)),
                Cover("L (reduced)", L, tuple(
                    (lo * CHUNK, min(L, hi * CHUNK)) for lo, hi in parts)),
                Cover("B", B, _blocks_of(B, TILE_B))),
        work=tuple(hi - lo for lo, hi in parts))


def plan_clause_eval(K, B, L, C, sms, hw=H100) -> LaunchPlan:
    return _clause_stream("clause_eval", K, B, C, L, sms, 0, hw)


def plan_tm_infer(K, B, L, C, H, sms, hw=H100) -> LaunchPlan:
    return _clause_stream("tm_infer", K, B, C, L, sms, TM_INFER_EPI_BYTES,
                          hw, f" H{H}")


def plan_ta(kernel, K, B2, L, C, sms, streamed=False) -> LaunchPlan:
    """The shared TA body (``dtm_ta_update``, ``_sparse``, ``_streamed``):
    the wrappers launch it over every group (S = the group count), a
    block per item of (group, 4-row quad, 8-word chunk), grid-strided."""
    from repro_torch.kernels.ta_update import (_SMEM_LIMIT, GROUP,
                                               SPARSE_ROWS, sparse_blocks,
                                               sparse_smem)
    W = _cdiv(L, 32)
    G = _cdiv(C, GROUP)
    blocks = sparse_blocks(G, C, W, sms)
    chunks = _cdiv(W, TA_ITEM_WORDS)
    quads = G * (GROUP // SPARSE_ROWS)
    items = quads * chunks
    per_block = _strided(items, blocks)
    rows = tuple((q * SPARSE_ROWS, min(C, (q + 1) * SPARSE_ROWS))
                 for q in range(quads) if q * SPARSE_ROWS < C)
    return LaunchPlan(
        kernel, f"K{K} 2B{B2} L{L} C{C} blocks{blocks}", (blocks, K, 1),
        TA_THREADS, sparse_smem(C, B2, streamed), _SMEM_LIMIT,
        covers=(Cover("items", items, tuple(
                    (i, i + 1) for b in per_block for i in b)),
                Cover("C", C, rows),
                Cover("W", W, _blocks_of(W, TA_ITEM_WORDS))),
        work=tuple(len(b) for b in per_block))


def plan_lfsr(K, n, size) -> LaunchPlan:
    steps = _cdiv(size, n)
    return LaunchPlan(
        "lfsr_bits", f"K{K} lanes{n} size{size} steps{steps}",
        (_cdiv(n, LFSR_THREADS), K, 1), LFSR_THREADS,
        covers=(Cover("lanes", n, _blocks_of(n, LFSR_THREADS)),
                Cover("words", size, tuple(
                    (j * n, min(size, (j + 1) * n)) for j in range(steps)))))


def plan_threefry(K, size) -> LaunchPlan:
    blocks = max(1, min(_cdiv(size, TF_THREADS), TF_SMS * TF_BLOCKS_PER_SM))
    chunks = _strided(_cdiv(size, TF_THREADS), blocks)
    return LaunchPlan(
        "threefry_bits", f"K{K} size{size} blocks{blocks}", (blocks, K, 1),
        TF_THREADS,
        covers=(Cover("words", size, tuple(
            (c * TF_THREADS, min(size, (c + 1) * TF_THREADS))
            for b in chunks for c in b)),),
        work=tuple(len(b) for b in chunks))


# --------------------------------------------------------------------------- #
# checks                                                                      #
# --------------------------------------------------------------------------- #

def _coverage(c: Cover) -> Optional[str]:
    """None when every element of the axis is covered exactly once."""
    import numpy as np
    count = np.zeros(c.extent + 1, dtype=np.int64)
    for lo, hi in c.spans:
        lo, hi = max(lo, 0), min(hi, c.extent)
        if lo < hi:
            count[lo] += 1
            count[hi] -= 1
    count = np.cumsum(count)[:c.extent]
    if (count == 0).any():
        i = int(np.argmax(count == 0))
        return f"{c.name} element {i} of {c.extent} covered by no block"
    if (count > 1).any():
        i = int(np.argmax(count > 1))
        return (f"{c.name} element {i} of {c.extent} covered "
                f"{int(count[i])} times")
    return None


def check_plan(plan: LaunchPlan, hw: HardwareModel = H100
               ) -> List[Violation]:
    out: List[Violation] = []

    def bad(kind, detail):
        out.append(Violation(plan.kernel, plan.desc, kind, detail))

    if plan.threads > hw.max_threads_per_block:
        bad("threads", f"{plan.threads} threads a block (limit "
                       f"{hw.max_threads_per_block})")
    limit = min(plan.smem_limit, hw.smem_per_block_optin)
    if plan.smem + plan.static_smem > limit:
        bad("smem", f"{plan.smem} dynamic + {plan.static_smem} static bytes "
                    f"of shared memory (limit {limit})")
    cap = hw.max_cluster_nonportable if plan.nonportable else hw.max_cluster
    if plan.cluster > cap:
        bad("cluster", f"a cluster of {plan.cluster} blocks (limit {cap})")
    if plan.grid[0] % plan.cluster:
        bad("cluster", f"grid.x {plan.grid[0]} is not a multiple of the "
                       f"cluster {plan.cluster}")
    x, y, z = plan.grid
    if not 0 < x <= hw.max_grid_x:
        bad("grid", f"grid.x {x}")
    for name, v in (("y", y), ("z", z)):
        if not 0 < v <= hw.max_grid_yz:
            bad("grid", f"grid.{name} {v} (limit {hw.max_grid_yz})")
    for c in plan.covers:
        err = _coverage(c)
        if err is not None:
            bad("coverage", err)
    return out


def balance(plan: LaunchPlan) -> Optional[Finding]:
    """A finding when one block takes at least ``BALANCE`` times the mean
    work of the plan's blocks."""
    if not plan.work:
        return None
    hi, mean = max(plan.work), sum(plan.work) / len(plan.work)
    if hi > 1 and hi >= BALANCE * mean:
        return Finding(plan.kernel, plan.desc, hi, mean)
    return None


# --------------------------------------------------------------------------- #
# the audit space                                                             #
# --------------------------------------------------------------------------- #

ROSTER_SHAPE = (3200, 4224, 16)     # the serving roster's padded L, R, H
TRAIN_SHAPE = (1664, 2048, 16)      # the MNIST CoTM's training width


def _audit_shapes() -> List[Tuple[int, int, int]]:
    """(L, R, H): the JAX checker's (the autotune bench grid, the paper
    tiles padded as the engine pads them) and the card's two widths."""
    from repro_torch.configs.tm_paper import DTM_L_TILE, DTM_S_TILE
    shapes = {(1024, 512, 8), (256, 128, 4), ROSTER_SHAPE, TRAIN_SHAPE}
    for tile in (DTM_L_TILE, DTM_S_TILE):
        shapes.add(tuple(tile.padded_dims()))
    return sorted(shapes)


AUDIT_BATCHES = (1, 4, 8, 32, 256, 1024)   # the JAX checker's
STREAMED_BATCHES = (1, 8)                  # ditto, for the streamed TA
PROGRAMS = (1, 4)
LFSR_LANES = 8192                          # PRNG.create's default cluster


def build_plans(hw: HardwareModel = H100) -> List[LaunchPlan]:
    sms = hw.sms
    plans: List[LaunchPlan] = []
    for L, R, H in _audit_shapes():
        W = _cdiv(L, 32)
        for K in PROGRAMS:
            for B in AUDIT_BATCHES:
                # eval: edge, tile, dense; train: + fused, class sums;
                # inference in one launch; the TA stage, dense and sparse
                plans.append(plan_edge(K, B, R, W, sms))
                plans.append(plan_tile(K, B, R, W, sms, hw))
                plans.append(plan_clause_eval(K, B, L, R, sms, hw))
                plans.append(plan_class_sum(K, B, R, H, sms, hw))
                plans.append(plan_fused(K, B, R, W, H))
                plans.append(plan_tm_infer(K, B, L, R, H, sms, hw))
                for kernel in ("ta_update", "ta_update_sparse"):
                    plans.append(plan_ta(kernel, K, 2 * B, L, R, sms))
                plans.append(plan_lfsr(K, LFSR_LANES, 2 * B * R))
                plans.append(plan_threefry(K, 2 * B * R))
            for B in STREAMED_BATCHES:
                plans.append(plan_ta("ta_update_streamed", K, 2 * B, L, R,
                                     sms, streamed=True))
        # the program draw: the TA words and the weights
        plans.append(plan_threefry(1, R * L))
        plans.append(plan_threefry(1, H * R))
    return plans


def check_all(hw: HardwareModel = H100
              ) -> Tuple[int, List[Violation], List[Finding]]:
    plans = build_plans(hw)
    violations: List[Violation] = []
    findings: List[Finding] = []
    for p in plans:
        violations.extend(check_plan(p, hw))
        f = balance(p)
        if f is not None:
            findings.append(f)
    return len(plans), violations, findings


def main(argv: Sequence[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis kernels",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=int, default=None,
                    help="take the SM count and shared memory limit of "
                         "this card (default: the H100 model)")
    ns = ap.parse_args(list(argv))
    hw = H100 if ns.device is None else HardwareModel.from_device(ns.device)
    n, violations, findings = check_all(hw)
    for v in violations:
        print(v.render())
    for f in findings:
        print(f.render())
    print(f"launch contract: {n} plans audited against {hw.name}, "
          f"{len(violations)} violation(s), {len(findings)} finding(s)")
    return 1 if violations else 0
