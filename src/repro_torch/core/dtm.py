"""Dynamic Tsetlin Machine engine in PyTorch: inference and training.

One engine geometry (:class:`~repro_torch.core.types.TileConfig`) runs any
TM model as *data*: a :class:`DTMProgram` holds the padded TA states,
weights and masks of one model, and swapping programs swaps the model.
Vanilla TM runs on the coalesced datapath as a block-diagonal frozen ±1
weight matrix (the paper's Eq 3), as in the JAX engine.

The engine keeps the JAX engine's layouts: packed literals ``[B, W]``,
include bitplane ``[R, W]``, weights ``[H, R]``, sums ``[B, H]`` and
clauses ``[B, R]``.  A bank of K programs is a :class:`DTMProgram` whose
leaves carry a leading K axis; the kernels take that axis directly, so
``infer_bank``/``predict_bank``/``train_bank`` launch each kernel once
for K programs.  Every stage runs on the engine's device: the CUDA
kernels on the card, or their plain versions on the CPU.

A train step (the paper's Alg 3-6, batched-delta mode) draws its random
numbers from a :class:`~repro_torch.core.prng.PRNG` in the JAX engine's
order, runs the front half (clause eval, class sums, Alg-3 selection for
the target and negated rounds) in one ``fused_step`` launch (or, at
batch <= 4, the edge clause and class-sum kernels), then the TA update
over both rounds with in-kernel random streams: the Alg-6 compacted
update over the clause groups that got feedback (``skip=True``, the
default) or the dense update (``skip=False``, and always for banks).  The
update emits the new include bitplane.  The integer glue around the
front half (classes and TA seed before it; the Type I/II split, the 2B
operands, the Alg-6 group list, the exact Alg-4 weight nudges and the
stats after it) is two kernels on the card
(:mod:`repro_torch.kernels.step_glue`), their plain versions elsewhere.
Steps return new programs; the inputs are left as they were.  No step
reads the device from the host.

A forced ``kernel_path="mxu"`` runs the dense clause kernel on int8
literals and include unpacked on the device (``clause_eval``; in training
the unfused front half: ``clause_eval``, ``class_sum`` and the torch
selection); ``ta_prng="stream"`` makes the TA update read its random
words from a pre-made [K, 2B, R, L] tensor (the streamed baseline, dense
update).  A forced ``kernel_path="ref"`` runs the JAX engine's ``ref``
branch on the device: every clause, class-sum, front-half and TA stage
through its plain version (no clause or TA kernel; the PRNG draws still
launch theirs).  All give the same results as the default paths.

The conv kind runs around the same clause and class-sum stages: its
packed literals are ``[B, P, W]`` (P patch slots, ``p_mask`` hiding the
padded ones), the clause stage runs on the ``[B·P, W]`` view and the
patches meet in an OR (``infer_conv``, ``infer_conv_bank``).  Its train
step (``train_conv``, one program) follows the clause stage with class
sums and both Alg-3 rounds, then gives Type I/II feedback against one
random matching patch per (datapoint, clause), with its random words
drawn from the PRNG (one ``lfsr_bits`` launch a draw on the card): the
JAX engine's jnp stage, two kernels on the card
(:mod:`repro_torch.kernels.conv_ta`: the patch pick and the TA update),
its plain version elsewhere and on the forced ``ref`` path.

Per stage the engine records the kernels it ran in
``cache_report()["path_per_stage"]``: ``packed_vpu``, ``mxu_popcount``,
``mxu`` or ``fused`` for the clause stage, ``<stage>_ta`` =
``compact``/``dense`` and ``<stage>_prng`` = ``<family>-inkernel`` or
``<family>-stream`` (family ``counter`` or ``lfsr``).  The stages are
``infer``, ``infer_bank``, ``train``, ``train_bank``, ``infer_conv``,
``infer_conv_bank`` and ``train_conv`` (a forced path records ``ref``
for its clause stages).  A conv train stage off the forced ``ref`` path
also records ``<stage>_ta`` = ``conv_ta`` (:func:`kops.conv_ta_update_op`;
the JAX engine has no such entry: its conv TA stage is jnp).

Every stage executable of the JAX engine runs as a CUDA graph on the
card (:mod:`repro_torch.core.graph`): an epoch of ``TMSession.fit_epochs``
is one plan upload, one replay of the captured step per batch and one
stats fetch (:meth:`DTMEngine._fit_epoch_impl`,
:meth:`DTMEngine._fit_epoch_conv_impl`); ``TMSession.step`` and a served
train step (:meth:`DTMEngine._session_step`) are one replay at their
batch shape; single-program inference (:meth:`DTMEngine.served_infer`:
``TM.predict``, ``TMServer.predict``, the server's cold path) one replay
per (stage, shape); a bank flush and a bank train step
(``api.ProgramBank``) one replay.  The CPU and the forced ``ref`` path
run the same bodies eagerly; neither is a fallback: on the card a
capture or replay that fails raises.  The ``train_step``,
``train_conv``, ``infer*`` and ``train_bank`` methods stay the eager
building blocks.  ``cache_report()`` counts the graphs captured per JAX
stage name (0 without capture).

The clause-sharded stage bodies (``_infer_sharded_impl``,
``_infer_conv_sharded_impl``, ``_train_sharded_impl``,
``_train_conv_sharded_impl``; :class:`repro_torch.launch.pod.ShardedTM`
runs them on every rank of a ``clauses`` mesh axis) are the same bodies
on one rank's window of clause rows (:class:`Shard`), with the class
sums, a regression program's vote count and the Alg-6 stat inputs
reduced or gathered over the axis's process group; they record
``<stage>_shard`` = ``"<axis>:<shards>"``.  ``ShardedTM`` replays each
as a graph (:data:`SHARD_STAGES`) over an NCCL group on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import M32, NEG_INF_SUM, pack_include
from repro_torch.runtime.spans import span
from .booleanize import pack_literals, unpack_literals, words_from_u32
from .device import Device, resolve_device
from .evaluate import epoch_record
from .graph import StepGraph
from . import threefry
from .collectives import all_sum, gather_dim, row_window
from .prng import PRNG
from .types import COALESCED, TMConfig, TileConfig

# A train step returns exactly these int32 stats; fit_epochs sums the
# per-step values on the host into the plain ints of the epoch records.
STAT_KEYS = ("selected", "active_groups", "total_groups", "correct",
             "abs_err")
# The JAX engine's stage executables, as ``cache_report`` names them.
GRAPH_STAGES = ("infer", "train", "infer_conv", "train_conv", "fit_epoch",
                "fit_epoch_conv", "infer_bank", "infer_conv_bank",
                "infer_bank_list", "infer_conv_bank_list",
                "predict_bank_list", "train_bank")
# The clause-sharded stages (launch/pod.py ShardedTM; JAX jits them there,
# not in its engine, so ``cache_report`` leaves them out).
SHARD_STAGES = ("infer_sharded", "train_sharded", "infer_conv_sharded",
                "train_conv_sharded")

@dataclasses.dataclass
class DTMProgram:
    """Run-time model data for the engine (one program, or a bank of K
    programs with a leading K axis on every leaf).

    ta         uint8 [R, L]  padded TA states (int32 iff ta_bits > 8)
    weights    int32 [H, R]  padded class weights (Vanilla: frozen block ±1)
    cl_mask    int32 [R]     1 = real clause row
    l_mask     int32 [L]     1 = real literal column
    h_mask     int32 [H]     1 = real class
    w_frozen   bool  []      True = Vanilla mode (weights never update)
    T          int32 []      clause-update threshold
    p_ta       int32 []      ⌊2^rand_bits / s⌉, a uint32 value in int32 bits
    boost      bool  []      boost-true-positive flag
    n_states   int32 []      2^ta_bits
    w_clip     int32 []      weight clip bound
    regression bool  []      True = error-driven feedback (Regression TM)
    p_mask     int32 [P]     1 = real patch slot (flat programs: [1, 0, ..])
    inc        int32 [R, W]  packed include bitplane, uint32 bits in int32:
                             bit j of word w = include action of TA 32*w+j

    The fields, their order and dtypes are the JAX ``DTMProgram``'s, with
    uint32 leaves held as int32 bit patterns.
    """

    ta: torch.Tensor
    weights: torch.Tensor
    cl_mask: torch.Tensor
    l_mask: torch.Tensor
    h_mask: torch.Tensor
    w_frozen: torch.Tensor
    T: torch.Tensor
    p_ta: torch.Tensor
    boost: torch.Tensor
    n_states: torch.Tensor
    w_clip: torch.Tensor
    regression: torch.Tensor
    p_mask: torch.Tensor
    inc: torch.Tensor

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "DTMProgram":
        """A new program with ``fn`` applied to every leaf."""
        return DTMProgram(*(fn(t) for t in self.leaves()))

    def to(self, device: Device) -> "DTMProgram":
        return self.map(lambda t: t.to(device))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves())


FIELDS = tuple(f.name for f in dataclasses.fields(DTMProgram))
U32_FIELDS = ("p_ta", "inc")    # uint32 in the JAX program, int32 bits here
TRAINED = ("ta", "weights", "inc")    # the leaves a train step changes
# the leaves inference reads (_infer_impl, _infer_conv_impl; l_mask only
# on the forced ref path): never the TA states
INFER_LEAVES = ("inc", "weights", "cl_mask", "l_mask", "h_mask", "p_mask")


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's clause-row window in a clause-sharded stage: the process
    group of the mesh axis ``axis``, the ``shards`` along it, and the rows
    ``[row0, row0 + r_loc)`` of the engine's R that the rank's program
    leaves hold (:meth:`DTMEngine._shard_window`)."""

    group: object
    axis: str
    shards: int
    row0: int
    r_loc: int


def _one(prog: DTMProgram) -> DTMProgram:
    """One program in bank form (a leading K = 1 axis on every leaf; a
    leaf the stage does not read may be ``None``)."""
    return prog.map(lambda t: None if t is None else t.unsqueeze(0))


def _sig(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _prng_sig(prng: PRNG) -> tuple:
    return (prng.backend, prng.lfsr_bits, prng.rand_bits, prng.seed_refresh,
            _sig(prng.leaves()))


def prng_like(prng: PRNG, leaves) -> PRNG:
    """``prng``'s configuration over the state leaves ``leaves``."""
    it = iter(leaves)
    return prng.map(lambda _: next(it))


class StepStats(dict):
    """A train step's stats: int32 tensors keyed by :data:`STAT_KEYS`,
    each a view of one row ``row`` [len(STAT_KEYS)] (a bank's:
    [len(STAT_KEYS), K]), which a step graph stores whole."""

    def __init__(self, row: torch.Tensor):
        super().__init__((k, row[i]) for i, k in enumerate(STAT_KEYS))
        self.row = row

    def program(self, k: int) -> "StepStats":
        """Program ``k``'s stats of a bank's."""
        return StepStats(self.row[:, k])


def store_step(bufs, new: DTMProgram, new_prng: PRNG, stats: StepStats
               ) -> torch.Tensor:
    """A train step body's end: the trained leaves and the PRNG state
    (``prng<i>``) copied into the graph's buffers, skipping a leaf the
    step wrote in place already (the donated TA, include bitplane and
    weights).  Returns the stats as one ``[len(STAT_KEYS), ...]`` row."""
    for f in TRAINED:
        t = getattr(new, f)
        if t.data_ptr() != bufs[f].data_ptr():
            bufs[f].copy_(t)
    for i, t in enumerate(new_prng.leaves()):
        bufs[f"prng{i}"].copy_(t)
    return stats.row


class DTMEngine:
    """Tiled TM executor (inference and training) on one device.

    ``device`` defaults to CUDA (the kernels); ``device="cpu"`` runs the
    kernels' plain versions.  ``kernel_path`` forces one clause datapath
    (:data:`repro_torch.kernels.ops.PATHS`: the JAX package's
    ``REPRO_KERNEL_PATH``, as an argument) instead of the batch-based
    choice of :func:`repro_torch.kernels.ops.select_path`; ``"ref"`` runs
    every stage's plain version on the device.  ``skip``
    selects the Alg-6 compacted TA update (``REPRO_SKIP``); off, every
    step runs the dense one.  ``ta_prng`` is the provenance of the TA
    update's random words (``REPRO_TA_PRNG``): ``"inkernel"`` (made in the
    kernel) or ``"stream"`` (made first as a tensor, read by the dense
    streamed kernel).  ``autotune`` (``off`` | ``seed`` | ``measure``)
    and ``autotune_cache`` (a file, or None for the default one) are the
    dispatcher's plan cache (``REPRO_AUTOTUNE``, ``REPRO_AUTOTUNE_CACHE``;
    :mod:`repro_torch.kernels.autotune`): the engine hands the dispatcher
    its padded ``(L, R, H)``.  Every choice gives the same states.
    """

    def __init__(self, tile: TileConfig, rand_bits: int = 16,
                 device: Device = None, kernel_path: Optional[str] = None,
                 skip: bool = True, ta_prng: str = kops.TA_PRNG_INKERNEL,
                 autotune: str = "seed", autotune_cache=None):
        self.device = resolve_device(device)
        if kernel_path is not None:
            kops.select_path(1, force=kernel_path)      # validates the name
        kops.select_ta_path(ta_prng=ta_prng,            # validates the names
                            autotune=autotune)
        self.kernel_path = kernel_path
        self.skip = skip
        self.ta_prng = ta_prng
        self.autotune = autotune
        self.autotune_cache = autotune_cache
        self.tile = tile
        self.rand_bits = rand_bits
        self.L, self.R, self.H = tile.padded_dims()
        self.P = tile.max_patches
        self.W = tile.packed_words()
        self._stage_paths: dict = {}
        self._graphs: dict = {}      # session step graphs, by stage and shape
        self._captured: dict = {}    # stage -> the graphs alive

    @property
    def graphed(self) -> bool:
        """Whether the sessions and banks of this engine replay CUDA graphs:
        on the card, except on the forced ``ref`` path (its plain sparse
        update reads the group count on the host).  Otherwise they run the
        same bodies eagerly."""
        return self.device.type == "cuda" and self.kernel_path != kops.PATH_REF

    def step_graph(self, stage: str, body, state, const=None,
                   capture: bool = True) -> StepGraph:
        """A :class:`~repro_torch.core.graph.StepGraph` of this engine:
        captured on the card (:attr:`graphed`) unless the caller says
        ``capture=False`` (a body whose collectives cannot be captured),
        listed by :meth:`graph_report` and, once captured, counted by
        :meth:`cache_report` under ``stage`` while it lives."""
        return StepGraph(stage, body, state, const,
                         capture=self.graphed and capture,
                         registry=self._captured)

    # ------------------------------------------------------------------ #
    # programming                                                         #
    # ------------------------------------------------------------------ #
    def program(self, cfg: TMConfig, key=None, ta=None,
                weights=None) -> DTMProgram:
        """Build the padded program of a model config on the engine's
        device.

        ``ta`` [rows, 2f] and ``weights`` [classes, clauses] (coalesced
        only) give the states; whatever is not given is drawn from the
        threefry ``key`` (:func:`repro_torch.core.threefry.key`, or a JAX
        ``PRNGKey`` as an array) as the JAX engine draws it: the key is
        split into ``kt, kw``, TA states are J-1 + bernoulli(kt, 0.5) and
        coalesced weights ±1 by bernoulli(kw, 0.5), so a key gives the
        JAX engine's program.  On the card each draw is one
        ``threefry_bits`` launch."""
        L, R, H = self.L, self.R, self.H
        f, c, h = cfg.features, cfg.clauses, cfg.classes
        rows = cfg.total_clauses
        if 2 * f > L or rows > R or h > H:
            raise ValueError(f"model {(2 * f, rows, h)} exceeds engine "
                             f"buffers {(L, R, H)}")
        if cfg.T >= (1 << 13):
            raise ValueError(f"T={cfg.T} exceeds the 13-bit margin compare")
        dev = self.device
        draw_ta = ta is None
        draw_w = cfg.tm_type == COALESCED and weights is None
        if draw_ta or draw_w:
            if key is None:
                raise ValueError("pass ta/weights or a threefry key to draw "
                                 "them from")
            k = threefry.as_key(key, dev)
            if k.shape != (2,):
                raise ValueError(f"one threefry key [2], got "
                                 f"{tuple(k.shape)}")
            # split first, as JAX does: kt and kw's words in one launch
            kt, w_bits = kops.threefry_bits(k[None], h * c if draw_w else 0,
                                            rand_bits=1)
            if draw_ta:
                _, t_bits = kops.threefry_bits(kt, rows * cfg.literals,
                                               rand_bits=1, split=False)
                # bernoulli(·, 0.5) is bits < 2^31: the top bit clear
                ta = (cfg.include_threshold
                      - t_bits[0].reshape(rows, cfg.literals).to(torch.int32))
            if draw_w:
                weights = 1 - 2 * w_bits[0].reshape(h, c).to(torch.int32)
        half = L // 2
        ta = torch.as_tensor(ta).to(device=dev, dtype=torch.int32)
        ta_pad = torch.zeros((R, L), dtype=torch.int32, device=dev)
        ta_pad[:rows, :f] = ta[:, :f]
        ta_pad[:rows, half:half + f] = ta[:, f:]

        w_pad = torch.zeros((H, R), dtype=torch.int32, device=dev)
        if cfg.tm_type == COALESCED:
            w_pad[:h, :c] = torch.as_tensor(weights).to(device=dev,
                                                        dtype=torch.int32)
            frozen = False
        else:   # Vanilla: block-diagonal frozen ±1 (Eq 3)
            pol = 1 - 2 * (torch.arange(c, device=dev) % 2).to(torch.int32)
            for cls in range(h):
                w_pad[cls, cls * c:(cls + 1) * c] = pol
            frozen = True

        span = torch.arange(L, device=dev)
        l_mask = ((span < f) | ((span >= half) & (span < half + f))).to(
            torch.int32)
        p_ta = int(round((1 << self.rand_bits) / cfg.s))
        ta_dtype = torch.uint8 if cfg.n_states <= 256 else torch.int32

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        return DTMProgram(
            ta=ta_pad.to(ta_dtype), weights=w_pad,
            cl_mask=(torch.arange(R, device=dev) < rows).to(torch.int32),
            l_mask=l_mask,
            h_mask=(torch.arange(H, device=dev) < h).to(torch.int32),
            w_frozen=scalar(frozen, torch.bool),
            T=scalar(cfg.T, torch.int32),
            p_ta=words_from_u32(scalar(p_ta, torch.int64)),
            boost=scalar(cfg.boost_true_positive, torch.bool),
            n_states=scalar(cfg.n_states, torch.int32),
            w_clip=scalar(cfg.weight_clip, torch.int32),
            regression=scalar(False, torch.bool),
            p_mask=(torch.arange(self.P, device=dev) < 1).to(torch.int32),
            inc=pack_include(ta_pad, cfg.n_states))

    def lower(self, spec, key=None, ta=None, weights=None) -> DTMProgram:
        """Lower a :class:`repro_torch.api.TMSpec` (duck-typed: ``kind``,
        ``tm_config()``, ``n_patches``) to a program, drawing what is not
        given from the threefry ``key`` as :meth:`program` does (the JAX
        ``lower(spec, key)``); a conv spec's ``p_mask`` marks its patch
        slots."""
        cfg = spec.tm_config()
        n_p = int(getattr(spec, "n_patches", 1))
        if n_p > self.P:
            raise ValueError(f"spec needs {n_p} patch slots, engine has "
                             f"{self.P} (TileConfig.max_patches)")
        if cfg.rand_bits != self.rand_bits:
            raise ValueError(f"spec rand_bits={cfg.rand_bits} != engine "
                             f"rand_bits={self.rand_bits}")
        regression = getattr(spec, "kind", None) == "regression"
        if regression and weights is None:
            # every clause votes +1 through a frozen unit weight row
            weights = torch.zeros((cfg.classes, cfg.clauses),
                                  dtype=torch.int32)
            weights[0] = 1
        prog = self.program(cfg, key, ta=ta, weights=weights)
        if n_p != 1:
            prog.p_mask = (torch.arange(self.P, device=self.device)
                           < n_p).to(torch.int32)
        if regression:
            prog.w_frozen = torch.tensor(True, device=self.device)
            prog.regression = torch.tensor(True, device=self.device)
        return prog

    def _layout(self, bool_feats: torch.Tensor) -> torch.Tensor:
        """[..., f] {0,1} -> engine literal layout [..., L] = [x pad|~x pad]."""
        f, half = bool_feats.shape[-1], self.L // 2
        x = bool_feats.to(torch.int8)
        z = torch.zeros((*x.shape[:-1], half - f), dtype=torch.int8,
                        device=x.device)
        return torch.cat([x, z, 1 - x, z], dim=-1)

    def pad_features(self, bool_x, cfg: Optional[TMConfig] = None
                     ) -> torch.Tensor:
        """[B, f] {0,1} -> packed literals [B, W] on the engine device.
        ``cfg`` is accepted and unused, as in the JAX engine."""
        return pack_literals(self._layout(
            torch.as_tensor(bool_x, device=self.device)))

    def encode(self, spec, x) -> torch.Tensor:
        """Raw model input -> packed engine literals int32: [B, W] for the
        flat kinds, [B, P, W] for conv (patch slots past the spec's
        zero-padded; ``p_mask`` hides them)."""
        lits = self._layout(spec.to_bool(x, device=self.device))
        if lits.dim() == 3:
            lits = torch.nn.functional.pad(
                lits, (0, 0, 0, self.P - lits.shape[1]))
        return pack_literals(lits)

    def refresh_include(self, prog: DTMProgram) -> DTMProgram:
        """Rebuild the packed include bitplane from the TA states."""
        return dataclasses.replace(prog,
                                   inc=pack_include(prog.ta, prog.n_states))

    # ------------------------------------------------------------------ #
    # datapath stages (bank form: every leaf and operand has a K axis)    #
    # ------------------------------------------------------------------ #
    def _plan(self) -> dict:
        """The dispatcher's shape and plan arguments for this engine."""
        return dict(shape=(self.L, self.R, self.H), autotune=self.autotune,
                    cache=self.autotune_cache, device=self.device)

    def _ta_path(self, lanes: int) -> str:
        return kops.select_ta_path(lanes, self.skip, self.ta_prng,
                                   **self._plan())

    def resolve_plans(self, rows: int, lanes: int = 1,
                      training: bool = False) -> None:
        """Resolve the dispatcher's plans of a stage ahead of its run:
        the clause path at ``rows`` per program (B, or B·P for the conv
        kind) and, ``training``, the front half's and the TA update's.
        Under ``measure`` this times what is not yet planned, so a graph
        calls it before its warm-up and capture."""
        kops.select_path(rows, force=self.kernel_path, lanes=lanes,
                         **self._plan())
        if training:
            kops.select_path(rows, force=self.kernel_path, training=True,
                             lanes=lanes, **self._plan())
            self._ta_path(lanes)

    def _eval_path(self, batch: int, stage: str, lanes: int = 1) -> str:
        path = kops.select_path(batch, force=self.kernel_path, lanes=lanes,
                                **self._plan())
        if path == kops.PATH_FUSED:
            # the fused kernel exists for train steps only; eval stages run
            # its dense front half, as in the JAX engine
            path = kops.PATH_MXU
        self._stage_paths[stage] = path
        return path

    def _clause_outputs(self, progs: DTMProgram, plits: torch.Tensor,
                        eval_mode: bool, stage: str) -> torch.Tensor:
        """Clause stage: packed [K, B, W] literals -> [K, B, R] int32."""
        path = self._eval_path(plits.shape[1], stage, lanes=plits.shape[0])
        if path == kops.PATH_REF:
            cl = kops.ref_clause_op(plits, progs.inc, progs.l_mask, self.L,
                                    eval_mode=eval_mode)
        elif path == kops.PATH_MXU:
            # int8 literals and include unpacked on the device; padded TA
            # columns are never included, so include honours l_mask
            cl = kops.clause_eval(unpack_literals(plits, self.L),
                                  unpack_literals(progs.inc, self.L),
                                  eval_mode=eval_mode)
        else:
            op = (kops.packed_clause_eval if path == kops.PATH_PACKED
                  else kops.packed_clause_tile)
            cl = op(plits, progs.inc, eval_mode=eval_mode, n_bits=self.L)
        return cl * progs.cl_mask[:, None, :]

    def _class_sums_raw(self, progs: DTMProgram, cl: torch.Tensor
                        ) -> torch.Tensor:
        """Weight stage, unpinned: [K, B, R] clauses -> [K, B, H] sums."""
        if self.kernel_path == kops.PATH_REF:
            return kops.ref.class_sum_ref(cl, progs.weights)
        return kops.class_sum(cl, progs.weights)

    def _pin_class_sums(self, progs: DTMProgram, sums: torch.Tensor
                        ) -> torch.Tensor:
        """Padded class columns -> NEG_INF_SUM (the paper's Fig 6d)."""
        return torch.where(progs.h_mask[:, None, :] == 1, sums,
                           torch.full_like(sums, NEG_INF_SUM))

    def _reduced_sums(self, progs: DTMProgram, cl: torch.Tensor,
                      shard: Optional[Shard] = None) -> torch.Tensor:
        """Weight stage, pinned: clause-sharded, the raw partial sums are
        summed over the shards first (pinning before the all-reduce would
        add the NEG_INF sentinels together)."""
        sums = self._class_sums_raw(progs, cl)
        if shard is not None:
            sums = all_sum(sums, shard.group)
        return self._pin_class_sums(progs, sums)

    def _infer_impl(self, progs: DTMProgram, plits: torch.Tensor,
                    stage: str, shard: Optional[Shard] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cl = self._clause_outputs(progs, plits, eval_mode=True, stage=stage)
        return self._reduced_sums(progs, cl, shard), cl

    def _conv_clauses(self, progs: DTMProgram, plits: torch.Tensor,
                      eval_mode: bool, stage: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conv clause stage: [K, B, P, W] -> (per-patch clauses
        [K, B, P, R] with padded slots zeroed, their OR [K, B, R]; R the
        rows the programs hold)."""
        K, B, P, W = plits.shape
        cl_p = self._clause_outputs(progs, plits.reshape(K, B * P, W),
                                    eval_mode=eval_mode, stage=stage)
        cl_p = cl_p.reshape(K, B, P, -1) * progs.p_mask[:, None, :, None]
        return cl_p, cl_p.amax(dim=2)

    def _infer_conv_impl(self, progs: DTMProgram, plits: torch.Tensor,
                         stage: str, shard: Optional[Shard] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        _, cl = self._conv_clauses(progs, plits, eval_mode=True, stage=stage)
        return self._reduced_sums(progs, cl, shard), cl

    # ------------------------------------------------------------------ #
    # inference                                                           #
    # ------------------------------------------------------------------ #
    def infer(self, prog: DTMProgram, lits: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """lits [B, W] packed -> (class_sums [B, H], clause [B, R])."""
        sums, cl = self._infer_impl(prog.map(lambda t: t.unsqueeze(0)),
                                    lits.unsqueeze(0), stage="infer")
        return sums[0], cl[0]

    def predict(self, prog: DTMProgram, lits: torch.Tensor) -> torch.Tensor:
        sums, _ = self.infer(prog, lits)
        return torch.argmax(sums, dim=-1)

    def infer_bank(self, progs: DTMProgram,
                   lits: Union[torch.Tensor, Sequence[torch.Tensor]]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked programs, lits [K, B, W] (or K arrays [B, W]) ->
        (sums [K, B, H], clause [K, B, R]), one launch per kernel."""
        if not isinstance(lits, torch.Tensor):
            lits = torch.stack(list(lits))
        return self._infer_impl(progs, lits, stage="infer_bank")

    def infer_conv(self, prog: DTMProgram, plits: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conv plits [B, P, W] packed -> (class_sums [B, H],
        clause [B, R])."""
        sums, cl = self._infer_conv_impl(prog.map(lambda t: t.unsqueeze(0)),
                                         plits.unsqueeze(0),
                                         stage="infer_conv")
        return sums[0], cl[0]

    def infer_conv_bank(self, progs: DTMProgram,
                        plits: Union[torch.Tensor, Sequence[torch.Tensor]]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked conv programs, plits [K, B, P, W] (or K arrays
        [B, P, W]) -> (sums [K, B, H], clause [K, B, R])."""
        if not isinstance(plits, torch.Tensor):
            plits = torch.stack(list(plits))
        return self._infer_conv_impl(progs, plits, stage="infer_conv_bank")

    def predict_bank(self, progs: DTMProgram,
                     lits: Union[torch.Tensor, Sequence[torch.Tensor]]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat-bank inference decoded on the device: (argmax preds
        [K, B] int32, clause votes clipped to [0, T] [K, B] int32)."""
        sums, cl = self.infer_bank(progs, lits)
        preds = torch.argmax(sums, dim=-1).to(torch.int32)
        votes = torch.minimum(cl.sum(dim=-1), progs.T[:, None].to(torch.int64))
        return preds, votes.clamp(min=0).to(torch.int32)

    # ------------------------------------------------------------------ #
    # training (Alg 3-6 on the padded grid, batched-delta mode)           #
    # ------------------------------------------------------------------ #
    def _train_front(self, progs: DTMProgram, plits: torch.Tensor,
                     cls_lab: torch.Tensor, neg: torch.Tensor,
                     sel_rand: torch.Tensor, stage: str):
        """Front half (clause eval → class sums → Alg-3 selection, both
        rounds): ``fused`` in one launch, the packed stages on the edge
        (``packed_vpu``) or tile (``mxu_popcount``) clause kernel, the
        unfused dense stages (``mxu``) or the plain ones (``ref``)."""
        path = kops.select_path(plits.shape[1], force=self.kernel_path,
                                training=True, lanes=plits.shape[0],
                                **self._plan())
        self._stage_paths[stage] = path
        rest = (progs.weights, cls_lab, neg, sel_rand,
                progs.cl_mask, progs.h_mask, progs.T,
                progs.w_frozen.to(torch.int32))
        if path == kops.PATH_REF:
            return kops.ref_step_op(plits, progs.inc, *rest, n_bits=self.L,
                                    rand_bits=self.rand_bits)
        if path == kops.PATH_MXU:
            return kops.unfused_step_op(
                unpack_literals(plits, self.L),
                unpack_literals(progs.inc, self.L), *rest,
                rand_bits=self.rand_bits)
        if path == kops.PATH_FUSED:
            return kops.fused_step_op(plits, progs.inc, *rest,
                                      rand_bits=self.rand_bits, n_bits=self.L)
        return kops.packed_step_op(plits, progs.inc, *rest,
                                   rand_bits=self.rand_bits, n_bits=self.L,
                                   mxu=path == kops.PATH_PACKED_MXU)

    def _train_impl(self, progs: DTMProgram, prngs: PRNG,
                    plits: torch.Tensor, labels: torch.Tensor, lanes: int,
                    stage: str, donate: bool = False,
                    shard: Optional[Shard] = None):
        """One batched train step of K programs (bank form: every program
        leaf and PRNG state leaf has a leading K axis; ``plits`` [K, B, W],
        ``labels`` [K, B] int32).  Returns (programs, PRNGs,
        :class:`StepStats` [.., K]).  ``donate``: the compacted TA update
        writes into ``progs.ta`` and ``progs.inc`` in place, and the
        epilogue kernel into ``progs.weights``.  ``shard``: the programs
        hold the rank's clause-row window (:meth:`_train_sharded_impl`).

        The glue around the front half is two kernels on the card
        (:mod:`repro_torch.kernels.step_glue`: ``step_prologue`` before
        it, ``step_epilogue`` after it); the clause-sharded step, whose
        collectives sit between those stages, and the forced ``ref`` path
        run their plain versions."""
        B = plits.shape[1]
        rb = self.rand_bits
        plain = shard is not None or self.kernel_path == kops.PATH_REF

        # the draws, in the JAX engine's order: one stream position per
        # datapoint, both selection rounds, then the TA-update seed
        prngs, c_rand = prngs.bits((B,))
        prngs, sel_rand = prngs.bits((2, B, self.R))
        prngs, seed_bits = prngs.bits((2,))
        labels, cls_lab, neg, ta_seed, sel_rand = kops.step_prologue_op(
            labels, c_rand, seed_bits, sel_rand, progs.h_mask,
            progs.regression, rand_bits=rb, plain=plain)
        if shard is not None:        # full-width draws, the window's rows
            sel_rand = sel_rand[..., shard.row0:shard.row0 + shard.r_loc]

        if shard is None:
            cl, sums_m, sel_lab, sel_neg = self._train_front(
                progs, plits, cls_lab, neg, sel_rand, stage)
            collectives = {}
        else:
            cl, sums_m, sel_lab, sel_neg = self._train_front_sharded(
                progs, plits, cls_lab, neg, sel_rand, stage, shard)
            # the global vote count, and the group accounting on all R
            # rows (a window can be smaller than a group)
            collectives = dict(
                vote_sum=lambda v: all_sum(v, shard.group),
                gather=lambda t: gather_dim(t, shard.group, 1))
        lit2, cl2, t1, t2, tile_idx, count, new_w, stats = \
            kops.step_epilogue_op(
                plits, cl, sums_m, sel_lab, sel_neg, sel_rand, labels,
                cls_lab, neg, progs.weights, progs.cl_mask, progs.w_frozen,
                progs.w_clip, progs.T, progs.regression, y=self.tile.y,
                rand_bits=rb, inplace=donate, plain=plain, **collectives)

        # TA update over both rounds joined into one 2B batch (target
        # rows, then negated rows), streams made in the kernel (or, for
        # the streamed baseline, made first and read by the kernel)
        ta_path = self._ta_path(lanes)
        family = "lfsr" if prngs.backend == "lfsr" else "counter"
        self._stage_paths[stage + "_ta"] = ta_path
        self._stage_paths[stage + "_prng"] = f"{family}-{self.ta_prng}"
        # clause-sharded: the streams keyed at the global rows
        kw = dict(seed=ta_seed, p_ta=progs.p_ta, boost=progs.boost,
                  n_states=progs.n_states, rand_bits=rb, prng=family,
                  row0=0 if shard is None else shard.row0,
                  lfsr_bits=prngs.lfsr_bits, seed_refresh=prngs.seed_refresh,
                  plain=self.kernel_path == kops.PATH_REF)
        if ta_path == kops.TA_COMPACT:
            new_ta, new_inc = kops.ta_update_compact_op(
                progs.ta, lit2, cl2, t1, t2, progs.l_mask, progs.inc,
                inplace=donate, groups=(tile_idx, count), **kw)
        else:
            new_ta, new_inc = kops.ta_update_op(
                progs.ta, lit2, cl2, t1, t2, progs.l_mask,
                stream=self.ta_prng == kops.TA_PRNG_STREAM, **kw)

        new = dataclasses.replace(progs, ta=new_ta.to(progs.ta.dtype),
                                  weights=new_w, inc=new_inc)
        return new, prngs, StepStats(stats)

    def _train_front_sharded(self, progs: DTMProgram, plits: torch.Tensor,
                             cls_lab: torch.Tensor, neg: torch.Tensor,
                             sel_rand: torch.Tensor, stage: str,
                             shard: Shard):
        """The clause-sharded front half: the window's clause stage, the
        partial sums all-reduced and pinned, then both Alg-3 rounds on the
        window's random words and weight columns (selection is
        column-independent given the global sums).  ``fused_step`` cannot
        run it: the sums are reduced between its stages."""
        cl = self._clause_outputs(progs, plits, eval_mode=False, stage=stage)
        sums = self._reduced_sums(progs, cl, shard)
        wf = progs.w_frozen.to(torch.int32)
        sel_lab = kops.round_select_op(
            sums, cls_lab, 1, sel_rand[:, 0], progs.weights, progs.cl_mask,
            progs.T, wf, rand_bits=self.rand_bits)
        sel_neg = kops.round_select_op(
            sums, neg, 0, sel_rand[:, 1], progs.weights, progs.cl_mask,
            progs.T, wf, rand_bits=self.rand_bits)
        return cl, sums, sel_lab, sel_neg

    def train_step(self, prog: DTMProgram, prng: PRNG, lits: torch.Tensor,
                   labels: torch.Tensor, donate: bool = False):
        """One train step: packed lits [B, W] and labels [B] (class ids, or
        regression vote targets) on the engine device -> (new program,
        new PRNG, stats: int32 0-d tensors keyed by :data:`STAT_KEYS`).
        ``prog`` is left as it was, unless ``donate``: then the caller
        gives up its ``ta`` and ``inc``, which the compacted TA update
        writes in place (the new program holds those tensors)."""
        new, prngs, stats = self._train_impl(
            prog.map(lambda t: t[None]), prng.map(lambda t: t[None]),
            lits[None], labels[None], lanes=1, stage="train", donate=donate)
        return new.map(lambda t: t[0]), prngs[0], stats.program(0)

    def _train_conv_impl(self, progs: DTMProgram, prngs: PRNG,
                         plits: torch.Tensor, labels: torch.Tensor,
                         stage: str = "train_conv",
                         shard: Optional[Shard] = None):
        """One batched conv train step in bank form (``plits``
        [K, B, P, W], ``labels`` [K, B]; the engine runs it at K=1).

        The clause stage on the [B·P, W] view in train mode, the OR over
        the real patches, class sums and both Alg-3 rounds, then Type I/II
        feedback against one random matching patch per (datapoint,
        clause): the patch with the largest ``cl_p·1000 + noise`` (the
        first on a tie, as ``jnp.argmax``), its literals gathered, the
        deltas summed over the batch, clipped, and the include bitplane
        packed anew (:func:`kops.conv_ta_update_op`).  The draws come in
        the JAX engine's order.  ``shard``: the programs hold the rank's
        clause-row window, and the full-width draws are read at its rows
        (:meth:`_train_conv_sharded_impl`)."""
        K, B, P, W = plits.shape
        L, R = self.L, self.R
        labels = labels.to(torch.int32)
        n_cls = progs.h_mask.sum(dim=-1)                               # [K]

        prngs, c_rand = prngs.bits((B,))
        prngs, patch_rand = prngs.bits((B, P, R))
        prngs, sel_rand = prngs.bits((2, B, R))
        prngs, ta_rand = prngs.bits((2, B, R, L))
        row0 = 0
        if shard is not None:       # transient memory scales with the global R
            row0, R = shard.row0, shard.r_loc
            sel_rand = sel_rand[..., row0:row0 + R]

        # uint32 draws held in int64: the remainder is the unsigned one
        rn = (c_rand % torch.clamp(n_cls - 1, min=1)[:, None]).to(torch.int32)
        neg = torch.where(rn < labels, rn, rn + 1)                     # [K, B]

        cl_p, cl = self._conv_clauses(progs, plits, eval_mode=False,
                                      stage=stage)
        sums = self._reduced_sums(progs, cl, shard)
        correct = (torch.argmax(sums, dim=-1) == labels).sum(
            dim=-1, dtype=torch.int32)
        wf = progs.w_frozen.to(torch.int32)
        sel_lab = kops.round_select_op(
            sums, labels, 1, sel_rand[:, 0], progs.weights, progs.cl_mask,
            progs.T, wf, rand_bits=self.rand_bits)
        sel_neg = kops.round_select_op(
            sums, neg, 0, sel_rand[:, 1], progs.weights, progs.cl_mask,
            progs.T, wf, rand_bits=self.rand_bits)

        # Type I/II feedback against one random matching patch per
        # (datapoint, clause), the new TA states and include bitplane
        plain = self.kernel_path == kops.PATH_REF
        if not plain:
            self._stage_paths[stage + "_ta"] = "conv_ta"
        new_ta, new_inc = kops.conv_ta_update_op(
            progs.ta, progs.inc, plits, cl_p, cl, sel_lab, sel_neg,
            progs.weights, labels, neg, patch_rand, ta_rand, progs.l_mask,
            progs.cl_mask, progs.p_ta, progs.boost, progs.n_states,
            row0=row0, plain=plain)

        new_w, stats = kops.weights_and_stats_plain(
            progs.weights, progs.w_frozen, progs.w_clip, progs.cl_mask, cl,
            sel_lab, sel_neg, labels, neg, correct, torch.zeros_like(correct),
            self.tile.y, None if shard is None
            else (lambda t: gather_dim(t, shard.group, 1)))
        new = dataclasses.replace(progs, ta=new_ta, weights=new_w,
                                  inc=new_inc)
        return new, prngs, StepStats(stats)

    def train_conv(self, prog: DTMProgram, prng: PRNG, plits: torch.Tensor,
                   labels: torch.Tensor):
        """One conv train step: packed plits [B, P, W] and labels [B] on
        the engine device -> (new program, new PRNG, stats: int32 0-d
        tensors keyed by :data:`STAT_KEYS`).  ``prog`` is left as it
        was."""
        new, prngs, stats = self._train_conv_impl(
            prog.map(lambda t: t[None]), prng.map(lambda t: t[None]),
            plits[None], labels[None])
        return new.map(lambda t: t[0]), prngs[0], stats.program(0)

    # ------------------------------------------------------------------ #
    # clause-sharded stage bodies (one rank each: launch/pod.py ShardedTM) #
    # ------------------------------------------------------------------ #
    # One machine's clause rows spread over a ``clauses`` mesh axis: each
    # rank holds a contiguous row window of the clause-indexed leaves (ta
    # [r_loc, L], inc [r_loc, W], cl_mask [r_loc], weight COLUMNS
    # [H, r_loc]); every other leaf, the literals, labels and PRNG are
    # replicated.  The results equal the single-device stages bit for bit
    # through three invariants (the JAX engine's):
    #   1. every rank draws the same FULL-width random words as a
    #      single-device step (the PRNG is replicated) and slices its
    #      window, so no stream position moves;
    #   2. class sums (and a regression program's vote count) are summed
    #      over the ranks RAW and pinned after; the Alg-3 selection is
    #      column-independent given the global sums, so it runs on the
    #      window;
    #   3. the TA update keys its in-kernel streams at the GLOBAL rows
    #      through ``row0``: no TA traffic between ranks.
    # ``ShardedTM`` runs each body as a step graph: captured with its
    # collectives over an NCCL group, eager over gloo (not capturable).

    def _shard_window(self, prog: DTMProgram, group,
                      axis: str = "clauses") -> Shard:
        """This rank's window of a program's clause rows (one program or
        a bank): ``row0`` from the rank's position in ``group``."""
        shards, row0, r_loc = row_window(self.R, group, axis)
        if prog.inc.shape[-2] != r_loc:
            raise ValueError(f"a window of {prog.inc.shape[-2]} rows is not "
                             f"1/{shards} of the engine's R={self.R}")
        return Shard(group, axis, shards, row0, r_loc)

    def _sharded(self, stage: str, shard: Shard) -> None:
        self._stage_paths[stage + "_shard"] = f"{shard.axis}:{shard.shards}"

    def _infer_sharded_impl(self, prog: DTMProgram, plits: torch.Tensor,
                            group, axis: str = "clauses",
                            stage: str = "infer_sharded"):
        """Clause-sharded inference of one program: the window's clause
        stage, one [B, H] all-reduce, pinning after it.  Returns (global
        sums [B, H], the window's clause columns [B, r_loc])."""
        shard = self._shard_window(prog, group, axis)
        sums, cl = self._infer_impl(_one(prog), plits[None], stage, shard)
        self._sharded(stage, shard)
        return sums[0], cl[0]

    def _infer_conv_sharded_impl(self, prog: DTMProgram,
                                 plits: torch.Tensor, group,
                                 axis: str = "clauses",
                                 stage: str = "infer_conv_sharded"):
        """:meth:`_infer_sharded_impl` of the conv kind (plits [B, P, W])."""
        shard = self._shard_window(prog, group, axis)
        sums, cl = self._infer_conv_impl(_one(prog), plits[None], stage,
                                         shard)
        self._sharded(stage, shard)
        return sums[0], cl[0]

    def _train_sharded_impl(self, prog: DTMProgram, prng: PRNG,
                            plits: torch.Tensor, labels: torch.Tensor,
                            group, axis: str = "clauses",
                            stage: str = "train_sharded"):
        """Clause-sharded train step of one flat program: :meth:`_train_impl`
        stage for stage, its front half unfused
        (:meth:`_train_front_sharded`).  The collectives are the [B, H]
        class-sum and [B] vote all-reduces and the [r_loc] stat gathers;
        the TA, include and weight updates stay on the rank.  Returns the
        window's new program, the PRNG and the global stats."""
        shard = self._shard_window(prog, group, axis)
        new, prngs, stats = self._train_impl(
            _one(prog), prng.map(lambda t: t[None]), plits[None],
            labels[None], lanes=1, stage=stage, shard=shard)
        self._sharded(stage, shard)
        return new.map(lambda t: t[0]), prngs[0], stats.program(0)

    def _train_conv_sharded_impl(self, prog: DTMProgram, prng: PRNG,
                                 plits: torch.Tensor, labels: torch.Tensor,
                                 group, axis: str = "clauses",
                                 stage: str = "train_conv_sharded"):
        """Clause-sharded conv train step (:meth:`_train_conv_impl` on the
        window; its full-width ``ta_rand`` draw scales with the global R,
        the price of exact streams)."""
        shard = self._shard_window(prog, group, axis)
        new, prngs, stats = self._train_conv_impl(
            _one(prog), prng.map(lambda t: t[None]), plits[None],
            labels[None], stage=stage, shard=shard)
        self._sharded(stage, shard)
        return new.map(lambda t: t[0]), prngs[0], stats.program(0)

    def train_bank(self, progs: DTMProgram, prngs: PRNG, lits: torch.Tensor,
                   labels: torch.Tensor):
        """Stacked train step: program k takes batch k (lits [K, B, W],
        labels [K, B]) in one launch per kernel.  Returns (programs,
        PRNGs, stats [K] per key)."""
        if not isinstance(lits, torch.Tensor):
            lits = torch.stack(list(lits))
        return self._train_impl(progs, prngs, lits, labels,
                                lanes=lits.shape[0], stage="train_bank")

    def train_fn(self, spec) -> Callable:
        """The train step of a spec's kind: ``train_conv`` for conv, else
        ``train_step``."""
        if getattr(spec, "kind", None) == "conv":
            return self.train_conv
        return self.train_step

    def infer_fn(self, spec) -> Callable:
        """The inference of a spec's kind: ``infer_conv`` or ``infer``."""
        if getattr(spec, "kind", None) == "conv":
            return self.infer_conv
        return self.infer

    def bind(self, program: DTMProgram, x=None, y=None, *, spec=None,
             prng: Optional[PRNG] = None, seed: int = 0) -> "TMSession":
        """Open a training session on this engine: the (program, PRNG)
        pair, with ``x``/``y`` (optional) encoded once and kept on the
        device for :meth:`TMSession.fit_epochs`.  Without a PRNG one is
        made from ``seed + 1`` (the spec's backend, or a counter)."""
        if prng is None:
            if spec is not None:
                prng = PRNG.create(spec.tm_config(), seed + 1,
                                   device=self.device)
            else:
                prng = PRNG("counter", 24, self.rand_bits, False,
                            torch.tensor(((seed + 1) & M32) or 0xC0FFEE,
                                         dtype=torch.int64,
                                         device=self.device))
        session = TMSession(self, program, prng, spec=spec)
        if x is not None:
            session.stage(x, y)
        return session

    # ------------------------------------------------------------------ #
    # session executables: one step body, replayed (JAX: _fit_epoch, the  #
    # jitted train step)                                                  #
    # ------------------------------------------------------------------ #
    def _train_graph(self, conv: bool, prog: DTMProgram, prng: PRNG,
                     lits: torch.Tensor, labels: torch.Tensor,
                     plan_shape: Optional[Tuple[int, int]] = None
                     ) -> StepGraph:
        """The graph of one train step at these shapes, made once: the
        step of :meth:`TMSession.step` on a batch ``lits``/``labels``, or,
        with ``plan_shape`` (steps, B), the step of an epoch over the
        staged set ``lits``/``labels``, whose batch is row ``step`` of a
        static plan [steps, B] and whose stats go to row ``step`` of a
        static [steps, len(STAT_KEYS)] buffer; the step advances ``step``
        itself.  Its state buffers are the program's leaves, the PRNG's
        (``prng<i>``) and the stats; the body writes the new program and
        PRNG into them (the compacted TA update in place).  An epoch
        graph keeps a copy of the staged set, so each staged size in use
        holds one more copy of its data on the device."""
        epoch = plan_shape is not None
        stage = ("fit_epoch" if epoch else "train") + ("_conv" if conv
                                                       else "")
        key = (stage, _sig(prog.leaves()), _prng_sig(prng),
               _sig((lits, labels)), plan_shape)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        with span("engine.graph_build"):
            return self._build_train_graph(key, stage, conv, prog, prng,
                                           lits, labels, plan_shape)

    def _build_train_graph(self, key, stage: str, conv: bool,
                           prog: DTMProgram, prng: PRNG, lits: torch.Tensor,
                           labels: torch.Tensor,
                           plan_shape: Optional[Tuple[int, int]]
                           ) -> StepGraph:
        """:meth:`_train_graph`'s cache miss: a new graph under ``key``."""
        epoch = plan_shape is not None
        step = (self.train_conv if conv
                else functools.partial(self.train_step, donate=True))
        dev = self.device
        def own(t):
            return t.clone(memory_format=torch.contiguous_format)
        state = {f: own(getattr(prog, f)) for f in FIELDS}
        prng_buf = prng.map(own)
        n_r = len(prng_buf.leaves())
        state.update({f"prng{i}": t for i, t in enumerate(prng_buf.leaves())})
        n_stats = len(STAT_KEYS)
        if epoch:
            state["step"] = torch.zeros(1, dtype=torch.int64, device=dev)
            state["stats"] = torch.zeros((*plan_shape[:1], n_stats),
                                         dtype=torch.int32, device=dev)
            const = {"data": own(lits), "labels": own(labels),
                     "plan": torch.zeros(plan_shape, dtype=torch.int64,
                                         device=dev)}
        else:
            state["stats"] = torch.zeros(n_stats, dtype=torch.int32,
                                         device=dev)
            const = {"lits": own(lits), "labels": own(labels)}

        def body(b):
            p = DTMProgram(*(b[f] for f in FIELDS))
            r = prng_like(prng_buf, [b[f"prng{i}"] for i in range(n_r)])
            if epoch:
                ib = b["plan"].index_select(0, b["step"]).view(-1)
                x = b["data"].index_select(0, ib)
                y = b["labels"].index_select(0, ib)
            else:
                x, y = b["lits"], b["labels"]
            row = store_step(b, *step(p, r, x, y))
            if epoch:
                b["stats"].index_copy_(0, b["step"], row[None])
                b["step"].add_(1)
            else:
                b["stats"].copy_(row)

        B = plan_shape[1] if epoch else lits.shape[0]
        if conv:
            self.resolve_plans(B * lits.shape[-2])
        else:
            self.resolve_plans(B, training=True)
        graph = self.step_graph(stage, body, state, const)
        graph.mark("state", prog, prng)
        graph.mark("data", lits, labels)
        self._graphs[key] = graph
        return graph

    @staticmethod
    def _load_state(graph: StepGraph, prog: DTMProgram, prng: PRNG) -> None:
        """Copy a program and PRNG into a train graph's state buffers,
        unless they hold it already."""
        if graph.holds("state", prog, prng):
            return
        for f in FIELDS:
            graph.state[f].copy_(getattr(prog, f))
        for i, t in enumerate(prng.leaves()):
            graph.state[f"prng{i}"].copy_(t)
        graph.mark("state", prog, prng)

    @staticmethod
    def _unload_state(graph: StepGraph, prog: DTMProgram, prng: PRNG
                      ) -> Tuple[DTMProgram, PRNG]:
        """The trained program and PRNG out of a train graph's buffers, as
        copies: ``prog`` with new TA states, weights and include bitplane
        (its other leaves are unchanged by a step).  A later replay writes
        the buffers, never the copies."""
        new = dataclasses.replace(prog, **{f: graph.state[f].clone()
                                           for f in TRAINED})
        new_prng = prng_like(prng, [
            graph.state[f"prng{i}"].clone()
            for i in range(len(prng.leaves()))])
        graph.mark("state", new, new_prng)
        return new, new_prng

    def _session_step(self, conv: bool, prog: DTMProgram, prng: PRNG,
                      lits: torch.Tensor, labels: torch.Tensor):
        """One train step through the step graph at this batch shape (one
        replay on the card) -> (new program, new PRNG, stats: int32 0-d
        tensors keyed by :data:`STAT_KEYS`), all copies.  ``TMSession.
        step`` and ``TMServer.train`` take their steps here; the graph's
        lock is held from the copy-in to the copy-out and nothing else is
        taken under it."""
        graph = self._train_graph(conv, prog, prng, lits, labels)
        with graph.lock:
            with span("step.load"):
                self._load_state(graph, prog, prng)
                graph.const["lits"].copy_(lits)
                graph.const["labels"].copy_(labels)
            graph.run()
            with span("step.unload"):
                new, new_prng = self._unload_state(graph, prog, prng)
                row = graph.state["stats"].clone()
        return new, new_prng, {k: row[i] for i, k in enumerate(STAT_KEYS)}

    def _epoch(self, conv: bool, prog: DTMProgram, prng: PRNG,
               lits: torch.Tensor, labels: torch.Tensor, idx,
               sync_guard: bool = False):
        idx = np.asarray(idx)
        steps = idx.shape[0]
        graph = self._train_graph(conv, prog, prng, lits, labels,
                                  tuple(idx.shape))
        with graph.lock:
            with span("epoch.plan"):
                plan = torch.as_tensor(idx, dtype=torch.int64)
                if self.device.type == "cuda":
                    plan = plan.pin_memory()
                graph.const["plan"].copy_(plan, non_blocking=True)
            with span("step.load"):
                self._load_state(graph, prog, prng)
                if not graph.holds("data", lits, labels):
                    graph.const["data"].copy_(lits)
                    graph.const["labels"].copy_(labels)
                    graph.mark("data", lits, labels)
            graph.state["step"].zero_()
            graph.prepare()
            with _sync_guard(self.device, sync_guard):
                graph.run(steps)
            with span("step.unload"):
                new, new_prng = self._unload_state(graph, prog, prng)
                stats = graph.state["stats"].clone()
            return new, new_prng, stats

    def _fit_epoch_impl(self, prog: DTMProgram, prng: PRNG,
                        lits: torch.Tensor, labels: torch.Tensor, idx,
                        sync_guard: bool = False):
        """One training epoch (the JAX ``_fit_epoch_impl``): the staged
        packed literals ``lits`` [N, W] and labels [N] on the device, the
        epoch's batch index plan ``idx`` [steps, B] -> (program, PRNG,
        per-step stats int32 [steps, len(STAT_KEYS)] on the device), new
        tensors; the inputs stay as they were.  One upload of the plan
        (pinned, asynchronous), ``steps`` replays of the epoch graph's
        step, nothing read back.  ``sync_guard``: a host-device
        synchronisation during the steps raises (CUDA)."""
        return self._epoch(False, prog, prng, lits, labels, idx, sync_guard)

    def _fit_epoch_conv_impl(self, prog: DTMProgram, prng: PRNG,
                             plits: torch.Tensor, labels: torch.Tensor, idx,
                             sync_guard: bool = False):
        """:meth:`_fit_epoch_impl` of the conv kind (``plits``
        [N, P, W]; the step is :meth:`train_conv`)."""
        return self._epoch(True, prog, prng, plits, labels, idx, sync_guard)

    # ------------------------------------------------------------------ #
    # single-program inference: one graph per (stage, shape) across every #
    # program of the geometry (JAX: the jitted infer / infer_conv)        #
    # ------------------------------------------------------------------ #
    def _infer_graph(self, conv: bool, prog: DTMProgram,
                     lits: torch.Tensor) -> StepGraph:
        """The graph of one inference at this literal shape, made once.
        Its read-only buffers are the program leaves of
        :data:`INFER_LEAVES` (include bitplane, weights and the clause,
        literal, class and patch masks; never the TA states, which
        inference does not read and which are the bulk of a program) and
        the literals; its state buffers are the answers, ``sums`` [B, H]
        and ``cl`` [B, R].  The body builds the program from those leaves
        alone: any other leaf is ``None``."""
        stage = "infer_conv" if conv else "infer"
        key = (stage, _sig(getattr(prog, f) for f in INFER_LEAVES),
               _sig((lits,)))
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        with span("engine.graph_build"):
            return self._build_infer_graph(key, stage, conv, prog, lits)

    def _build_infer_graph(self, key, stage: str, conv: bool,
                           prog: DTMProgram, lits: torch.Tensor
                           ) -> StepGraph:
        """:meth:`_infer_graph`'s cache miss: a new graph under ``key``."""
        dev, B = self.device, lits.shape[0]
        const = {f: getattr(prog, f).clone(
            memory_format=torch.contiguous_format) for f in INFER_LEAVES}
        const["lits"] = lits.clone(memory_format=torch.contiguous_format)
        state = {"sums": torch.zeros((B, self.H), dtype=torch.int32,
                                     device=dev),
                 "cl": torch.zeros((B, self.R), dtype=torch.int32,
                                   device=dev)}
        impl = self._infer_conv_impl if conv else self._infer_impl

        def body(b):
            progs = DTMProgram(**{f: b[f][None] if f in INFER_LEAVES
                                  else None for f in FIELDS})
            sums, cl = impl(progs, b["lits"][None], stage=stage)
            b["sums"].copy_(sums[0])
            b["cl"].copy_(cl[0])

        self.resolve_plans(B * lits.shape[1] if conv else B)
        graph = self.step_graph(stage, body, state, const)
        graph.mark("prog", prog, *(getattr(prog, f) for f in INFER_LEAVES))
        self._graphs[key] = graph
        return graph

    def served_infer(self, spec, prog: DTMProgram, lits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference of one program of ``spec``'s kind through the
        engine's graph of its stage (``infer``, or ``infer_conv`` for a
        conv spec) at this literal shape: on the card one replay, shared
        by every program of the geometry.  The program's
        :data:`INFER_LEAVES` are copied in unless the buffers hold them
        already (the same program object with the same leaves).  Returns
        (sums [B, H], clause [B, R]) as copies taken under the graph's
        lock, so a later request cannot overwrite an answer a caller still
        holds.  The CPU and the forced ``ref`` path run the same body
        eagerly."""
        graph = self._infer_graph(getattr(spec, "kind", None) == "conv",
                                  prog, lits)
        leaves = tuple(getattr(prog, f) for f in INFER_LEAVES)
        with graph.lock:
            if not graph.holds("prog", prog, *leaves):
                for f, t in zip(INFER_LEAVES, leaves):
                    graph.const[f].copy_(t)
                graph.mark("prog", prog, *leaves)
            graph.const["lits"].copy_(lits)
            graph.run()
            return graph.state["sums"].clone(), graph.state["cl"].clone()

    def cache_sizes(self) -> Tuple[int, int]:
        """(graphs alive of stage ``infer``, of stage ``train``): the JAX
        engine's ``cache_sizes``, (0, 0) without capture."""
        report = self.cache_report()
        return report["infer"], report["train"]

    def cache_report(self) -> dict:
        """The CUDA graphs captured and alive per stage, under the JAX
        engine's stage executable names (:data:`GRAPH_STAGES`; 0 where
        nothing is captured: the CPU, the ``ref`` path), and
        ``path_per_stage``: the kernels each stage ran last (the clause
        datapath per stage; ``<stage>_ta`` and ``<stage>_prng`` for the TA
        update of the train stages).  Program swaps reuse a graph: each
        count stays at most 1 per stage and shape.  Graphs live with what
        owns them: the engine's (sessions, served steps, single-program
        inference) as long as the engine, a bank's (flushes, bank train
        steps) as long as the bank."""
        report = {s: sum(g.captured for g in self._captured.get(s, ()))
                  for s in GRAPH_STAGES}
        report["path_per_stage"] = dict(self._stage_paths)
        return report

    def graph_report(self) -> list:
        """One record per graph alive of the engine's stages and the
        clause-sharded ones (:data:`SHARD_STAGES`): stage, whether it is
        captured, warm-up and capture ms, the bytes its capture reserved,
        replays.  Without capture (the CPU, ``ref``) the engine's own
        stages run their bodies eagerly and are not listed; a sharded
        stage's body is listed, ``captured`` False."""
        return [{"stage": g.stage, "captured": g.captured,
                 "warmup_ms": g.warmup_ms, "capture_ms": g.capture_ms,
                 "pool_bytes": g.pool_bytes, "replays": g.replays}
                for s in GRAPH_STAGES + SHARD_STAGES
                for g in self._captured.get(s, ())
                if g.captured or s in SHARD_STAGES]


@contextlib.contextmanager
def _sync_guard(device: torch.device, on: bool):
    """Raise on any host-device synchronisation inside the block (CUDA)."""
    if not on or device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class TMSession:
    """A (program, PRNG) pair bound to an engine, with optionally staged
    training data on the device.

    * ``step(x, y)`` — one train step on a fresh batch (the estimator's
      ``partial_fit`` path): one replay of the engine's step graph at the
      batch's shape.
    * ``fit_epochs(n)`` — the staged dataset is gathered on the device
      per the epoch's shuffled index plan: one upload of the plan, one
      replay of the captured step per batch, one fetch of the stacked
      per-step stats per epoch, nothing in between.
      The same PRNG stream, shuffle draws and integer datapath as the
      JAX session, so the programs and histories are the same.

    ``dispatches`` counts what the JAX session counts: host-device round
    trips, one per epoch and one per ``step()``.  ``replays`` counts CUDA
    graph launches (0 where the bodies run eagerly: the CPU, ``ref``).
    The program and PRNG a session hands out (:meth:`state`,
    :meth:`unbind`) are copies that no later step writes.
    """

    def __init__(self, engine: DTMEngine, program: DTMProgram, prng: PRNG,
                 spec=None):
        self.engine = engine
        self.spec = spec
        self.program = program
        self.prng = prng
        self.steps = 0          # train batches consumed
        self.dispatches = 0     # host-device round trips (the JAX probe)
        self.replays = 0        # CUDA graph launches
        self._lits: Optional[torch.Tensor] = None   # staged [N, (P,) W]
        self._labels: Optional[torch.Tensor] = None  # staged [N]
        self.n = 0

    @property
    def conv(self) -> bool:
        return getattr(self.spec, "kind", None) == "conv"

    def _encode(self, x) -> torch.Tensor:
        if self.spec is not None:
            return self.engine.encode(self.spec, x)
        return self.engine.pad_features(x)

    def _encode_labels(self, y) -> torch.Tensor:
        lab = (self.spec.encode_labels(y) if self.spec is not None
               else torch.as_tensor(np.asarray(y)).to(torch.int32))
        return lab.to(self.engine.device)

    def stage(self, x, y) -> "TMSession":
        """Encode the whole dataset once and keep it on the device."""
        with span("session.encode"):
            self._lits = self._encode(x)
            self._labels = self._encode_labels(y)
        self.n = int(self._lits.shape[0])
        return self

    def step(self, x, y) -> Dict[str, torch.Tensor]:
        """One engine train step on a fresh (unstaged) batch."""
        with span("session.encode"):
            lits, lab = self._encode(x), self._encode_labels(y)
        self.program, self.prng, stats = self.engine._session_step(
            self.conv, self.program, self.prng, lits, lab)
        self.steps += 1
        self.dispatches += 1
        self.replays += int(self.engine.graphed)
        return stats

    def fit_epochs(self, epochs: int, batch: int = 32,
                   rng: Optional[np.random.Generator] = None,
                   log_every: int = 0, score_fn: Optional[Callable] = None,
                   x_test=None, y_test=None,
                   extra_metrics: Optional[Callable] = None,
                   sync_guard: bool = False) -> list:
        """Run ``epochs`` epochs over the staged data, ``batch`` rows a
        step; one ``rng.permutation(n)`` per epoch, as the JAX session
        draws it.  Returns the per-epoch records of
        :func:`repro_torch.core.evaluate.epoch_record`.  ``sync_guard``
        makes any host-device synchronisation between an epoch's plan
        upload and its stats fetch raise (CUDA only; the first epoch
        captures its graph before the guarded steps)."""
        if self._lits is None:
            raise RuntimeError("bind data first: engine.bind(p, x, y)")
        rng = rng or np.random.default_rng(0)
        n = self.n - self.n % batch
        steps = n // batch
        if steps == 0:
            raise ValueError(f"{self.n} staged rows make no batch of {batch}")
        fit = (self.engine._fit_epoch_conv_impl if self.conv
               else self.engine._fit_epoch_impl)
        history = []
        for ep in range(epochs):
            with span("session.epoch"):
                with span("epoch.plan"):
                    idx = rng.permutation(self.n)[:n].reshape(steps, batch)
                self.program, self.prng, step_stats = fit(
                    self.program, self.prng, self._lits, self._labels, idx,
                    sync_guard=sync_guard)
                self.dispatches += 1
                self.replays += steps if self.engine.graphed else 0
                self.steps += steps
                # exact integer epoch totals from the per-step stats
                with span("epoch.fetch"):
                    per_step = step_stats.cpu().numpy()  # dtmlint: disable=DTM003 (the epoch's one fetch)
                agg = {k: int(per_step[:, i].sum(dtype=np.int64))
                       for i, k in enumerate(STAT_KEYS)}
                rec = epoch_record(ep, agg, n, extra_metrics)
            if score_fn is not None and x_test is not None:
                rec["test_acc"] = score_fn(x_test, y_test)
            history.append(rec)
            if log_every and ep % log_every == 0:
                print(rec)
        return history

    def state(self) -> Tuple[DTMProgram, PRNG]:
        """Current (program, PRNG): copies, unchanged by later steps."""
        return self.program, self.prng

    def unbind(self) -> Tuple[DTMProgram, PRNG]:
        """Close the session: release staged data, return final state."""
        self._lits = self._labels = None
        return self.program, self.prng
