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
update emits the new include bitplane, and the weight nudges are exact
integer scatter-adds.  Steps return new programs; the inputs are left as
they were.  No step reads the device from the host.

A forced ``kernel_path="mxu"`` runs the dense clause kernel on int8
literals and include unpacked on the device (``clause_eval``; in training
the unfused front half: ``clause_eval``, ``class_sum`` and the torch
selection); ``ta_prng="stream"`` makes the TA update read its random
words from a pre-made [K, 2B, R, L] tensor (the streamed baseline, dense
update).  Both give the same results as the default paths.

Per stage the engine records the kernels it ran in
``cache_report()["path_per_stage"]``: ``packed_vpu``, ``mxu_popcount``,
``mxu`` or ``fused`` for the clause stage, ``<stage>_ta`` =
``compact``/``dense`` and ``<stage>_prng`` = ``<family>-inkernel`` or
``<family>-stream`` (family ``counter`` or ``lfsr``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import M32, NEG_INF_SUM, pack_include
from .booleanize import pack_literals, unpack_literals, words_from_u32
from .device import Device, resolve_device
from .evaluate import epoch_record
from .prng import PRNG
from .types import COALESCED, TMConfig, TileConfig

# A train step returns exactly these int32 stats; fit_epochs sums the
# per-step values on the host into the plain ints of the epoch records.
STAT_KEYS = ("selected", "active_groups", "total_groups", "correct",
             "abs_err")

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


class DTMEngine:
    """Tiled TM executor (inference and training) on one device.

    ``device`` defaults to CUDA (the kernels); ``device="cpu"`` runs the
    kernels' plain versions.  ``kernel_path`` forces one clause datapath
    (:data:`repro_torch.kernels.ops.PATHS`: the JAX package's
    ``REPRO_KERNEL_PATH``, as an argument) instead of the batch-based
    choice of :func:`repro_torch.kernels.ops.select_path`.  ``skip``
    selects the Alg-6 compacted TA update (``REPRO_SKIP``); off, every
    step runs the dense one.  ``ta_prng`` is the provenance of the TA
    update's random words (``REPRO_TA_PRNG``): ``"inkernel"`` (made in the
    kernel) or ``"stream"`` (made first as a tensor, read by the dense
    streamed kernel).  Every choice gives the same states.
    """

    def __init__(self, tile: TileConfig, rand_bits: int = 16,
                 device: Device = None, kernel_path: Optional[str] = None,
                 skip: bool = True, ta_prng: str = kops.TA_PRNG_INKERNEL):
        self.device = resolve_device(device)
        if kernel_path is not None:
            kops.select_path(1, force=kernel_path)      # validates the name
        kops.select_ta_path(ta_prng=ta_prng)            # validates the name
        self.kernel_path = kernel_path
        self.skip = skip
        self.ta_prng = ta_prng
        self.tile = tile
        self.rand_bits = rand_bits
        self.L, self.R, self.H = tile.padded_dims()
        self.P = tile.max_patches
        self.W = tile.packed_words()
        self._stage_paths: dict = {}

    # ------------------------------------------------------------------ #
    # programming                                                         #
    # ------------------------------------------------------------------ #
    def program(self, cfg: TMConfig,
                generator: Optional[torch.Generator] = None,
                ta=None, weights=None) -> DTMProgram:
        """Build the padded program of a model config.

        ``ta`` [rows, 2f] and ``weights`` [classes, clauses] (coalesced
        only) give the states; whatever is not given is drawn from
        ``generator`` (a CPU ``torch.Generator``) as the JAX engine draws
        it: TA states at J-1 or J, coalesced weights ±1."""
        L, R, H = self.L, self.R, self.H
        f, c, h = cfg.features, cfg.clauses, cfg.classes
        rows = cfg.total_clauses
        if 2 * f > L or rows > R or h > H:
            raise ValueError(f"model {(2 * f, rows, h)} exceeds engine "
                             f"buffers {(L, R, H)}")
        if cfg.T >= (1 << 13):
            raise ValueError(f"T={cfg.T} exceeds the 13-bit margin compare")
        need_draw = ta is None or (cfg.tm_type == COALESCED
                                   and weights is None)
        if need_draw and generator is None:
            raise ValueError("pass ta/weights or a torch.Generator to draw "
                             "them from")
        half = L // 2
        if ta is None:
            bern = torch.randint(0, 2, (rows, cfg.literals),
                                 generator=generator, dtype=torch.int32)
            ta = cfg.include_threshold - 1 + bern
        ta = torch.as_tensor(ta).to(torch.int32).cpu()
        ta_pad = torch.zeros((R, L), dtype=torch.int32)
        ta_pad[:rows, :f] = ta[:, :f]
        ta_pad[:rows, half:half + f] = ta[:, f:]

        w_pad = torch.zeros((H, R), dtype=torch.int32)
        if cfg.tm_type == COALESCED:
            if weights is None:
                bw = torch.randint(0, 2, (h, c), generator=generator,
                                   dtype=torch.int32)
                weights = 2 * bw - 1
            w_pad[:h, :c] = torch.as_tensor(weights).to(torch.int32).cpu()
            frozen = False
        else:   # Vanilla: block-diagonal frozen ±1 (Eq 3)
            pol = torch.where(torch.arange(c) % 2 == 0, 1, -1).to(torch.int32)
            for cls in range(h):
                w_pad[cls, cls * c:(cls + 1) * c] = pol
            frozen = True

        l_mask = torch.zeros(L, dtype=torch.int32)
        l_mask[:f] = 1
        l_mask[half:half + f] = 1
        p_ta = int(round((1 << self.rand_bits) / cfg.s))
        ta_dtype = torch.uint8 if cfg.n_states <= 256 else torch.int32

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype)

        prog = DTMProgram(
            ta=ta_pad.to(ta_dtype), weights=w_pad,
            cl_mask=(torch.arange(R) < rows).to(torch.int32),
            l_mask=l_mask, h_mask=(torch.arange(H) < h).to(torch.int32),
            w_frozen=scalar(frozen, torch.bool),
            T=scalar(cfg.T, torch.int32),
            p_ta=words_from_u32(torch.tensor(p_ta, dtype=torch.int64)),
            boost=scalar(cfg.boost_true_positive, torch.bool),
            n_states=scalar(cfg.n_states, torch.int32),
            w_clip=scalar(cfg.weight_clip, torch.int32),
            regression=scalar(False, torch.bool),
            p_mask=(torch.arange(self.P) < 1).to(torch.int32),
            inc=pack_include(ta_pad, cfg.n_states))
        return prog.to(self.device)

    def lower(self, spec, generator: Optional[torch.Generator] = None,
              ta=None, weights=None) -> DTMProgram:
        """Lower a :class:`repro_torch.api.TMSpec` (duck-typed: ``kind``,
        ``tm_config()``) to a program.  The flat kinds (vanilla,
        coalesced, regression, head) are in this port; conv is not yet."""
        if getattr(spec, "kind", None) == "conv":
            raise NotImplementedError("the conv kind is not ported yet")
        cfg = spec.tm_config()
        if cfg.rand_bits != self.rand_bits:
            raise ValueError(f"spec rand_bits={cfg.rand_bits} != engine "
                             f"rand_bits={self.rand_bits}")
        regression = getattr(spec, "kind", None) == "regression"
        if regression and weights is None:
            # every clause votes +1 through a frozen unit weight row
            weights = torch.zeros((cfg.classes, cfg.clauses),
                                  dtype=torch.int32)
            weights[0] = 1
        prog = self.program(cfg, generator, ta=ta, weights=weights)
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

    def pad_features(self, bool_x) -> torch.Tensor:
        """[B, f] {0,1} -> packed literals [B, W] on the engine device."""
        return pack_literals(self._layout(
            torch.as_tensor(bool_x, device=self.device)))

    def encode(self, spec, x) -> torch.Tensor:
        """Raw model input -> packed engine literals [B, W] int32."""
        return pack_literals(self._layout(spec.to_bool(x, device=self.device)))

    def refresh_include(self, prog: DTMProgram) -> DTMProgram:
        """Rebuild the packed include bitplane from the TA states."""
        return dataclasses.replace(prog,
                                   inc=pack_include(prog.ta, prog.n_states))

    # ------------------------------------------------------------------ #
    # datapath stages (bank form: every leaf and operand has a K axis)    #
    # ------------------------------------------------------------------ #
    def _eval_path(self, batch: int, stage: str) -> str:
        path = kops.select_path(batch, force=self.kernel_path)
        if path == kops.PATH_FUSED:
            # the fused kernel exists for train steps only; eval stages run
            # its dense front half, as in the JAX engine
            path = kops.PATH_MXU
        self._stage_paths[stage] = path
        return path

    def _clause_outputs(self, progs: DTMProgram, plits: torch.Tensor,
                        eval_mode: bool, stage: str) -> torch.Tensor:
        """Clause stage: packed [K, B, W] literals -> [K, B, R] int32."""
        path = self._eval_path(plits.shape[1], stage)
        if path == kops.PATH_MXU:
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
        return kops.class_sum(cl, progs.weights)

    def _pin_class_sums(self, progs: DTMProgram, sums: torch.Tensor
                        ) -> torch.Tensor:
        """Padded class columns -> NEG_INF_SUM (the paper's Fig 6d)."""
        return torch.where(progs.h_mask[:, None, :] == 1, sums,
                           torch.full_like(sums, NEG_INF_SUM))

    def _infer_impl(self, progs: DTMProgram, plits: torch.Tensor,
                    stage: str) -> Tuple[torch.Tensor, torch.Tensor]:
        cl = self._clause_outputs(progs, plits, eval_mode=True, stage=stage)
        return self._pin_class_sums(progs, self._class_sums_raw(progs, cl)), cl

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
        (``packed_vpu``) or tile (``mxu_popcount``) clause kernel, or the
        unfused dense stages (``mxu``)."""
        path = kops.select_path(plits.shape[1], force=self.kernel_path,
                                training=True)
        self._stage_paths[stage] = path
        rest = (progs.weights, cls_lab, neg, sel_rand.to(torch.int32),
                progs.cl_mask, progs.h_mask, progs.T,
                progs.w_frozen.to(torch.int32))
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
                    stage: str, donate: bool = False):
        """One batched train step of K programs (bank form: every program
        leaf and PRNG state leaf has a leading K axis; ``plits`` [K, B, W],
        ``labels`` [K, B] int32).  Returns (programs, PRNGs, stats [K]).
        ``donate``: the compacted TA update writes into ``progs.ta`` and
        ``progs.inc`` in place."""
        K, B = plits.shape[:2]
        rb = self.rand_bits
        n_cls = progs.h_mask.sum(dim=-1)                               # [K]
        reg = progs.regression                                         # [K]

        # the draws, in the JAX engine's order: one stream position per
        # datapoint, both selection rounds, then the TA-update seed
        prngs, c_rand = prngs.bits((B,))
        prngs, sel_rand = prngs.bits((2, B, self.R))
        prngs, seed_bits = prngs.bits((2,))
        ta_seed = ((seed_bits[:, 0] << rb) | seed_bits[:, 1]) & M32

        # regression programs carry a vote target in `labels`; the class
        # machinery runs on a pinned in-range label
        labels = labels.to(torch.int32)
        cls_lab = torch.where(reg[:, None], torch.zeros_like(labels), labels)
        rn = (c_rand % torch.clamp(n_cls - 1, min=1)[:, None]).to(torch.int32)
        neg = torch.where(rn < cls_lab, rn, rn + 1)                    # [K, B]

        cl, sums_m, sel_lab, sel_neg = self._train_front(
            progs, plits, cls_lab, neg, sel_rand, stage)
        hits = (torch.argmax(sums_m, dim=-1) == labels).sum(
            dim=-1, dtype=torch.int32)
        correct = torch.where(reg, torch.zeros_like(hits), hits)

        # Regression TM: clipped vote count against the target; the error
        # picks Type I (under) or Type II (over) through the same compare
        T = progs.T[:, None]
        votes = torch.minimum(cl.sum(dim=-1, dtype=torch.int32).clamp(min=0),
                              T)
        err = labels - votes                                           # [K, B]
        sel_reg = ((sel_rand[:, 0].to(torch.int32) * (2 * T)[..., None])
                   < (err.abs()[..., None] << rb))
        sel_reg = sel_reg.to(torch.int32) * progs.cl_mask[:, None, :]
        abs_err = err.abs().sum(dim=-1, dtype=torch.int32)

        # Type I / II split per round by the sign of the class's weight
        # row (regression: by the sign of the error)
        def rows_of(cls):
            idx = cls.long()[..., None].expand(K, B, self.R)
            return torch.gather(progs.weights, 1, idx)
        w_lab, w_neg = rows_of(cls_lab), rows_of(neg)
        regb = reg[:, None, None]
        zero = torch.zeros_like(sel_lab)
        t1_lab = torch.where(regb, sel_reg * (err > 0)[..., None],
                             sel_lab * (w_lab >= 0))
        t2_lab = torch.where(regb, sel_reg * (err < 0)[..., None],
                             sel_lab * (w_lab < 0))
        t1_neg = torch.where(regb, zero, sel_neg * (w_neg < 0))
        t2_neg = torch.where(regb, zero, sel_neg * (w_neg >= 0))
        sel_lab = torch.where(regb, sel_reg, sel_lab)
        sel_neg = torch.where(regb, zero, sel_neg)

        # TA update over both rounds joined into one 2B batch (target
        # rows, then negated rows), streams made in the kernel (or, for
        # the streamed baseline, made first and read by the kernel)
        lit2 = torch.cat([plits, plits], dim=1)
        cl2 = torch.cat([cl, cl], dim=1)
        t1 = torch.cat([t1_lab, t1_neg], dim=1)
        t2 = torch.cat([t2_lab, t2_neg], dim=1)
        ta_path = kops.select_ta_path(lanes, self.skip, self.ta_prng)
        family = "lfsr" if prngs.backend == "lfsr" else "counter"
        self._stage_paths[stage + "_ta"] = ta_path
        self._stage_paths[stage + "_prng"] = f"{family}-{self.ta_prng}"
        kw = dict(seed=ta_seed, p_ta=progs.p_ta, boost=progs.boost,
                  n_states=progs.n_states, rand_bits=rb, prng=family,
                  lfsr_bits=prngs.lfsr_bits, seed_refresh=prngs.seed_refresh)
        if ta_path == kops.TA_COMPACT:
            new_ta, new_inc = kops.ta_update_compact_op(
                progs.ta, lit2, cl2, t1, t2, progs.l_mask, progs.inc,
                inplace=donate, **kw)
        else:
            new_ta, new_inc = kops.ta_update_op(
                progs.ta, lit2, cl2, t1, t2, progs.l_mask,
                stream=self.ta_prng == kops.TA_PRNG_STREAM, **kw)

        new_w, stats = self._weights_and_stats(
            progs, cl, sel_lab, sel_neg, cls_lab, neg, correct, abs_err)
        new = dataclasses.replace(progs, ta=new_ta.to(progs.ta.dtype),
                                  weights=new_w, inc=new_inc)
        return new, prngs, stats

    def _weights_and_stats(self, progs: DTMProgram, cl, sel_lab, sel_neg,
                           lab, neg, correct, abs_err):
        """Alg-4 weight nudges as exact int32 scatter-adds, and the Alg-6
        group accounting on the engine's y-tile (128-row) groups."""
        K, B, R = cl.shape
        d_w = torch.zeros_like(progs.weights)
        d_w.scatter_add_(1, lab.long()[..., None].expand(K, B, R),
                         sel_lab * cl)
        d_w.scatter_add_(1, neg.long()[..., None].expand(K, B, R),
                         -(sel_neg * cl))
        clip = progs.w_clip[:, None, None]
        new_w = torch.where(progs.w_frozen[:, None, None], progs.weights,
                            torch.clamp(progs.weights + d_w, -clip, clip))
        d_sel = (sel_lab + sel_neg).sum(dim=1, dtype=torch.int32)     # [K, R]
        y = self.tile.y
        g = (d_sel > 0).to(torch.int32).reshape(K, -1, y).amax(dim=-1)
        gmask = progs.cl_mask.reshape(K, -1, y).amax(dim=-1)
        stats = {"selected": d_sel.sum(dim=-1, dtype=torch.int32),
                 "active_groups": (g * gmask).sum(dim=-1, dtype=torch.int32),
                 "total_groups": gmask.sum(dim=-1, dtype=torch.int32),
                 "correct": correct, "abs_err": abs_err}
        return new_w, stats

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
        return (new.map(lambda t: t[0]), prngs[0],
                {k: v[0] for k, v in stats.items()})

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
        if getattr(spec, "kind", None) == "conv":
            raise NotImplementedError("conv training is not ported yet")
        return self.train_step

    def infer_fn(self, spec) -> Callable:
        if getattr(spec, "kind", None) == "conv":
            raise NotImplementedError("the conv kind is not ported yet")
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

    def cache_report(self) -> dict:
        """``path_per_stage``: the kernels each stage ran last (the clause
        datapath per stage; ``<stage>_ta`` and ``<stage>_prng`` for the TA
        update of the train stages)."""
        return {"path_per_stage": dict(self._stage_paths)}


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
      ``partial_fit`` path).
    * ``fit_epochs(n)`` — the staged dataset is gathered on the device
      per the epoch's shuffled index plan: one upload of the plan and one
      fetch of the stacked per-step stats per epoch, nothing in between.
      The same PRNG stream, shuffle draws and integer datapath as the
      JAX session, so the programs and histories are the same.
    """

    def __init__(self, engine: DTMEngine, program: DTMProgram, prng: PRNG,
                 spec=None):
        self.engine = engine
        self.spec = spec
        self.program = program
        self.prng = prng
        self.steps = 0          # train batches consumed
        self.epoch_s: list = []  # host seconds per fit_epochs epoch
        self._lits: Optional[torch.Tensor] = None   # staged [N, W]
        self._labels: Optional[torch.Tensor] = None  # staged [N]
        self.n = 0

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
        self._lits = self._encode(x)
        self._labels = self._encode_labels(y)
        self.n = int(self._lits.shape[0])
        return self

    def step(self, x, y) -> Dict[str, torch.Tensor]:
        """One engine train step on a fresh (unstaged) batch."""
        lits, lab = self._encode(x), self._encode_labels(y)
        fn = self.engine.train_fn(self.spec)
        self.program, self.prng, stats = fn(self.program, self.prng, lits,
                                            lab)
        self.steps += 1
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
        upload and its stats fetch raise (CUDA only).  ``epoch_s`` gets
        each epoch's host seconds, from the upload to the fetch."""
        if self._lits is None:
            raise RuntimeError("bind data first: engine.bind(p, x, y)")
        rng = rng or np.random.default_rng(0)
        n = self.n - self.n % batch
        steps = n // batch
        if steps == 0:
            raise ValueError(f"{self.n} staged rows make no batch of {batch}")
        dev = self.engine.device
        # the session's own TA states and include bitplane, which every
        # step below updates in place: nothing a caller holds changes
        self.program = dataclasses.replace(
            self.program, ta=self.program.ta.clone(),
            inc=self.program.inc.clone())
        history = []
        for ep in range(epochs):
            idx = rng.permutation(self.n)[:n].reshape(steps, batch)
            t0 = time.perf_counter()
            plan = torch.from_numpy(idx.astype(np.int64)).to(dev)
            rows = []
            with _sync_guard(dev, sync_guard):
                for s in range(steps):
                    ib = plan[s]
                    self.program, self.prng, stats = self.engine.train_step(
                        self.program, self.prng,
                        self._lits.index_select(0, ib),
                        self._labels.index_select(0, ib), donate=True)
                    rows.append(torch.stack([stats[k] for k in STAT_KEYS]))
            self.steps += steps
            # exact integer epoch totals from the per-step stats
            per_step = torch.stack(rows).cpu().numpy()
            self.epoch_s.append(time.perf_counter() - t0)
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
        """Current (program, PRNG)."""
        return self.program, self.prng

    def unbind(self) -> Tuple[DTMProgram, PRNG]:
        """Close the session: release staged data, return final state."""
        self._lits = self._labels = None
        return self.program, self.prng
