"""Dynamic Tsetlin Machine engine, inference half, in PyTorch.

One engine geometry (:class:`~repro_torch.core.types.TileConfig`) runs any
TM model as *data*: a :class:`DTMProgram` holds the padded TA states,
weights and masks of one model, and swapping programs swaps the model.
Vanilla TM runs on the coalesced datapath as a block-diagonal frozen ±1
weight matrix (the paper's Eq 3), as in the JAX engine.

The engine keeps the JAX engine's layouts: packed literals ``[B, W]``,
include bitplane ``[R, W]``, weights ``[H, R]``, sums ``[B, H]`` and
clauses ``[B, R]``.  A bank of K programs is a :class:`DTMProgram` whose
leaves carry a leading K axis; the kernels take that axis directly, so
``infer_bank``/``predict_bank`` launch each kernel once for K programs.
Every stage runs on the engine's device: the CUDA kernels on the card, or
their plain versions on the CPU.

Per stage the engine records the clause kernel it ran in
``cache_report()["path_per_stage"]``: ``packed_vpu`` (edge kernel, batch
<= 4) or ``mxu_popcount`` (tile kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF_SUM, pack_include
from .booleanize import pack_literals, words_from_u32
from .types import COALESCED, TMConfig, TileConfig

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for and no card is present; there
    is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


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
    """Tiled TM executor for inference on one device.

    ``device`` defaults to CUDA (the kernels); ``device="cpu"`` runs the
    kernels' plain versions.  ``kernel_path`` forces one clause kernel
    (:data:`repro_torch.kernels.ops.PATHS`) instead of the batch-based
    choice of :func:`repro_torch.kernels.ops.select_path`.
    """

    def __init__(self, tile: TileConfig, rand_bits: int = 16,
                 device: Device = None, kernel_path: Optional[str] = None):
        self.device = resolve_device(device)
        if kernel_path is not None:
            kops.select_path(1, force=kernel_path)      # validates the name
        self.kernel_path = kernel_path
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
        self._stage_paths[stage] = path
        return path

    def _clause_outputs(self, progs: DTMProgram, plits: torch.Tensor,
                        eval_mode: bool, stage: str) -> torch.Tensor:
        """Clause stage: packed [K, B, W] literals -> [K, B, R] int32."""
        path = self._eval_path(plits.shape[1], stage)
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

    def infer_fn(self, spec) -> Callable:
        if getattr(spec, "kind", None) == "conv":
            raise NotImplementedError("the conv kind is not ported yet")
        return self.infer

    def cache_report(self) -> dict:
        """``path_per_stage``: the clause kernel each stage ran last."""
        return {"path_per_stage": dict(self._stage_paths)}
