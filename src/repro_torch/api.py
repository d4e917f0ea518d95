"""One engine, every flat TM kind: the ``compile → lower → run`` front end.

    spec   = TMSpec.coalesced(features=784, classes=10, clauses=128)
    engine = api.compile(api.tile_for(spec))              # on the card
    prog   = engine.lower(spec, torch.Generator().manual_seed(0))
    sums, clauses = engine.infer(prog, engine.encode(spec, x))

or the estimator shell, ``TM(spec).fit(x, y)`` / ``.partial_fit`` /
``.predict(x)`` / ``.score(x, y)``, and :func:`stack` for a
:class:`ProgramBank` of K programs served and trained by one launch per
kernel.  :class:`TMSpec` serialises to the same JSON as the JAX package's,
so specs cross between the two packages.  The conv kind comes later.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.booleanize import Booleanizer, fit_thermometer
from repro_torch.core.device import resolve_device
from repro_torch.core.dtm import Device, DTMEngine, DTMProgram
from repro_torch.core.prng import PRNG
from repro_torch.core.evaluate import accuracy, batched_predict
from repro_torch.core.types import (COALESCED, PRNG_BACKENDS, TMConfig,
                                    TileConfig, VANILLA)

KINDS = ("vanilla", "coalesced", "conv", "regression", "head")


@dataclasses.dataclass(frozen=True, eq=False)
class TMSpec:
    """Tagged union over the TM model family (the JAX ``TMSpec``'s fields).

    Use the per-kind constructors; the raw fields are the serialised form
    (:meth:`to_dict` / :meth:`from_dict`)."""

    kind: str
    features: int = 0
    clauses: int = 128
    classes: int = 2
    T: int = 16
    s: float = 4.0
    ta_bits: int = 8
    weight_bits: int = 12
    rand_bits: int = 16
    prng_backend: str = "counter"
    lfsr_bits: int = 24
    seed_refresh: bool = True
    boost_true_positive: bool = True
    img_h: int = 0
    img_w: int = 0
    patch: int = 0
    thresholds: Optional[np.ndarray] = None

    @classmethod
    def vanilla(cls, features: int, classes: int, clauses: int = 128,
                **kw) -> "TMSpec":
        return cls(kind="vanilla", features=features, classes=classes,
                   clauses=clauses, **kw)

    @classmethod
    def coalesced(cls, features: int, classes: int, clauses: int = 128,
                  **kw) -> "TMSpec":
        return cls(kind="coalesced", features=features, classes=classes,
                   clauses=clauses, **kw)

    @classmethod
    def conv(cls, img_h: int, img_w: int, patch: int, classes: int,
             clauses: int = 64, **kw) -> "TMSpec":
        if not 0 < patch <= min(img_h, img_w):
            raise ValueError(f"patch={patch} does not fit {img_h}x{img_w}")
        return cls(kind="conv", img_h=img_h, img_w=img_w, patch=patch,
                   classes=classes, clauses=clauses, **kw)

    @classmethod
    def regression(cls, features: int, clauses: int = 128, T: int = 128,
                   s: float = 3.0, **kw) -> "TMSpec":
        return cls(kind="regression", features=features, clauses=clauses,
                   T=T, s=s, **kw)

    @classmethod
    def head(cls, calib: np.ndarray, classes: int, therm_bits: int = 4,
             clauses: int = 128, T: int = 64, s: float = 5.0,
             **kw) -> "TMSpec":
        """CoTM readout over float features; fits the thermometer
        booleanizer from a calibration array [n, f_raw]."""
        booleanizer = fit_thermometer(np.asarray(calib), bits=therm_bits)
        return cls(kind="head", classes=classes, clauses=clauses, T=T, s=s,
                   thresholds=booleanizer.thresholds, **kw)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind={self.kind!r} not one of {KINDS}")
        if self.prng_backend not in PRNG_BACKENDS:
            raise ValueError(
                f"prng_backend={self.prng_backend!r} not recognised; "
                f"use one of {PRNG_BACKENDS}")

    @property
    def pos_bits(self) -> int:
        return (self.img_h - self.patch) + (self.img_w - self.patch)

    @property
    def n_patches(self) -> int:
        if self.kind != "conv":
            return 1
        return (self.img_h - self.patch + 1) * (self.img_w - self.patch + 1)

    @property
    def bool_features(self) -> int:
        """Boolean features seen by the clause datapath."""
        if self.kind == "conv":
            return self.patch * self.patch + self.pos_bits
        if self.kind == "head":
            return int(self.thresholds.shape[0] * self.thresholds.shape[1])
        return self.features

    def tm_config(self) -> TMConfig:
        common = dict(features=self.bool_features, clauses=self.clauses,
                      s=self.s, ta_bits=self.ta_bits,
                      weight_bits=self.weight_bits, rand_bits=self.rand_bits,
                      prng_backend=self.prng_backend,
                      lfsr_bits=self.lfsr_bits,
                      seed_refresh=self.seed_refresh,
                      boost_true_positive=self.boost_true_positive)
        if self.kind == "vanilla":
            return TMConfig(tm_type=VANILLA, classes=self.classes, T=self.T,
                            **common)
        if self.kind == "regression":
            # the class machinery is bypassed by the program's flag
            return TMConfig(tm_type=COALESCED, classes=2,
                            T=min(self.T, 8191), **common)
        return TMConfig(tm_type=COALESCED, classes=self.classes, T=self.T,
                        **common)

    def to_bool(self, x, device: Device = None) -> torch.Tensor:
        """Raw model input -> Boolean features on ``device`` (the card
        unless the caller asks for another; raises without one).

        vanilla/coalesced/regression: [B, f] {0,1} passthrough; head:
        [B, f_raw] float -> thermometer bits [B, f_raw*k]."""
        if self.kind == "conv":
            raise NotImplementedError("the conv kind is not ported yet")
        x = torch.as_tensor(x, device=resolve_device(device))
        if self.kind == "head":
            return Booleanizer(self.thresholds)(x)
        return x

    def encode_labels(self, y) -> torch.Tensor:
        """Targets -> int32 labels: regression floats in [0, 1] become
        integer vote targets in [0, T]; everything else class ids."""
        if self.kind == "regression":
            t = self.tm_config().T
            v = torch.round(torch.as_tensor(y, dtype=torch.float32) * t)
            return v.clamp(0, t).to(torch.int32)
        return torch.as_tensor(y).to(torch.int32)

    def decode_output(self, sums: torch.Tensor, cl: torch.Tensor
                      ) -> torch.Tensor:
        """Engine outputs -> prediction: regression, the clipped clause
        vote count over T (float32); everything else argmax class ids."""
        if self.kind == "regression":
            t = self.tm_config().T
            votes = cl.sum(dim=-1).clamp(0, t)
            return votes.to(torch.float32) / t
        return torch.argmax(sums, dim=-1)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["thresholds"] is not None:
            d["thresholds"] = np.asarray(d["thresholds"]).tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TMSpec":
        d = dict(d)
        if d.get("thresholds") is not None:
            d["thresholds"] = np.asarray(d["thresholds"], np.float32)
        return cls(**d)


def tile_for(*specs: TMSpec, x: int = 128, y: int = 128, m: int = 128,
             n: int = 8, batch_tile: int = 8) -> TileConfig:
    """Smallest engine geometry that fits every given spec."""
    if not specs:
        raise ValueError("tile_for needs at least one spec")
    cfgs = [s.tm_config() for s in specs]
    return TileConfig(
        x=x, y=y, m=m, n=n, batch_tile=batch_tile,
        max_features=max(c.features for c in cfgs),
        max_clauses=max(c.total_clauses for c in cfgs),
        max_classes=max(c.classes for c in cfgs),
        max_patches=max(s.n_patches for s in specs))


def compile(tile: Optional[TileConfig] = None, device: Device = None,
            rand_bits: int = 16, kernel_path: Optional[str] = None,
            skip: bool = True, ta_prng: str = "inkernel") -> DTMEngine:
    """Build the one engine for a geometry (on the card unless ``device``
    says otherwise).  ``kernel_path`` forces a clause datapath (``mxu``,
    ``packed_vpu``, ``mxu_popcount`` or ``fused``), ``skip=False`` trains
    with the dense TA update and ``ta_prng="stream"`` with the streamed
    random words: the JAX package's ``REPRO_KERNEL_PATH``, ``REPRO_SKIP``
    and ``REPRO_TA_PRNG``, as arguments."""
    return DTMEngine(tile or TileConfig(), rand_bits=rand_bits,
                     device=device, kernel_path=kernel_path, skip=skip,
                     ta_prng=ta_prng)


class TM:
    """Estimator shell for one spec: ``fit``, ``partial_fit``,
    ``predict``, ``class_sums``, ``score``.

    The program is lowered from ``seed`` through a CPU ``torch.Generator``;
    it follows the JAX estimator's construction (TA states at J-1/J, ±1
    weights) but not its random numbers.  The PRNG is the spec's backend
    from ``seed + 1``, as in the JAX estimator (``threefry`` raises).
    Assigning ``program`` and ``prng`` from the JAX package's (through
    :mod:`repro_torch.convert`) reproduces its training exactly.
    """

    def __init__(self, spec: TMSpec, engine: Optional[DTMEngine] = None,
                 tile: Optional[TileConfig] = None, device: Device = None,
                 seed: int = 0):
        self.spec = spec
        self.cfg = spec.tm_config()
        self.engine = (engine if engine is not None
                       else compile(tile or tile_for(spec), device=device,
                                    rand_bits=self.cfg.rand_bits))
        self.prng = PRNG.create(self.cfg, seed + 1, device=self.engine.device)
        self.program: DTMProgram = self.engine.lower(
            spec, torch.Generator().manual_seed(seed))
        self.steps = 0
        self._stream = None       # streaming session of partial_fit
        # lifetime Alg-6 accounting, kept on the device until skip_frac
        self._skip_active = 0
        self._skip_total = 0
        self.epoch_seconds: List[float] = []   # of the last fit

    def _extra_metrics(self) -> Optional[Callable]:
        if self.spec.kind != "regression":
            return None
        return lambda agg, n: {
            "train_mae": agg.get("abs_err", 0) / max(n * self.cfg.T, 1),
            "train_acc": None}

    def partial_fit(self, x, y) -> dict:
        """One engine train step on a batch; returns the stats (0-d int32
        tensors on the engine device)."""
        if self._stream is None:
            self._stream = self.engine.bind(self.program, spec=self.spec,
                                            prng=self.prng)
        self._stream.program, self._stream.prng = self.program, self.prng
        stats = self._stream.step(x, y)
        self.program, self.prng = self._stream.state()
        self.steps += 1
        self._skip_active = self._skip_active + stats["active_groups"]
        self._skip_total = self._skip_total + stats["total_groups"]
        return stats

    def fit(self, x, y, epochs: int = 1, batch: int = 32,
            log_every: int = 0, x_test=None, y_test=None,
            rng: Optional[np.random.Generator] = None,
            sync_guard: bool = False) -> list:
        """Stage (x, y) on the device once, then ``epochs`` epochs of
        ``batch``-row steps (``TMSession.fit_epochs``); returns the
        per-epoch records.  ``sync_guard`` raises on a host-device
        synchronisation inside an epoch's steps."""
        session = self.engine.bind(self.program, x, y, spec=self.spec,
                                   prng=self.prng)

        def _score(xt, yt):
            self.program, self.prng = session.state()
            return self.score(xt, yt)

        steps_before = session.steps
        try:
            history = session.fit_epochs(
                epochs, batch=batch, rng=rng, log_every=log_every,
                score_fn=(None if x_test is None else _score),
                x_test=x_test, y_test=y_test,
                extra_metrics=self._extra_metrics(), sync_guard=sync_guard)
        finally:
            self.program, self.prng = session.unbind()
            self.steps += session.steps - steps_before
            self.epoch_seconds = list(session.epoch_s)
        for rec in history:
            self._skip_active = self._skip_active + rec["active_groups"]
            self._skip_total = self._skip_total + rec["total_groups"]
        return history

    @property
    def skip_frac(self) -> Optional[float]:
        """Lifetime Alg-6 clause-skip fraction: the share of 128-row
        clause groups that got no feedback over all training so far
        (``None`` before any)."""
        tot = int(self._skip_total)
        if tot == 0:
            return None
        return 1.0 - int(self._skip_active) / tot

    def _infer(self, x):
        lits = self.engine.encode(self.spec, x)
        return self.engine.infer_fn(self.spec)(self.program, lits)

    def predict(self, x) -> torch.Tensor:
        """Class ids [B], or predictions in [0, 1] [B] for regression."""
        return self.spec.decode_output(*self._infer(x))

    def class_sums(self, x) -> torch.Tensor:
        sums, _ = self._infer(x)
        return sums

    def score(self, x, y, batch: int = 256) -> float:
        """Accuracy, or -MAE for regression (higher is better)."""
        if self.spec.kind == "regression":
            pred = batched_predict(self.predict, x, batch=batch)
            return -float(np.abs(pred - np.asarray(y)).mean())
        return accuracy(self.predict, x, y, batch=batch)


class ProgramBank:
    """K same-geometry programs stacked on a leading axis.

    :meth:`infer`/:meth:`predict`/:meth:`train` run all K through one
    launch per kernel.  :meth:`swap_in` writes a slot in place on the
    device; :meth:`swap_out` returns a copy, never a view, so a later
    ``swap_in`` or ``train`` cannot change a program that was read out."""

    def __init__(self, engine: DTMEngine, progs: DTMProgram, k: int,
                 prngs: Optional[PRNG] = None):
        self.engine = engine
        self.progs = progs          # stacked leaves: [K, ...]
        self.k = k
        self.prngs = prngs          # stacked PRNG (train-capable banks)

    def infer(self, lits):
        """lits [K, B, W] (or K arrays [B, W]) ->
        (sums [K, B, H], clause [K, B, R])."""
        return self.engine.infer_bank(self.progs, lits)

    def predict(self, lits):
        """-> (argmax preds [K, B] int32, clipped clause votes [K, B] int32)."""
        return self.engine.predict_bank(self.progs, lits)

    def train(self, lits, labels) -> dict:
        """One stacked train step: program k takes batch k (lits
        [K, B, W], labels [K, B]).  The bank's programs and PRNGs advance;
        returns the stats, [K] int32 per key."""
        if self.prngs is None:
            raise ValueError("bank built without PRNGs; pass prngs= to "
                             "api.stack")
        labels = torch.as_tensor(labels).to(device=self.engine.device,
                                            dtype=torch.int32)
        self.progs, self.prngs, stats = self.engine.train_bank(
            self.progs, self.prngs, lits, labels)
        return stats

    def swap_in(self, k: int, program: DTMProgram) -> None:
        """Overwrite slot ``k`` with ``program`` (in place, on the device)."""
        for slot, leaf in zip(self.progs.leaves(), program.leaves()):
            slot[k].copy_(leaf)

    def swap_out(self, k: int) -> DTMProgram:
        """Slot ``k`` as an independent program (a copy)."""
        return self.progs.map(lambda t: t[k].clone())

    def unstack(self) -> List[DTMProgram]:
        return [self.swap_out(i) for i in range(self.k)]

    @property
    def nbytes(self) -> int:
        return self.progs.nbytes


def stack(programs: Sequence[DTMProgram], engine: DTMEngine,
          prngs: Optional[Sequence[PRNG]] = None) -> ProgramBank:
    """Stack same-geometry programs (lowered on one engine with uniform
    ta_bits) into a :class:`ProgramBank` on the engine's device.
    ``prngs`` (one per program, one configuration) arm it for training."""
    programs = list(programs)
    if not programs:
        raise ValueError("stack() needs at least one program")
    first = programs[0].leaves()
    for p in programs[1:]:
        for a, b in zip(first, p.leaves()):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    "bank programs must share padded shapes and dtypes "
                    f"(got {tuple(a.shape)}/{a.dtype} vs "
                    f"{tuple(b.shape)}/{b.dtype})")
    leaves = zip(*(p.leaves() for p in programs))
    progs = DTMProgram(*(torch.stack([t.to(engine.device) for t in ls])
                         for ls in leaves))
    stacked = None
    if prngs is not None:
        prngs = list(prngs)
        if len(prngs) != len(programs):
            raise ValueError(f"{len(prngs)} PRNGs for {len(programs)} "
                             "programs")
        stacked = PRNG.stack([p.to(engine.device) for p in prngs])
    return ProgramBank(engine, progs, k=len(programs), prngs=stacked)
