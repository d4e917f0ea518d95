"""One engine, every flat TM kind: the ``compile → lower → run`` front end.

    spec   = TMSpec.coalesced(features=784, classes=10, clauses=128)
    engine = api.compile(api.tile_for(spec))              # on the card
    prog   = engine.lower(spec, threefry.key(0))        # JAX's program
    sums, clauses = engine.infer(prog, engine.encode(spec, x))

or the estimator shell, ``TM(spec).fit(x, y)`` / ``.partial_fit`` /
``.predict(x)`` / ``.score(x, y)`` / ``.save(dir)`` / ``TM.load(dir)``,
:func:`stack` for a :class:`ProgramBank` of K programs served and trained
by one launch per kernel (``stack(conv=True)``: a conv bank, served
only), :func:`serve`, the scheduled multi-tenant serving stack in one
call, and :func:`plan_for`, the per-mesh plan (tenant-parallel or
clause-sharded, :mod:`repro_torch.launch.pod`).  :class:`TMSpec`
serialises to the same JSON as the JAX package's
and ``TM.save`` writes its checkpoint format, so specs and saved models
cross between the two packages.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.booleanize import Booleanizer, fit_thermometer
from repro_torch.core.device import resolve_device
from repro_torch.core.dtm import (FIELDS, STAT_KEYS, Device, DTMEngine,
                                  DTMProgram, prng_like, store_step)
from repro_torch.core import threefry
from repro_torch.core.prng import PRNG
from repro_torch.core.evaluate import accuracy, batched_predict
from repro_torch.runtime.spans import span
from repro_torch.core.types import (COALESCED, PRNG_BACKENDS, TMConfig,
                                    TileConfig, VANILLA)

KINDS = ("vanilla", "coalesced", "conv", "regression", "head")


@functools.lru_cache(maxsize=None)
def _position_code(img_h: int, img_w: int, patch: int) -> np.ndarray:
    """Thermometer patch-position bits [P, pos_bits] int8 of a conv
    geometry, built once per geometry.  Every caller with the same
    geometry gets the same array, so it is read-only."""
    oh, ow = img_h - patch + 1, img_w - patch + 1
    pi = np.arange(oh)[:, None].repeat(ow, 1).reshape(-1)            # [P]
    pj = np.arange(ow)[None, :].repeat(oh, 0).reshape(-1)
    rt = (pi[:, None] > np.arange(oh - 1)[None, :]).astype(np.int8)
    ct = (pj[:, None] > np.arange(ow - 1)[None, :]).astype(np.int8)
    out = np.concatenate([rt, ct], -1)
    out.flags.writeable = False
    return out


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
        [B, f_raw] float -> thermometer bits [B, f_raw*k]; conv: [B, H, W]
        {0,1} images -> patch features [B, P, patch² + pos_bits] int8."""
        x = torch.as_tensor(x, device=resolve_device(device))
        if self.kind == "head":
            return Booleanizer(self.thresholds)(x)
        if self.kind == "conv":
            return self._patch_features(x)
        return x

    def _patch_features(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W] {0,1} -> [B, P, patch² + pos_bits]: each patch's bits
        (row-major within the patch, patches row-major) and its
        thermometer position code, the Granmo conv literals without the
        complement half (the engine layout adds it)."""
        B, k = images.shape[0], self.patch
        oh, ow = self.img_h - k + 1, self.img_w - k + 1
        patches = images.unfold(1, k, 1).unfold(2, k, 1)   # [B, oh, ow, k, k]
        patches = patches.reshape(B, oh * ow, k * k).to(torch.int8)
        pos = torch.as_tensor(
            np.array(_position_code(self.img_h, self.img_w, self.patch)),
            device=images.device)
        return torch.cat([patches, pos.expand(B, -1, -1)], dim=-1)

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


@dataclasses.dataclass(frozen=True)
class PodPlan:
    """A per-mesh execution plan: what :func:`plan_for` decided and why.

    ``mode``: ``"single"`` (one device, no sharding), ``"tenants"``
    (programs fit the per-device budget: a tenant-parallel
    :class:`repro_torch.launch.pod.PodBank` over ``axis``) or
    ``"clauses"`` (an over-budget program: one machine clause-sharded
    over ``axis`` in ``shards`` windows, :class:`repro_torch.launch.pod.
    ShardedTM`)."""

    mode: str
    axis: str
    shards: int
    tile: TileConfig
    program_bytes: int
    budget_bytes: int
    reason: str


def plan_for(mesh, *specs: TMSpec, vmem_budget: Optional[float] = None,
             **tile_kw) -> PodPlan:
    """:func:`tile_for` grown into a per-mesh planner (the JAX
    ``plan_for``): size the engine for the roster, then choose tenant- or
    clause-sharding by the padded program's bytes
    (:func:`repro_torch.launch.tm_perf.program_bytes`) against the
    per-device budget, ``vmem_budget`` or, by default, the H100's L2
    (:attr:`repro_torch.launch.mesh.HardwareModel.l2_bytes`; the JAX
    planner's default is the TPU's VMEM).  A program that fits serves
    tenant-parallel (no collectives); one that does not is clause-sharded
    over the fewest shards (dividing the padded R, at most the mesh's
    devices) whose window fits.  ``mesh`` is a ``DeviceMesh`` (or any
    object with ``mesh_dim_names`` and ``shape``)."""
    # imported here: the launch layer imports this module
    from repro_torch.launch import tm_perf
    from repro_torch.launch.mesh import H100, mesh_chips

    tile = tile_for(*specs, **tile_kw)
    L, R, H = tile.padded_dims()
    ta_bits = max(s.ta_bits for s in specs)
    pbytes = tm_perf.program_bytes(L, R, H, ta_bits=ta_bits,
                                   P=tile.max_patches)
    budget = int(vmem_budget if vmem_budget is not None else H100.l2_bytes)
    n = mesh_chips(mesh)
    axes = tuple(mesh.mesh_dim_names)
    if n <= 1:
        return PodPlan("single", axes[0] if axes else "", 1, tile, pbytes,
                       budget, "one device — nothing to shard")
    if pbytes <= budget:
        axis = "tenants" if "tenants" in axes else axes[0]
        return PodPlan(
            "tenants", axis, n, tile, pbytes, budget,
            f"program image {pbytes}B fits the {budget}B device budget: "
            f"tenant-parallel bank over '{axis}' ({n} devices)")
    axis = "clauses" if "clauses" in axes else axes[-1]
    shards = 1
    for s in range(2, n + 1):
        if R % s:
            continue
        shards = s
        if pbytes // s <= budget:
            break
    return PodPlan(
        "clauses", axis, shards, tile, pbytes, budget,
        f"program image {pbytes}B exceeds the {budget}B device budget: "
        f"clause-shard R={R} over '{axis}' x{shards} "
        f"({pbytes // shards}B per shard window)")


def compile(tile: Optional[TileConfig] = None, device: Device = None,
            rand_bits: int = 16, kernel_path: Optional[str] = None,
            skip: bool = True, ta_prng: str = "inkernel",
            autotune: str = "seed", autotune_cache=None) -> DTMEngine:
    """Build the one engine for a geometry (on the card unless ``device``
    says otherwise).  ``kernel_path`` forces a clause datapath (``mxu``,
    ``packed_vpu``, ``mxu_popcount``, ``fused``, or ``ref``: every stage's
    plain version, no clause or TA kernel), ``skip=False`` trains
    with the dense TA update and ``ta_prng="stream"`` with the streamed
    random words; ``autotune`` (``off``, ``seed`` or ``measure``) is the
    dispatcher's plan cache and ``autotune_cache`` its file: the JAX
    package's ``REPRO_KERNEL_PATH``, ``REPRO_SKIP``, ``REPRO_TA_PRNG``,
    ``REPRO_AUTOTUNE`` and ``REPRO_AUTOTUNE_CACHE``, as arguments.  An
    unknown name raises ``ValueError``."""
    return DTMEngine(tile or TileConfig(), rand_bits=rand_bits,
                     device=device, kernel_path=kernel_path, skip=skip,
                     ta_prng=ta_prng, autotune=autotune,
                     autotune_cache=autotune_cache)


class TM:
    """Estimator shell for one spec: ``fit``, ``partial_fit``,
    ``predict``, ``class_sums``, ``score``.

    The program is lowered from the threefry key ``PRNGKey(seed)`` and the
    PRNG is the spec's backend from ``seed + 1``, as in the JAX estimator,
    so a seed gives the JAX estimator's program and PRNG, and its training
    exactly.
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
            spec, threefry.key(seed, self.engine.device))
        self.steps = 0
        self._stream = None       # streaming session of partial_fit
        # lifetime Alg-6 accounting, kept on the device until skip_frac
        self._skip_active = 0
        self._skip_total = 0

    def _extra_metrics(self) -> Optional[Callable]:
        if self.spec.kind != "regression":
            return None
        return lambda agg, n: {
            "train_mae": agg.get("abs_err", 0) / max(n * self.cfg.T, 1),
            "train_acc": None}

    def partial_fit(self, x, y) -> dict:
        """One engine train step on a batch (``TMSession.step``: one
        replay of the step graph at this batch shape on the card);
        returns the stats (0-d int32 tensors on the engine device)."""
        with span("tm.partial_fit"):
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
        ``batch``-row steps (``TMSession.fit_epochs``: on the card one
        replay of the epoch graph's step a batch); returns the
        per-epoch records.  ``sync_guard`` raises on a host-device
        synchronisation inside an epoch's steps."""
        with span("tm.fit"):
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
                    extra_metrics=self._extra_metrics(),
                    sync_guard=sync_guard)
            finally:
                self.program, self.prng = session.unbind()
                self.steps += session.steps - steps_before
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
        """(sums, clauses) of a batch: one replay of the engine's
        inference graph at this batch shape on the card (``score`` pads
        its tail batch to its batch size, so it reuses that graph)."""
        lits = self.engine.encode(self.spec, x)
        return self.engine.served_infer(self.spec, self.program, lits)

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

    # ---- persistence (repro_torch.checkpoint: atomic, step-addressed) ------
    def save(self, ckpt_dir: str, step: Optional[int] = None,
             keep: int = 3) -> str:
        """Save the TA states, weights and PRNG as step ``step`` (default:
        the steps trained) in the JAX package's format; returns the
        step's directory.  The JAX package's ``TM.load`` reads it."""
        tree = {"ta": self.program.ta, "weights": self.program.weights,
                "prng": self.prng}
        # "auto": a backend name the JAX package's compile() accepts
        extra = {"spec": self.spec.to_dict(),
                 "tile": dataclasses.asdict(self.engine.tile),
                 "backend": "auto", "steps": self.steps}
        return checkpoint.save(ckpt_dir, self.steps if step is None else step,
                               tree, extra=extra, keep=keep)

    @classmethod
    def load(cls, ckpt_dir: str, engine: Optional[DTMEngine] = None,
             step: Optional[int] = None, seed: int = 0,
             device: Device = None) -> "TM":
        """A TM from a checkpoint of this package's or the JAX package's
        ``TM.save`` (the newest step unless ``step``), on ``engine`` or on
        a new engine of the saved tile on ``device`` (the card unless the
        caller asks for another).  The include bitplane is rebuilt from
        the restored TA states."""
        step = checkpoint.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                               "meta.json")) as f:
            extra = json.load(f)["extra"]
        spec = TMSpec.from_dict(extra["spec"])
        if engine is None:
            engine = compile(TileConfig(**extra["tile"]), device=device,
                             rand_bits=spec.tm_config().rand_bits)
        tm = cls(spec, engine=engine, seed=seed)
        tree, _ = checkpoint.restore(
            ckpt_dir, step,
            like={"ta": tm.program.ta, "weights": tm.program.weights,
                  "prng": tm.prng})
        tm.program = engine.refresh_include(dataclasses.replace(
            tm.program, ta=tree["ta"], weights=tree["weights"]))
        tm.prng = tree["prng"]
        tm.steps = int(extra.get("steps", 0))
        return tm


class ProgramBank:
    """K same-geometry programs stacked on a leading axis.

    :meth:`infer`/:meth:`predict`/:meth:`train` run all K through one
    launch per kernel; on the card a flush (:meth:`infer`,
    :meth:`predict`) is one replay of a CUDA graph per (stage, literal
    shape) that reads a static literal buffer and the bank's own program
    tensors, and a train step one replay of a graph per (literal, label)
    shape that writes the new TA states, weights, include bitplane and
    PRNG state into the bank's own tensors (the JAX ``train_bank``'s
    donation).  So ``progs`` and ``prngs`` stay the same objects with
    the same leaves, and no flush after a train step captures anew.
    :meth:`swap_in` writes a slot in place on the device, ordered before
    the next replay on the one stream, so a swap needs no new capture
    (the paper's reconfiguration without resynthesis); a bank whose
    program tensors are rebound (a new :func:`stack`) captures anew.
    :meth:`swap_out` returns a copy, never a view, so a later ``swap_in``
    or ``train`` cannot change a program that was read out.  Flat and
    conv programs cannot share a bank (their literals differ in rank); a
    conv bank (``conv=True``) serves through :meth:`infer` only, as in
    the JAX package: train conv programs through their sessions."""

    def __init__(self, engine: DTMEngine, progs: DTMProgram, k: int,
                 conv: bool = False, prngs: Optional[PRNG] = None):
        self.engine = engine
        self.progs = progs          # stacked leaves: [K, ...]
        self.k = k
        self.conv = conv
        self.prngs = prngs          # stacked PRNG (train-capable banks)
        self._flush_graphs: dict = {}   # (stage, literal shape) -> graph
        self._train_graphs: dict = {}   # (literal, label shape) -> graph

    def _bound(self) -> tuple:
        """The objects a graph of this bank reads: the program and PRNG
        objects and their leaves (rebinding any of them makes a graph
        anew)."""
        held = (self.progs, *self.progs.leaves())
        if self.prngs is not None:
            held += (self.prngs, *self.prngs.leaves())
        return held

    def _graph(self, graphs: dict, key, make):
        graph = graphs.get(key)
        if graph is None or not graph.holds("bank", *self._bound()):
            graph = graphs[key] = make()
            graph.mark("bank", *self._bound())
        return graph

    def _flush(self, stage: str, lits) -> tuple:
        """One flush through the bank's graph of ``stage`` at this
        literal shape: the literals copied into its static buffer, one
        replay (an eager run of the same body off the card), the answers
        returned as copies that no later flush writes.  A flush fed a
        list of per-tenant literals is JAX's ``<stage>_list``
        executable."""
        lits, shape = _batch(lits)
        if isinstance(lits, list) and not stage.endswith("_list"):
            stage += "_list"
        graph = self._graph(self._flush_graphs, (stage, shape),
                            lambda: self._flush_graph(stage, shape))
        with graph.lock:
            _load(graph.const["lits"], lits)
            graph.run()
            return tuple(graph.state[name].clone() for name in graph.state)

    def _flush_graph(self, stage: str, shape: tuple):
        eng, progs = self.engine, self.progs
        K, B = shape[:2]
        dev = eng.device
        fn = {"predict_bank_list": eng.predict_bank,
              "infer_bank": eng.infer_bank,
              "infer_bank_list": eng.infer_bank,
              "infer_conv_bank": eng.infer_conv_bank,
              "infer_conv_bank_list": eng.infer_conv_bank}[stage]
        out = ({"preds": (K, B), "votes": (K, B)}
               if stage == "predict_bank_list"
               else {"sums": (K, B, eng.H), "cl": (K, B, eng.R)})
        state = {name: torch.zeros(s, dtype=torch.int32, device=dev)
                 for name, s in out.items()}
        const = {"lits": torch.zeros(shape, dtype=torch.int32, device=dev)}

        def body(b):
            for name, t in zip(out, fn(progs, b["lits"])):
                b[name].copy_(t)

        eng.resolve_plans(B * (shape[2] if "conv" in stage else 1), K)
        return eng.step_graph(stage, body, state, const)

    def _train_graph(self, shape: tuple, label_shape: tuple):
        """The bank's train step at these shapes: its state buffers are
        the bank's own program leaves and PRNG state, the step's stats
        ``[len(STAT_KEYS), K]``; the literals and labels are static
        buffers."""
        eng, prngs = self.engine, self.prngs
        dev = eng.device
        n_r = len(prngs.leaves())
        state = {f: getattr(self.progs, f) for f in FIELDS}
        state.update({f"prng{i}": t for i, t in enumerate(prngs.leaves())})
        state["stats"] = torch.zeros((len(STAT_KEYS), self.k),
                                     dtype=torch.int32, device=dev)
        const = {"lits": torch.zeros(shape, dtype=torch.int32, device=dev),
                 "labels": torch.zeros(label_shape, dtype=torch.int32,
                                       device=dev)}

        def body(b):
            p = DTMProgram(*(b[f] for f in FIELDS))
            r = prng_like(prngs, [b[f"prng{i}"] for i in range(n_r)])
            b["stats"].copy_(store_step(
                b, *eng.train_bank(p, r, b["lits"], b["labels"])))

        eng.resolve_plans(shape[1], self.k, training=True)
        return eng.step_graph("train_bank", body, state, const)

    def infer(self, lits):
        """lits [K, B, W] ([K, B, P, W] for a conv bank), or K arrays
        without the K axis -> (sums [K, B, H], clause [K, B, R])."""
        return self._flush("infer_conv_bank" if self.conv else "infer_bank",
                           lits)

    def predict(self, lits):
        """Flat banks: (argmax preds [K, B] int32, clipped clause votes
        [K, B] int32).  A conv bank decodes on the host (use infer)."""
        if self.conv:
            raise ValueError("a conv bank decodes on the host; use infer")
        return self._flush("predict_bank_list", lits)

    def train(self, lits, labels) -> dict:
        """One stacked train step: program k takes batch k (lits
        [K, B, W] or K arrays [B, W], labels [K, B]), written in place
        into the bank's program and PRNG tensors (one replay of the
        bank's train graph on the card).  Returns the stats, [K] int32
        per key.  Flat banks only."""
        if self.conv:
            raise ValueError("conv banks are inference-only; train conv "
                             "programs through their own sessions")
        if self.prngs is None:
            raise ValueError("bank built without PRNGs; pass prngs= to "
                             "api.stack")
        labels = torch.as_tensor(labels).to(device=self.engine.device,
                                            dtype=torch.int32)
        lits, shape = _batch(lits)
        key = (shape, tuple(labels.shape))
        graph = self._graph(self._train_graphs, key,
                            lambda: self._train_graph(*key))
        with graph.lock:
            _load(graph.const["lits"], lits)
            graph.const["labels"].copy_(labels)
            graph.run()
            row = graph.state["stats"].clone()
        return {k: row[i] for i, k in enumerate(STAT_KEYS)}

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


def _batch(lits) -> tuple:
    """A bank's literals, a tensor [K, ...] or K tensors, and their
    stacked shape (a sequence becomes a list)."""
    if isinstance(lits, torch.Tensor):
        return lits, tuple(lits.shape)
    lits = list(lits)
    return lits, (len(lits), *lits[0].shape)


def _load(buf: torch.Tensor, lits) -> None:
    """Write a bank's literals into a graph's static buffer."""
    if isinstance(lits, torch.Tensor):
        buf.copy_(lits)
    else:
        torch.stack(lits, out=buf)


def stack(programs: Sequence[DTMProgram], engine: DTMEngine,
          conv: bool = False,
          prngs: Optional[Sequence[PRNG]] = None) -> ProgramBank:
    """Stack same-geometry programs (lowered on one engine with uniform
    ta_bits) into a :class:`ProgramBank` on the engine's device.
    ``conv`` makes a conv bank; ``prngs`` (one per program, one
    configuration) arm a flat bank for training."""
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
    return ProgramBank(engine, progs, k=len(programs), conv=conv,
                       prngs=stacked)


def serve(roster: Optional[dict], batch_slot: int = 32,
          device: Device = None, *, mesh=None, config=None,
          slas: Optional[dict] = None, seed: int = 0,
          durable_dir: Optional[str] = None, ckpt_keep: int = 3,
          injector=None, kernel_path: Optional[str] = None,
          skip: bool = True, ta_prng: str = "inkernel",
          autotune: str = "seed", autotune_cache=None):
    """The scheduled serving stack for a tenant roster in one call: a
    :func:`tile_for`-sized engine on ``device`` (the card unless the
    caller asks for another; no fallback), a
    :class:`repro_torch.launch.serve_tm.TMServer` (pod-sharded over the
    ``tenants`` axis of ``mesh`` when it spans more than one device; every
    rank of the mesh makes the same call) and a
    :class:`repro_torch.launch.scheduler.TMScheduler` in front of it,
    which it returns.  Call ``.start()`` for the background loop or
    drive it inline with ``.step()`` / ``.drain()``.

    ``roster`` maps tenant name -> :class:`TMSpec`; ``slas`` (optional)
    name -> :class:`repro_torch.launch.scheduler.SLAClass`; ``config`` is
    a :class:`repro_torch.launch.scheduler.SchedulerConfig`.  Tenant i
    is lowered from ``seed + i``.  With ``durable_dir``, tenants restore
    from their latest durable step, each applied training step marks
    the tenant for the background checkpoint writer, and the roster
    manifest is (re)written; ``serve(None, durable_dir=...)`` cold-starts
    the roster from the manifest.  The directory's format is the JAX
    package's, so a roster saved by either package starts in the other
    (a tenant without a checkpoint is lowered from its seed, to the JAX
    package's program).  ``injector`` (a
    :class:`repro_torch.runtime.fault.FaultInjector`) plumbs a failure
    schedule into the scheduler's loop and writer.  ``kernel_path``,
    ``skip``, ``ta_prng``, ``autotune`` and ``autotune_cache`` are the
    engine's settings (:func:`compile`)."""
    # imported here: the launch layer imports this module
    from repro_torch.launch.scheduler import SLAClass, TMScheduler
    from repro_torch.launch.serve_tm import TMServer
    from repro_torch.runtime.durable import DurableStore, restore_tenant

    store = manifest = None
    seeds: dict = {}
    if durable_dir is not None:
        store = DurableStore(durable_dir, keep=ckpt_keep)
        manifest = store.read_manifest()
    if manifest is not None:
        seeds = {n: t["seed"] for n, t in manifest["tenants"].items()}
        if roster is None:             # cold start: roster from manifest
            roster = {n: TMSpec.from_dict(t["spec"])
                      for n, t in manifest["tenants"].items()}
            batch_slot = manifest.get("batch_slot", batch_slot)
            if slas is None:
                slas = {n: SLAClass(**t["sla"])
                        for n, t in manifest["tenants"].items()
                        if t.get("sla") is not None}
    if not roster:
        raise ValueError("serve() needs at least one tenant spec (or a "
                         "durable_dir with a manifest to cold-start from)")
    slas = slas or {}
    engine = compile(tile_for(*roster.values()), device=device,
                     kernel_path=kernel_path, skip=skip, ta_prng=ta_prng,
                     autotune=autotune, autotune_cache=autotune_cache)
    server = TMServer(engine, batch_slot=batch_slot, mesh=mesh)
    sched = TMScheduler(server, config=config, durable=store,
                        injector=injector)
    for i, (name, spec) in enumerate(roster.items()):
        tseed = seeds.setdefault(name, seed + i)
        restored = (restore_tenant(store, name, engine, spec, seed=tseed)
                    if store is not None else None)
        if restored is not None:
            program, prng, steps = restored
            sched.register(name, spec, program=program, prng=prng,
                           steps=steps, seed=tseed, sla=slas.get(name))
        else:
            sched.register(name, spec, seed=tseed, sla=slas.get(name))
    if store is not None:
        store.write_manifest({
            "version": 1, "batch_slot": batch_slot,
            "tenants": {
                n: {"spec": spec.to_dict(), "seed": seeds[n],
                    "sla": (None if slas.get(n) is None
                            else dataclasses.asdict(slas[n]))}
                for n, spec in roster.items()}})
    return sched
