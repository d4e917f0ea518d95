"""Model and engine configuration for the Tsetlin Machine family.

Same split as the JAX package: :class:`TMConfig` is the *model* (what the
accelerator is programmed with at run time) and :class:`TileConfig` is the
*engine* geometry (what is built once).  Plain frozen dataclasses with no
framework dependency, field for field the JAX package's.
"""
from __future__ import annotations

import dataclasses

VANILLA = "vanilla"
COALESCED = "coalesced"

# Recognised PRNG stream constructions; validated here so a typo fails at
# config level.
PRNG_BACKENDS = ("lfsr", "counter", "threefry")


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Run-time model configuration (the paper's "programming" data)."""

    tm_type: str = COALESCED          # VANILLA | COALESCED
    features: int = 784               # Boolean features f  (literals = 2f)
    clauses: int = 256                # CoTM: shared-pool size; Vanilla: clauses/class
    classes: int = 10                 # h
    T: int = 500                      # clause-update threshold
    s: float = 10.0                   # sensitivity
    ta_bits: int = 8                  # TA state register width
    weight_bits: int = 12             # CoTM weight precision
    boost_true_positive: bool = True
    lfsr_bits: int = 24
    seed_refresh: bool = True
    prng_backend: str = "lfsr"
    rand_bits: int = 16
    compute_backend: str = "jnp"      # kept for field parity with the JAX config

    def __post_init__(self):
        if self.tm_type not in (VANILLA, COALESCED):
            raise ValueError(f"tm_type={self.tm_type!r}")
        if not 2 <= self.ta_bits <= 16:
            raise ValueError(f"ta_bits={self.ta_bits} outside [2, 16]")
        if not 2 <= self.weight_bits <= 31:
            raise ValueError(f"weight_bits={self.weight_bits} outside [2, 31]")
        if self.classes < 2:
            raise ValueError(f"classes={self.classes} < 2")
        if self.prng_backend not in PRNG_BACKENDS:
            raise ValueError(
                f"prng_backend={self.prng_backend!r} not recognised; "
                f"use one of {PRNG_BACKENDS}")

    @property
    def literals(self) -> int:
        return 2 * self.features

    @property
    def n_states(self) -> int:
        """2J — total TA states."""
        return 1 << self.ta_bits

    @property
    def include_threshold(self) -> int:
        """J — action is Include iff state >= J (0-indexed states)."""
        return 1 << (self.ta_bits - 1)

    @property
    def weight_clip(self) -> int:
        return (1 << (self.weight_bits - 1)) - 1

    @property
    def total_clauses(self) -> int:
        """Clause rows held in TA memory (Vanilla: clauses per class × classes)."""
        if self.tm_type == VANILLA:
            return self.clauses * self.classes
        return self.clauses

    def ops_per_inference(self) -> dict:
        """Analytical op counts of one inference (paper Fig 3): logic
        ops of the clause chain, integer ops of the class sums."""
        lits = self.literals
        if self.tm_type == COALESCED:
            logic = self.clauses * lits * 2            # (L or not TA), and
            integer = self.classes * self.clauses * 2  # weight multiply-add
        else:
            logic = self.classes * self.clauses * lits * 2
            integer = self.classes * self.clauses      # +-1 accumulate
        return {"logic_ops": logic, "integer_ops": integer}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static engine geometry: tile sizes and buffer capacities.

    Any :class:`TMConfig` with dims <= ``max_*`` runs on the same engine
    through masks.  The CUDA kernels handle ragged shapes themselves; the
    tiles only fix the padded program geometry, which must match the JAX
    engine's so programs carry across unchanged.
    """

    x: int = 128                      # literal tile
    y: int = 128                      # clause tile
    m: int = 128                      # clause tile for the class-sum stage
    n: int = 8                        # class tile
    max_features: int = 1024
    max_clauses: int = 2048
    max_classes: int = 16
    batch_tile: int = 8
    max_patches: int = 1

    @property
    def max_literals(self) -> int:
        return 2 * self.max_features

    def packed_words(self) -> int:
        """32-bit words per packed row on the padded literal grid."""
        return (self.padded_dims()[0] + 31) // 32

    def padded_dims(self) -> tuple[int, int, int]:
        """(literals, clauses, classes) rounded up to whole tiles."""
        def rup(v, t):
            return ((v + t - 1) // t) * t
        return (rup(self.max_literals, self.x),
                rup(self.max_clauses, self.y),
                rup(self.max_classes, self.n))


class TMState:
    """Learnable state of a TM in the legacy training core
    (:mod:`repro_torch.core.feedback`, :mod:`repro_torch.core.distributed`).

    ``ta``     : TA states, Vanilla [classes*clauses, 2f], CoTM
                 [clauses, 2f]; values in [0, 2^ta_bits - 1], the action
                 Include iff state >= 2^(ta_bits-1).
    ``weights``: CoTM [classes, clauses] int32 (Vanilla: ``None``; its ±1
                 polarity follows from the clause parity).
    """

    def __init__(self, ta, weights):
        self.ta = ta
        self.weights = weights

    def __repr__(self):
        w = None if self.weights is None else tuple(self.weights.shape)
        return f"TMState(ta={tuple(self.ta.shape)}:{self.ta.dtype}, weights={w})"


def init_state(cfg: TMConfig, key, dtype=None, device=None) -> TMState:
    """TA states at the include boundary (J-1 or J) and CoTM weights ±1,
    drawn as the JAX ``init_state`` draws them: the threefry ``key``
    (:func:`repro_torch.core.threefry.key`, or a JAX ``PRNGKey`` array)
    split into ``kt, kw``, the TA states J-1 + bernoulli(kt, 0.5) and the
    weights ±1 by bernoulli(kw, 0.5).  ``dtype`` defaults to int32; the
    state lands on ``device`` (default CUDA), where each draw is one
    ``threefry_bits`` launch."""
    import torch
    # imported here: the kernels package imports this module
    from repro_torch.kernels.threefry import threefry_bits
    from . import threefry
    from .device import resolve_device

    dev = resolve_device(device)
    k = threefry.as_key(key, dev)
    rows, lits = cfg.total_clauses, cfg.literals
    n_w = cfg.classes * cfg.clauses if cfg.tm_type == COALESCED else 0
    # the split with kw's words, then kt's words (rand_bits=1: the top bit,
    # which is bernoulli(·, 0.5)'s complement)
    kt, w_bits = threefry_bits(k[None], n_w, rand_bits=1)
    _, t_bits = threefry_bits(kt, rows * lits, rand_bits=1, split=False)
    j = cfg.include_threshold
    ta = (j - t_bits[0].reshape(rows, lits).to(torch.int32)).to(
        dtype or torch.int32)
    weights = None
    if cfg.tm_type == COALESCED:
        weights = 1 - 2 * w_bits[0].reshape(cfg.classes, cfg.clauses).to(
            torch.int32)
    return TMState(ta, weights)


def ta_actions(cfg: TMConfig, ta):
    """Include/Exclude decision per TA (bool [rows, 2f])."""
    return ta >= cfg.include_threshold
