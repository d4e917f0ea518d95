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
# config level.  The serving slice of the port never draws from them.
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
