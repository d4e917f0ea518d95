"""Synthetic Boolean classification sets with the paper's geometry.

MNIST-like (784 Boolean features, 10 classes) and KWS6-like (1600
features, 6 classes).  Each class is a union of sparse bit motifs; a
datapoint activates a random subset of its class's motifs plus background
noise and bit flips.  Pure numpy, the same generator as the JAX package's
so both packages see identical data from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoolTaskSpec:
    name: str
    features: int
    classes: int
    motifs_per_class: int = 6
    motif_bits: int = 10
    active_motifs: int = 3
    background_p: float = 0.04
    flip_p: float = 0.02
    seed: int = 1234


MNIST_LIKE = BoolTaskSpec("mnist-like", 784, 10)
KWS6_LIKE = BoolTaskSpec("kws6-like", 1600, 6, motifs_per_class=10,
                         motif_bits=14, active_motifs=4, background_p=0.05,
                         flip_p=0.03, seed=4567)


def motifs(spec: BoolTaskSpec) -> np.ndarray:
    """The class motifs, int8 [classes, motifs_per_class, features] {0,1}."""
    rng = np.random.default_rng(spec.seed)
    m = np.zeros((spec.classes, spec.motifs_per_class, spec.features),
                 np.int8)
    for c in range(spec.classes):
        for k in range(spec.motifs_per_class):
            idx = rng.choice(spec.features, spec.motif_bits, replace=False)
            m[c, k, idx] = 1
    return m


def make_bool_dataset(spec: BoolTaskSpec, n: int, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n, features] int8 {0,1}, y [n] int32)."""
    mot = motifs(spec)
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, seed]))
    y = rng.integers(0, spec.classes, n).astype(np.int32)
    x = (rng.random((n, spec.features)) < spec.background_p).astype(np.int8)
    for i in range(n):
        ks = rng.choice(spec.motifs_per_class, spec.active_motifs,
                        replace=False)
        x[i] |= mot[y[i], ks].max(axis=0)
    flip = rng.random((n, spec.features)) < spec.flip_p
    x = np.where(flip, 1 - x, x).astype(np.int8)
    return x, y
