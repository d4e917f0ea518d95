"""Seeded inputs of the benchmark: data sets, request pools and programs.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* :func:`motifs` and :func:`make_bool_dataset` are
  ``src/repro_torch/data/datasets.py`` of commit 14675cf (the synthetic
  MNIST- and KWS-6-shaped sets), with the per-row loop cut down to the
  one call per row that consumes the generator (``Generator.choice``,
  which draws a data-dependent number of words, so it cannot be batched
  without changing the stream).  The motif union and everything else is
  vectorised.  The output equals the original's for every seed
  (``portbench/tests/test_portbench_harness.py``).
* :func:`firing_program` is ``chip_smoke.py`` ``motif_program`` of the same
  commit, vectorised: each clause row includes ``n_inc`` x-literals of one
  motif of its class, so clauses fire on the class's data.  Its weights
  span the configuration's whole weight range, so a lower weight
  precision changes the answers.

A task (the ``data`` entries of a configuration file) is a dict with the
fields of the original ``BoolTaskSpec`` and, optionally, ``shape``
([h, w]: the rows are images, :func:`shaped`).  Everything here is numpy
on the host; the sets are uploaded by the program's own encoders.  The
programs are laid out by the reference module that judges them
(``ref``): its ``rows_of`` and ``bool_features`` size them, its
``has_weights`` says whether they carry class weights, and its
``motif_literals`` puts a motif's features on the clause literals of its
kind.
"""
from __future__ import annotations

import numpy as np

CHUNK = 8192      # rows a step of the vectorised motif union


def motifs(task: dict) -> np.ndarray:
    """The class motifs, int8 [classes, motifs_per_class, features] {0,1}."""
    rng = np.random.default_rng(task["seed"])
    m = np.zeros((task["classes"], task["motifs_per_class"],
                  task["features"]), np.int8)
    for c in range(task["classes"]):
        for k in range(task["motifs_per_class"]):
            idx = rng.choice(task["features"], task["motif_bits"],
                             replace=False)
            m[c, k, idx] = 1
    return m


def make_bool_dataset(task: dict, n: int, seed: int = 0):
    """Returns (x [n, features] int8 {0,1}, y [n] int32), the rows the
    original generator gives for ``(task, n, seed)``."""
    mot = motifs(task)
    rng = np.random.default_rng(np.random.SeedSequence([task["seed"], seed]))
    y = rng.integers(0, task["classes"], n).astype(np.int32)
    x = (rng.random((n, task["features"])) < task["background_p"]).astype(
        np.int8)
    choice, k_all, k = rng.choice, task["motifs_per_class"], \
        task["active_motifs"]
    ks = np.empty((n, k), np.intp)
    for i in range(n):
        ks[i] = choice(k_all, k, replace=False)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        x[a:b] |= mot[y[a:b, None], ks[a:b]].max(axis=1)
    flip = rng.random((n, task["features"])) < task["flip_p"]
    return np.where(flip, 1 - x, x).astype(np.int8), y


def shaped(task: dict, x: np.ndarray) -> np.ndarray:
    """Rows [n, features] as the program takes them: images [n, h, w]
    where the task states ``shape``, else as they are."""
    if "shape" not in task:
        return x
    h, w = task["shape"]
    if h * w != task["features"]:
        raise ValueError(f"task {task['name']!r}: shape {[h, w]} holds "
                         f"{h * w} features, the task states "
                         f"{task['features']}")
    return x.reshape(len(x), h, w)


def initial_program(model: dict, rng: np.random.Generator, ref):
    """A program to train from, drawn as the paper's initial state: TA
    states J-1 or J with probability 1/2 each, CoTM weights ±1.
    Returns (ta int32 [rows, 2f], weights int32 [classes, clauses] or
    None); f is the reference's ``bool_features``."""
    j = 1 << (model["ta_bits"] - 1)
    rows, lits = ref.rows_of(model), 2 * ref.bool_features(model)
    ta = (j - 1 + rng.integers(0, 2, (rows, lits))).astype(np.int32)
    weights = None
    if ref.has_weights(model):
        weights = (1 - 2 * rng.integers(0, 2, (model["classes"],
                                               model["clauses"]))
                   ).astype(np.int32)
    return ta, weights


def firing_program(model: dict, task: dict, rng: np.random.Generator, ref,
                   n_inc: int = 3):
    """A served program: every clause row includes the x-literals of
    ``n_inc`` features of one motif of its class (Vanilla rows of negative
    polarity: of the next class), placed by ``ref.motif_literals``, its
    other TA states below J; class weights of magnitude
    1..clip, positive for the row's class and negative for the others.
    Returns (ta int32 [rows, 2f], weights int32 [classes, clauses] or
    None)."""
    j = 1 << (model["ta_bits"] - 1)
    rows, lits = ref.rows_of(model), 2 * ref.bool_features(model)
    h, c = model["classes"], model["clauses"]
    mot = motifs(task)
    bits = np.argsort(-mot, axis=-1, kind="stable")[..., :task["motif_bits"]]
    ta = rng.integers(0, j, (rows, lits)).astype(np.int32)
    r = np.arange(rows)
    if model["kind"] == "vanilla":
        cls = (r // c + (r % c) % 2) % h
    else:
        cls = r % h
    picks = rng.integers(0, task["motifs_per_class"], rows)
    order = np.argsort(rng.random((rows, task["motif_bits"])), axis=1)
    on = ref.motif_literals(model, task,
                            bits[cls, picks][r[:, None], order[:, :n_inc]])
    ta[r[:, None], on] = rng.integers(j, 2 * j, (rows, n_inc))
    weights = None
    if ref.has_weights(model):
        clip = (1 << (model["weight_bits"] - 1)) - 1
        weights = -rng.integers(1, clip + 1, (h, c))
        weights[cls, r] = rng.integers(1, clip + 1, rows)
        weights = weights.astype(np.int32)
    return ta, weights
