"""Carry programs across as plain numpy leaves.

A program's 14 leaves, in :data:`repro_torch.core.dtm.FIELDS` order, as
numpy arrays with the JAX ``DTMProgram``'s dtypes: uint8 (or int32) TA,
int32 weights and masks, bool flags, and uint32 ``p_ta`` and ``inc``.
Those two are uint32 in numpy and int32 bit patterns here.  A JAX program
crosses with ``{f: np.asarray(getattr(prog, f)) for f in FIELDS}``.
Specs cross with ``TMSpec.to_dict``/``from_dict``, whose JSON both
packages share.

A PRNG crosses as a dict: its configuration (``backend``, ``lfsr_bits``,
``rand_bits``, ``seed_refresh``) and its uint32 state, ``state`` (the
counter) for ``counter`` and ``lanes`` [n_lanes], ``master`` and
``cycles`` for ``lfsr``; a bank's PRNG has a leading K on each.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.dtm import (FIELDS, U32_FIELDS, Device, DTMProgram,
                                  resolve_device)
from repro_torch.core.prng import PRNG, LFSRState

PRNG_CONFIG = ("backend", "lfsr_bits", "rand_bits", "seed_refresh")
LFSR_LEAVES = ("lanes", "master", "cycles")


def program_from_numpy(leaves: Mapping[str, np.ndarray],
                       device: Device = None) -> DTMProgram:
    """Numpy leaves (JAX dtypes) -> a program on ``device`` (default CUDA)."""
    missing = set(FIELDS) - set(leaves)
    if missing:
        raise KeyError(f"program leaves missing: {sorted(missing)}")
    out = {}
    for f in FIELDS:
        a = np.array(leaves[f], order="C")    # a copy; keeps 0-d leaves 0-d
        if f in U32_FIELDS:
            if a.dtype != np.uint32:
                raise TypeError(f"{f} must be uint32, got {a.dtype}")
            a = a.view(np.int32)
        out[f] = torch.from_numpy(a)
    return DTMProgram(**out).to(resolve_device(device))


def program_to_numpy(prog: DTMProgram) -> Dict[str, np.ndarray]:
    """Inverse of :func:`program_from_numpy`."""
    out = {}
    for f, t in zip(FIELDS, prog.leaves()):
        a = t.detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in U32_FIELDS else a
    return out


def prng_from_numpy(d: Mapping, device: Device = None) -> PRNG:
    """A PRNG dict (module docstring) -> a :class:`PRNG` on ``device``
    (default CUDA)."""
    dev = resolve_device(device)

    def u32(a):
        a = np.asarray(a)
        if a.dtype != np.uint32:
            raise TypeError(f"PRNG state must be uint32, got {a.dtype}")
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    cfg = [d[k] for k in PRNG_CONFIG]
    if cfg[0] == "lfsr":
        state = LFSRState(*(u32(d[k]) for k in LFSR_LEAVES))
    elif cfg[0] == "counter":
        state = u32(d["state"])
    else:
        raise NotImplementedError(f"prng backend {cfg[0]!r} is not ported")
    return PRNG(str(cfg[0]), int(cfg[1]), int(cfg[2]), bool(cfg[3]), state)


def prng_to_numpy(prng: PRNG) -> Dict:
    """Inverse of :func:`prng_from_numpy`."""
    out = {"backend": prng.backend, "lfsr_bits": prng.lfsr_bits,
           "rand_bits": prng.rand_bits, "seed_refresh": prng.seed_refresh}
    names = LFSR_LEAVES if prng.backend == "lfsr" else ("state",)
    for k, t in zip(names, prng.leaves()):
        out[k] = t.detach().cpu().numpy().astype(np.uint32)
    return out
