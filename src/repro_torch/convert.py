"""Carry programs across as plain numpy leaves.

A program's 14 leaves, in :data:`repro_torch.core.dtm.FIELDS` order, as
numpy arrays with the JAX ``DTMProgram``'s dtypes: uint8 (or int32) TA,
int32 weights and masks, bool flags, and uint32 ``p_ta`` and ``inc``.
Those two are uint32 in numpy and int32 bit patterns here.  A JAX program
crosses with ``{f: np.asarray(getattr(prog, f)) for f in FIELDS}``.
Specs cross with ``TMSpec.to_dict``/``from_dict``, whose JSON both
packages share.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.dtm import (FIELDS, U32_FIELDS, Device, DTMProgram,
                                  resolve_device)


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
