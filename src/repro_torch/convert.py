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
counter) for ``counter``, ``state`` [2] (the key, the JAX PRNG's
``jax.random.PRNGKey`` array) for ``threefry``, and ``lanes``
[n_lanes], ``master`` and ``cycles`` for ``lfsr``; a bank's PRNG has a
leading K on each.

A legacy :class:`~repro_torch.core.types.TMState` crosses as ``{"ta",
"weights"}`` (``weights`` ``None`` for Vanilla), the JAX ``TMState``'s
arrays with their dtypes: ``{"ta": np.asarray(s.ta), "weights": ...}``.
A :class:`~repro_torch.core.tm_head.TMHead` crosses as its config, its
booleanizer's thresholds, that state dict and that PRNG dict.

An AdamW state (:class:`~repro_torch.optim.adam.AdamState`) crosses as an
``AdamState`` of numpy leaves over the same trees
(:mod:`repro_torch.core.tree`): a JAX state is ``jax.tree.map(np.asarray,
state)``.  bfloat16 moments cross as float32 (the same values; numpy has
no bfloat16 of its own).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dtm import (FIELDS, U32_FIELDS, Device, DTMProgram,
                                  resolve_device)
from repro_torch.core import tree as tree_lib
from repro_torch.core.booleanize import Booleanizer
from repro_torch.core.prng import PRNG, LFSRState
from repro_torch.core.tm_head import TMHead
from repro_torch.core.types import TMConfig, TMState
from repro_torch.optim.adam import _DTYPES, AdamState

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
    elif cfg[0] in ("counter", "threefry"):
        state = u32(d["state"])
        if cfg[0] == "threefry" and (state.dim() < 1 or state.shape[-1] != 2):
            raise ValueError(f"a threefry state is [..., 2], got "
                             f"{tuple(state.shape)}")
    else:
        raise ValueError(f"prng backend {cfg[0]!r} not recognised")
    return PRNG(str(cfg[0]), int(cfg[1]), int(cfg[2]), bool(cfg[3]), state)


def prng_to_numpy(prng: PRNG) -> Dict:
    """Inverse of :func:`prng_from_numpy`."""
    out = {"backend": prng.backend, "lfsr_bits": prng.lfsr_bits,
           "rand_bits": prng.rand_bits, "seed_refresh": prng.seed_refresh}
    names = LFSR_LEAVES if prng.backend == "lfsr" else ("state",)
    for k, t in zip(names, prng.leaves()):
        out[k] = t.detach().cpu().numpy().astype(np.uint32)
    return out


def state_from_numpy(leaves: Mapping[str, Optional[np.ndarray]],
                     device: Device = None) -> TMState:
    """``{"ta", "weights"}`` numpy arrays (``weights`` None or absent for
    Vanilla) -> a :class:`TMState` on ``device`` (default CUDA), dtypes
    kept."""
    dev = resolve_device(device)
    w = leaves.get("weights")
    return TMState(torch.from_numpy(np.array(leaves["ta"], order="C")).to(dev),
                   None if w is None else
                   torch.from_numpy(np.array(w, order="C")).to(dev))


def state_to_numpy(state: TMState) -> Dict[str, Optional[np.ndarray]]:
    """Inverse of :func:`state_from_numpy`."""
    return {"ta": state.ta.detach().cpu().numpy(),
            "weights": (None if state.weights is None
                        else state.weights.detach().cpu().numpy())}


def head_from_numpy(cfg: TMConfig, thresholds: np.ndarray,
                    state: Mapping[str, Optional[np.ndarray]], prng: Mapping,
                    device: Device = None) -> TMHead:
    """A :class:`TMHead` of config ``cfg`` from its booleanizer's
    thresholds [f_raw, bits], a state dict and a PRNG dict, on ``device``
    (default CUDA)."""
    return TMHead(cfg, Booleanizer(np.asarray(thresholds, np.float32)),
                  state_from_numpy(state, device), prng_from_numpy(prng,
                                                                   device))


def _leaf_to_numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def adam_state_to_numpy(state: AdamState) -> AdamState:
    """An :class:`AdamState` of tensors -> the same of numpy arrays."""
    return AdamState(*(tree_lib.map(_leaf_to_numpy, f) for f in state))


def adam_state_from_numpy(state, state_dtype: str = "float32",
                          device: Device = None) -> AdamState:
    """Inverse of :func:`adam_state_to_numpy` (or a JAX state's numpy
    leaves) on ``device`` (default CUDA): the moments in ``state_dtype``,
    the step int32, the scales float32."""
    dev = resolve_device(device)

    def leaf(dtype):
        def to(a):
            a = np.asarray(a)
            if a.dtype.kind not in "biuf" or a.dtype.name == "bfloat16":
                a = a.astype(np.float32)      # ml_dtypes' bfloat16
            return torch.from_numpy(np.array(a, order="C")).to(
                device=dev, dtype=dtype)
        return to
    moment = leaf(_DTYPES[state_dtype])
    scale = leaf(torch.float32)
    step, m, v, ms, vs = state
    return AdamState(leaf(torch.int32)(step), tree_lib.map(moment, m),
                     tree_lib.map(moment, v), tree_lib.map(scale, ms),
                     tree_lib.map(scale, vs))
