"""The lfsr PRNG cluster: the Hopper kernel and its plain version.

    for each of steps = ceil(size / n) cycles: one Galois step on every
    lane (and the master refresh when it is due); the cycle's n words go
    to out[..., c·n : (c+1)·n], cut at ``size``

:func:`lfsr_bits` launches ``csrc/lfsr.cu:lfsr_cycles`` on CUDA tensors,
once for all the cycles of a call, and runs the plain version (the loop
of :func:`repro_torch.core.prng.cluster_next`) on CPU tensors; it raises
for anything else.  It replaces the lfsr branch of
``repro/core/prng.py:PRNG.bits``, a ``lax.scan`` that XLA compiles on the
TPU.  The larger of the int64 words' bytes and one lane's serial chain of
``steps`` Galois steps bounds it (the bytes, at the main paths' draws);
the source note gives the design.  ``lfsr_bits.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# lanes, master, cycles, out, lanes_out, master_out, cycles_out; K, n,
# size, steps, taps, width, rand_bits, refresh; stream
_ARGTYPES = ([ctypes.c_void_p] * 7
             + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])

Words = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _operands(lanes: torch.Tensor, master: torch.Tensor,
              cycles: torch.Tensor, size: int) -> int:
    """Validate the state and the size; returns the lanes a program."""
    if lanes.dim() < 1 or master.shape != lanes.shape[:-1] \
            or cycles.shape != master.shape:
        raise ValueError(f"expected lanes [*lead, n], master and cycles "
                         f"[*lead], got {tuple(lanes.shape)}, "
                         f"{tuple(master.shape)}, {tuple(cycles.shape)}")
    for name, t in (("lanes", lanes), ("master", master),
                    ("cycles", cycles)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 (uint32 values), got "
                            f"{t.dtype}")
    if lanes.shape[-1] < 1 or size < 0:
        raise ValueError(f"{lanes.shape[-1]} lanes, size {size}")
    return lanes.shape[-1]


def lfsr_bits_plain(lanes: torch.Tensor, master: torch.Tensor,
                    cycles: torch.Tensor, size: int, width: int,
                    rand_bits: int, seed_refresh: bool) -> Words:
    """The plain version: ``ceil(size / n)`` calls of ``cluster_next``."""
    # imported at call time: repro_torch.core.prng imports this module
    from repro_torch.core.prng import LFSRState, cluster_next
    n = _operands(lanes, master, cycles, size)
    st = LFSRState(lanes, master, cycles)
    rows = []
    for _ in range(-(-size // n)):
        st, vals = cluster_next(st, width, seed_refresh, rand_bits)
        rows.append(vals)
    if not rows:
        return (torch.zeros((*master.shape, 0), dtype=torch.int64,
                            device=lanes.device), lanes, master, cycles)
    return torch.cat(rows, dim=-1)[..., :size], st.lanes, st.master, \
        st.cycles


def lfsr_bits(lanes: torch.Tensor, master: torch.Tensor,
              cycles: torch.Tensor, size: int, width: int, rand_bits: int,
              seed_refresh: bool) -> Words:
    """``size`` words of ``rand_bits`` bits from a ``width``-bit cluster:
    lanes int64 [*lead, n], master and cycles int64 [*lead] (uint32
    values) -> (words int64 [*lead, size], new lanes, master, cycles).
    The state given is left as it was."""
    devices = {t.device for t in (lanes, master, cycles)}
    if {d.type for d in devices} == {"cpu"}:
        return lfsr_bits_plain(lanes, master, cycles, size, width,
                               rand_bits, seed_refresh)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"no kernel for a state on {sorted(map(str, devices))}")
    from repro_torch.core.prng import _TAPS     # (see lfsr_bits_plain)
    if width not in _TAPS or not 0 < rand_bits <= 32:
        raise ValueError(f"LFSR width {width}, rand_bits {rand_bits}")
    n = _operands(lanes, master, cycles, size)
    lead = tuple(master.shape)
    k = master.numel()
    out = torch.empty((*lead, size), dtype=torch.int64, device=lanes.device)
    if size == 0:
        return out, lanes, master, cycles
    if k > 65535:
        raise ValueError(f"{k} programs exceed the grid's y limit")
    lanes, master, cycles = (t.contiguous() for t in (lanes, master, cycles))
    new = [torch.empty_like(t) for t in (lanes, master, cycles)]
    lib, fn = _build.entry("lfsr", "dtm_lfsr_bits", _ARGTYPES)
    with torch.cuda.device(lanes.device):
        stream = torch.cuda.current_stream(lanes.device).cuda_stream
        status = fn(lanes.data_ptr(), master.data_ptr(), cycles.data_ptr(),
                    out.data_ptr(), *(t.data_ptr() for t in new), k, n, size,
                    -(-size // n), _TAPS[width], width, rand_bits,
                    int(seed_refresh), stream)
    _build.check(lib, status, "dtm_lfsr_bits")
    lfsr_bits.launches += 1
    return (out, *new)


lfsr_bits.launches = 0
