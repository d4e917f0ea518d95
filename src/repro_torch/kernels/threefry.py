"""The threefry PRNG: the Hopper kernel and its plain version.

    split:  (new_keys, sub) = jax.random.split(keys)
    words:  out[k] = jax.random.bits(sub[k], (size,)) >> (32 - rand_bits)

:func:`threefry_bits` launches ``csrc/threefry.cu:threefry_words`` on
CUDA tensors, once for the split and every word of K keys, and runs the
plain version (:mod:`repro_torch.core.threefry`) on CPU tensors; it
raises for anything else.  It replaces the threefry branch of
``repro/core/prng.py:PRNG.bits`` (``jax.random`` split and bits, which
XLA compiles on the TPU) and, with ``split=False``, the
``jax.random.bernoulli`` draws of ``repro/core/dtm.py:DTMEngine.program``.
Its int64 words' bytes bound it (8 a word, against 74 integer
instructions at the SM's issue rate); the source note gives the design.
``threefry_bits.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# keys, new_keys, out; K, size, shift, split; stream
_ARGTYPES = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


def _operands(keys: torch.Tensor, size: int, rand_bits: int) -> None:
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"expected keys [*lead, 2], got {tuple(keys.shape)}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64 (uint32 values), got "
                        f"{keys.dtype}")
    if size < 0 or not 0 < rand_bits <= 32:
        raise ValueError(f"size {size}, rand_bits {rand_bits}")


def threefry_bits_plain(keys: torch.Tensor, size: int, rand_bits: int,
                        split: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``threefry.split`` and ``threefry.bits``."""
    # imported at call time: repro_torch.core.prng imports this module
    from repro_torch.core import threefry
    _operands(keys, size, rand_bits)
    new, sub = threefry.split(keys) if split else (keys.clone(), keys)
    return new, threefry.bits(sub, size) >> (32 - rand_bits)


def threefry_bits(keys: torch.Tensor, size: int, rand_bits: int,
                  split: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``size`` words of ``rand_bits`` bits from each of the keys int64
    [*lead, 2] (uint32 values) -> (new keys [*lead, 2], words int64
    [*lead, size]).  ``split``: the words come from the second key of
    ``jax.random.split(key)`` and the first is the new key (a threefry
    ``PRNG.bits`` call); otherwise from the key itself, which is also the
    new key.  The keys given are left as they were."""
    if keys.device.type == "cpu":
        return threefry_bits_plain(keys, size, rand_bits, split)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for keys on {keys.device}")
    _operands(keys, size, rand_bits)
    lead = tuple(keys.shape[:-1])
    k = keys.numel() // 2
    if k > 65535:
        raise ValueError(f"{k} keys exceed the grid's y limit")
    keys = keys.contiguous()
    new = torch.empty_like(keys)
    out = torch.empty((*lead, size), dtype=torch.int64, device=keys.device)
    if k == 0:
        return new, out
    lib, fn = _build.entry("threefry", "dtm_threefry_bits", _ARGTYPES)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        status = fn(keys.data_ptr(), new.data_ptr(), out.data_ptr(), k, size,
                    32 - rand_bits, int(split), stream)
    _build.check(lib, status, "dtm_threefry_bits")
    threefry_bits.launches += 1
    return new, out


threefry_bits.launches = 0
