"""Threefry-2x32 and ``jax.random``'s key, split, bits and bernoulli, in
PyTorch: the plain versions.

Bit for bit what ``jax.random`` gives with its default configuration
(``jax_threefry_partitionable`` on, no x64), which the JAX package's
``threefry`` PRNG backend and its program draw use:

* :func:`key` is ``jax.random.PRNGKey(seed)``: ``[0, seed mod 2^32]``
  (a 32-bit seed; a larger or negative one keeps its low word).
* :func:`split` is ``jax.random.split(key)``: threefry of the key over the
  counters ``(hi, lo) = (0, 0)`` and ``(0, 1)``; the first new key is both
  outputs of the first counter, the second those of the second.
* :func:`bits` is ``jax.random.bits(key, (n,), uint32)``: threefry of the
  key over ``(hi, lo)`` = the two words of the flat index ``0 .. n-1``,
  the two outputs xor-ed.
* :func:`bernoulli_half` is ``jax.random.bernoulli(key, 0.5, shape)``:
  ``bits < 2^31`` in row-major order (the float draw ``u < 0.5`` keeps
  only the top bit).
* :func:`fold_in` is ``jax.random.fold_in(key, data)``: threefry of the
  key over the one counter ``(hi, lo) = (0, data)``, both outputs the new
  key.

uint32 arithmetic runs in int64 tensors masked to 32 bits, on any device.
A key is an int64 tensor ``[..., 2]``; leading axes are a bank of keys.
These functions are the CPU route of
:func:`repro_torch.kernels.threefry.threefry_bits` and its oracle.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .device import Device, resolve_device

M32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)`` (broadcasting int64 tensors of uint32 values).
    The rounds update two fresh tensors of the broadcast shape in place:
    one allocation a round instead of seven."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    x0 = ((x0 + ks[0]) & M32).expand(shape).contiguous()
    x1 = ((x1 + ks[1]) & M32).expand(shape).contiguous()
    hi = torch.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            # x1 = rotl(x1, r) ^ x0
            torch.bitwise_left_shift(x1, r, out=hi)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            x1.bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def key(seed: int, device: Device = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: int64 ``[2]`` on ``device`` (default
    CUDA)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=resolve_device(device))


def as_key(k, device: Device = None) -> torch.Tensor:
    """A key given as a tensor, a numpy or JAX uint32 array or a list ->
    int64 ``[..., 2]`` on ``device`` (default: a tensor's own device, else
    CUDA)."""
    if isinstance(k, torch.Tensor):
        t = k.to(torch.int64)
        if device is not None:
            t = t.to(resolve_device(device))
    else:
        a = np.asarray(k)
        if a.dtype.kind not in "iu":
            raise TypeError(f"a threefry key holds integers, got {a.dtype}")
        t = torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))
    if t.dim() < 1 or t.shape[-1] != 2:
        raise ValueError(f"a threefry key is [..., 2], got {tuple(t.shape)}")
    return t & M32


def split(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(k)`` -> the two new keys, each ``[..., 2]``."""
    k0, k1 = k[..., 0], k[..., 1]
    zero = torch.zeros_like(k0)
    a0, a1 = threefry2x32(k0, k1, zero, zero)
    b0, b1 = threefry2x32(k0, k1, zero, torch.ones_like(k0))
    return torch.stack([a0, a1], dim=-1), torch.stack([b0, b1], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for a uint32 ``data`` (an int or an
    int64 tensor broadcasting against the key's leading axes) -> the new
    key ``[..., 2]``."""
    k0, k1 = k[..., 0], k[..., 1]
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    d = d.expand_as(k0)
    a0, a1 = threefry2x32(k0, k1, torch.zeros_like(k0), d)
    return torch.stack([a0, a1], dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)``: int64 ``[..., n]``."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[..., 0, None], k[..., 1, None], idx >> 32,
                          idx & M32)
    return x0 ^ x1


def bernoulli_half(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(k, 0.5, shape)``: bool ``[..., *shape]``."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    return (bits(k, n) < (1 << 31)).reshape(*k.shape[:-1], *shape)
