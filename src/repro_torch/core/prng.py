"""Master–slave PRNG cluster (paper §IV-C, Fig 8, Fig 15), in PyTorch.

Two of the JAX package's three backends, bit for bit:

* ``counter`` — one splitmix32 per element of ``ctr·0x9E3779B1 ^ index``;
  the counter advances by one per :meth:`PRNG.bits` call.
* ``lfsr``    — the paper's cluster: ``n_lanes`` L-bit Galois LFSR lanes
  seeded by a splitmix master, re-seeded every 2^L − 1 cycles when
  ``seed_refresh`` is set.  ``bits`` consumes whole cycles of every lane
  and drops the rest of the last one.

``threefry`` is ``jax.random`` in the reference, whose split and bits
conventions are JAX's own; it is not ported and raises
:class:`NotImplementedError` at :meth:`PRNG.create`.

uint32 arithmetic runs in int64 tensors masked to 32 bits.  The state
lives on the device of the engine that consumes it, so drawing never
moves data to the host.  A stacked form for program banks carries a
leading K axis on every state leaf, and ``bits`` then returns
``[K, *shape]``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from .device import Device, resolve_device

M32 = 0xFFFFFFFF

# Maximal-length Galois LFSR tap masks (polynomial sans x^0), by width;
# the JAX package's table.
_TAPS = {
    4: 0b1100,
    8: 0b10111000,
    12: 0b111000001000,
    16: 0b1101000000001000,
    20: 0b10010000000000000000,
    24: 0b111000010000000000000000,
    32: 0b10000000001000000000000000000110,
}


def _splitmix32(x: torch.Tensor) -> torch.Tensor:
    """Seed mixer, uint32 -> uint32 (int64 tensors holding u32 values)."""
    x = (x + 0x9E3779B9) & M32
    z = ((x ^ (x >> 16)) * 0x21F0AAAD) & M32
    z = ((z ^ (z >> 15)) * 0x735A2D97) & M32
    return z ^ (z >> 15)


def _xorshift32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & M32)


def _seed_lanes(master: torch.Tensor, n_lanes: int, lfsr_bits: int
                ) -> torch.Tensor:
    """One fresh nonzero seed per lane from the master ([...] -> [..., n])."""
    idx = torch.arange(n_lanes, dtype=torch.int64, device=master.device)
    seeds = _splitmix32(master[..., None] ^ idx) & ((1 << lfsr_bits) - 1)
    return torch.where(seeds == 0, torch.ones_like(seeds), seeds)


def lfsr_step(lanes: torch.Tensor, lfsr_bits: int) -> torch.Tensor:
    """One Galois LFSR shift on every lane."""
    shifted = lanes >> 1
    return torch.where((lanes & 1) == 1, shifted ^ _TAPS[lfsr_bits], shifted)


@dataclasses.dataclass
class LFSRState:
    """lanes int64 [..., n_lanes], master int64 [...], cycles int64 [...]:
    uint32 values (the slave registers, the master register, and the
    cycles since the last refresh)."""

    lanes: torch.Tensor
    master: torch.Tensor
    cycles: torch.Tensor


def cluster_next(state: LFSRState, lfsr_bits: int, seed_refresh: bool,
                 rand_bits: int) -> Tuple[LFSRState, torch.Tensor]:
    """Advance the cluster one cycle and emit one ``rand_bits``-wide word
    per lane (zero-extended when lfsr_bits < rand_bits, truncated when
    larger).  The refresh test runs on the device (no host read)."""
    lanes = lfsr_step(state.lanes, lfsr_bits)
    cycles = state.cycles + 1
    master = state.master
    if seed_refresh:
        do = cycles >= (1 << lfsr_bits) - 1
        master = torch.where(do, _xorshift32(master), master)
        fresh = _seed_lanes(master, lanes.shape[-1], lfsr_bits)
        lanes = torch.where(do[..., None], fresh, lanes)
        cycles = torch.where(do, torch.zeros_like(cycles), cycles)
    out = lanes
    if lfsr_bits < rand_bits:
        out = (out << (rand_bits - lfsr_bits)) & M32
    elif lfsr_bits > rand_bits:
        out = out >> (lfsr_bits - rand_bits)
    return LFSRState(lanes, master, cycles), out & ((1 << rand_bits) - 1)


def make_cluster(master_seed: int, n_lanes: int, lfsr_bits: int,
                 device: Device = None) -> LFSRState:
    """A seeded cluster on ``device`` (default CUDA)."""
    if lfsr_bits not in _TAPS:
        raise ValueError(f"no tap table for LFSR width {lfsr_bits}")
    device = resolve_device(device)
    seed = master_seed & M32
    master = torch.tensor(seed if seed != 0 else 0xDEADBEEF,
                          dtype=torch.int64, device=device)
    return LFSRState(_seed_lanes(master, n_lanes, lfsr_bits), master,
                     torch.zeros((), dtype=torch.int64, device=device))


State = Union[torch.Tensor, LFSRState]


@dataclasses.dataclass
class PRNG:
    """Backend-dispatching random stream (the JAX ``PRNG``'s fields).

    ``state`` is the counter (int64 [...] holding a uint32) for
    ``counter`` and an :class:`LFSRState` for ``lfsr``; a bank's PRNG has
    a leading K axis on every state leaf (:meth:`stack`)."""

    backend: str
    lfsr_bits: int
    rand_bits: int
    seed_refresh: bool
    state: State

    @staticmethod
    def create(cfg, seed: int, n_lanes: int = 8192,
               device: Device = None) -> "PRNG":
        """The stream of a model config (``prng_backend``, ``lfsr_bits``,
        ``rand_bits``, ``seed_refresh``) from ``seed``, on ``device``
        (default CUDA)."""
        backend = cfg.prng_backend
        if backend not in ("lfsr", "counter"):
            raise NotImplementedError(
                f"prng_backend={backend!r} is not ported: threefry is "
                "jax.random, whose key-split and bits conventions are "
                "JAX's own; use 'lfsr' or 'counter'")
        device = resolve_device(device)
        if backend == "lfsr":
            st = make_cluster(seed, n_lanes, cfg.lfsr_bits, device)
        else:
            st = torch.tensor((seed & M32) or 0xC0FFEE, dtype=torch.int64,
                              device=device)
        return PRNG(backend, cfg.lfsr_bits, cfg.rand_bits, cfg.seed_refresh,
                    st)

    @property
    def lead(self) -> Tuple[int, ...]:
        """The leading (bank) axes of the state: () or (K,)."""
        st = self.state
        return tuple((st.master if isinstance(st, LFSRState) else st).shape)

    def _replace(self, state: State) -> "PRNG":
        return dataclasses.replace(self, state=state)

    def bits(self, shape: Sequence[int]) -> Tuple["PRNG", torch.Tensor]:
        """int64 numbers in [0, 2^rand_bits) of ``[*lead, *shape]``."""
        shape = tuple(int(d) for d in shape)
        size = 1
        for d in shape:
            size *= d
        lead = self.lead
        if self.backend == "counter":
            ctr = self.state
            idx = torch.arange(size, dtype=torch.int64, device=ctr.device)
            out = _splitmix32(((ctr * 0x9E3779B1) & M32)[..., None] ^ idx)
            out = out >> (32 - self.rand_bits)
            return (self._replace((ctr + 1) & M32),
                    out.reshape(*lead, *shape))
        if self.backend != "lfsr":
            raise NotImplementedError(f"prng_backend={self.backend!r}")
        st: LFSRState = self.state
        steps = -(-size // st.lanes.shape[-1])
        rows = []
        for _ in range(steps):
            st, vals = cluster_next(st, self.lfsr_bits, self.seed_refresh,
                                    self.rand_bits)
            rows.append(vals)
        out = torch.cat(rows, dim=-1)[..., :size]
        return self._replace(st), out.reshape(*lead, *shape)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        st = self.state
        if isinstance(st, LFSRState):
            return (st.lanes, st.master, st.cycles)
        return (st,)

    def map(self, fn) -> "PRNG":
        """A new PRNG with ``fn`` applied to every state leaf."""
        st = self.state
        if isinstance(st, LFSRState):
            return self._replace(LFSRState(*(fn(t) for t in self.leaves())))
        return self._replace(fn(st))

    def to(self, device) -> "PRNG":
        return self.map(lambda t: t.to(device))

    @staticmethod
    def stack(prngs: Sequence["PRNG"]) -> "PRNG":
        """K same-config PRNGs -> one bank PRNG with a leading K axis."""
        prngs = list(prngs)
        first = prngs[0]
        cfg = (first.backend, first.lfsr_bits, first.rand_bits,
               first.seed_refresh)
        for p in prngs[1:]:
            if (p.backend, p.lfsr_bits, p.rand_bits, p.seed_refresh) != cfg:
                raise ValueError("bank PRNGs must share backend, lfsr_bits, "
                                 "rand_bits and seed_refresh")
        leaves = [torch.stack(ls) for ls in zip(*(p.leaves() for p in prngs))]
        st = LFSRState(*leaves) if first.backend == "lfsr" else leaves[0]
        return first._replace(st)

    def __getitem__(self, k: int) -> "PRNG":
        """Program ``k`` of a bank PRNG (a view)."""
        return self.map(lambda t: t[k])
