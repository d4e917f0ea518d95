"""Batched TA update (Alg 5): the Hopper kernel and its plain versions.

The entry points update a bank of K programs' TA states with their
random streams and emit the packed include bitplane of the updated states
in the same launch:

    ta      [K, C, L]   uint8 (int32 when ta_bits > 8)
    lits    [K, 2B, W]  packed literal words (int32 bits; W = ceil(L/32)),
                        the target round's B rows, then the negated round's
    cl, t1, t2 [K, 2B, C]  clause outputs and Type I / Type II feedback
    l_mask  [K, L]      1 = real literal column
    seed, p_ta [K]      uint32 values (int64, or their int32 bits)
    boost, n_states [K] per-program flags and TA state counts
    row0                global row offset of row 0 (int or [K])

-> ``(new_ta [K, C, L]`` in ``ta``'s dtype, ``new_inc [K, C, W]`` int32).

All three launch one kernel body (``csrc/ta_update.cu``), templated on
where a TA's random words come from:

* :func:`ta_update` — ``dtm_ta_update``, every 128-row clause group, into
  new tensors, the words made in the kernel.  It replaces
  ``repro/kernels/ta_update.py:ta_update``.
* :func:`ta_update_streamed` — ``dtm_ta_update_streamed``, every group,
  into new tensors, each TA's random words read from a pre-made
  ``rands [K, 2B, C, L]`` (int32 bit patterns, :func:`stream_rands`)
  instead: the streamed baseline.  It replaces
  ``repro/kernels/ta_update.py:ta_update_streamed``.
* :func:`ta_update_sparse` — ``dtm_ta_update_sparse``, only the groups
  ``tile_idx[k, :count[k]]`` (the others keep ``ta`` and ``inc``);
  duplicates are harmless.  It replaces
  ``repro/kernels/ta_update.py:ta_update_sparse``.  ``count`` stays on
  the device: the kernel reads it and walks only the listed slots.  The
  kernel updates its state buffers in place: with ``inplace=True`` those
  are ``ta`` and ``inc`` themselves, so the groups left alone cost
  nothing; otherwise they are copies and the inputs stay as they were.

The kernel reads the engine's int32 ``cl``/``t1``/``t2`` and per-program
scalars as they come (int64, int32 or bool tensors, or ints:
:func:`scalar_spec`), so with the engine's operands each wrapper
allocates its outputs (the dense and streamed ones) and launches the
kernel, and nothing else.

The stream family is ``prng`` (``counter`` or ``lfsr`` with
``lfsr_bits``/``seed_refresh``); the keys are the JAX package's, so the
states equal its ``ta_update_ref`` bit for bit.  CPU tensors run the
plain versions, CUDA tensors launch the kernels, anything else raises.
``<wrapper>.launches`` counts kernel launches.  ``prepare_<wrapper>``
checks and prepares the operands and returns ``(launch, outputs)``:
``launch()`` is the bare kernel launch (it counts), so a caller can time
the kernel apart from its wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.booleanize import unpack_literals, words_from_u32
from . import _build, ref

GROUP = 128                 # rows per compaction group (csrc kGroup)
_SMEM_LIMIT = 48 * 1024
SPARSE_WARPS = 4            # warps per block (csrc kWarps)
SPARSE_ROWS = 4             # clause rows per warp item (csrc kRows)
SPARSE_WORDS = 2            # literal words per warp item (csrc kWordsPerItem)
SPARSE_CHUNK = 64           # batch rows per feedback mask (csrc kChunkB)
SPARSE_BLOCKS_PER_SM = 8     # all resident (csrc kBlocksPerSm)
# ta, lit, cl, t1, t2, l_mask, scalars, out, inc_out; K, C, L, W, B2,
# ta_bytes, lfsr, lfsr_bits, refresh, rand_bits; taps; blocks; stream
_DENSE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
# ta, lit, cl, t1, t2, l_mask, scalars, tile_idx, count, inc; K, C, L, W,
# B2, S, ta_bytes, lfsr, lfsr_bits, refresh, rand_bits; taps; blocks; stream
_SPARSE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                    + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
# ta, lit, cl, t1, t2, l_mask, scalars, rands, out, inc_out; K, C, L, W,
# B2, ta_bytes, blocks; stream
_STREAMED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
# scalar dtypes the kernel reads as they are (csrc read_u32)
_SCALAR_DTYPES = (torch.int64, torch.int32, torch.bool)


class _Scalar(ctypes.Structure):
    """csrc/ta_update.cu Scalar: a tensor element or a value."""
    _fields_ = [("ptr", ctypes.c_void_p), ("value", ctypes.c_longlong),
                ("bytes", ctypes.c_int), ("stride", ctypes.c_int)]


def scalar_spec(v, K: int, device):
    """One per-program scalar as the kernel takes it: ``(tensor, element
    bytes, stride, value)``.  An int64, int32 or bool tensor (0-d, [1] or
    [K]; the engine's) is passed as it is, read in the kernel and
    truncated to 32 bits; any other tensor becomes int64 first; a Python
    int goes as ``value``."""
    if not isinstance(v, torch.Tensor):
        return None, 0, 0, int(v) & ref.M32
    if v.dim() > 1 or (v.dim() == 1 and v.shape[0] not in (1, K)):
        raise ValueError(f"a per-program scalar must be 0-d, [1] or [{K}], "
                         f"got {tuple(v.shape)}")
    if v.dtype not in _SCALAR_DTYPES or v.device != torch.device(device):
        v = v.to(device, v.dtype if v.dtype in _SCALAR_DTYPES
                 else torch.int64)
    stride = 0 if v.numel() == 1 else v.stride(0)
    return v, v.element_size(), stride, 0


def _scalars(K: int, device, seed, p_ta, boost, n_states, row0):
    """(the kernel's five Scalar records, the tensors they point into)."""
    specs = [scalar_spec(v, K, device)
             for v in (seed, p_ta, boost, n_states, row0)]
    recs = (_Scalar * 5)(*[
        _Scalar(None if t is None else t.data_ptr(), value, nbytes, stride)
        for t, nbytes, stride, value in specs])
    return recs, [t for t, *_ in specs if t is not None]


def lfsr_refresh(prng: str, lfsr_bits: int, seed_refresh: bool,
                 B2: int) -> bool:
    """Whether an LFSR refresh can fire within one call: a period of
    2^lfsr_bits − 1 rows fits in the 2B batch rows."""
    return (prng == "lfsr" and bool(seed_refresh)
            and B2 >= (1 << lfsr_bits) - 1)


def sparse_blocks(S: int, C: int, W: int, sms: int) -> int:
    """The kernel's grid (per program): a block per item of the groups it
    may be given (min(S, groups) groups × 32 row quads × word chunks taken
    ``SPARSE_WARPS`` at a time), at most ``SPARSE_BLOCKS_PER_SM`` per SM.
    The dense updates pass S = the group count: every group."""
    groups = min(S, -(-C // GROUP))
    chunks = -(-W // SPARSE_WORDS)
    items = groups * (GROUP // SPARSE_ROWS) * -(-chunks // SPARSE_WARPS)
    return max(1, min(items, SPARSE_BLOCKS_PER_SM * sms))


def sparse_smem(C: int, B2: int, streamed: bool = False) -> int:
    """Shared memory of a launch (csrc smem_bytes): the feedback masks,
    the group lists and, for the streamed words, each row's Type I rows."""
    nch = -(-B2 // SPARSE_CHUNK)
    lists = (4 + SPARSE_CHUNK) * nch * SPARSE_ROWS if streamed else 0
    return 8 * nch * SPARSE_ROWS * 3 + 8 * -(-C // GROUP) + lists


def _params(K: int, seed, p_ta, boost, n_states, row0, device
            ) -> torch.Tensor:
    """Per-program scalars of the plain versions: int32 [K, 5] =
    (seed, p_ta, boost, n_states, row0), uint32 values as int32 bits."""
    def col(v):
        if isinstance(v, torch.Tensor):
            t = v.to(device)
            t = t.expand(K) if t.numel() == 1 else t
        else:   # filled on the device: no host-to-device copy
            t = torch.full((K,), int(v), dtype=torch.int64, device=device)
        return words_from_u32(t.to(torch.int64) & ref.M32)
    return torch.stack([col(seed), col(p_ta), col(boost), col(n_states),
                        col(row0)], dim=-1)


def _check(ta, lits, cl, t1, t2, l_mask):
    """Validate the operands; returns (K, C, L, W, B2)."""
    if ta.dim() != 3 or lits.dim() != 3:
        raise ValueError(f"expected ta [K, C, L] and lits [K, 2B, W], got "
                         f"{tuple(ta.shape)} and {tuple(lits.shape)}")
    K, C, L = ta.shape
    B2, W = lits.shape[1], lits.shape[2]
    if lits.shape[0] != K or W != (L + 31) // 32:
        raise ValueError(f"lits {tuple(lits.shape)} do not fit ta "
                         f"{tuple(ta.shape)} (W must be ceil(L/32))")
    for name, t in (("cl", cl), ("t1", t1), ("t2", t2)):
        if tuple(t.shape) != (K, B2, C):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(K, B2, C)}")
    if tuple(l_mask.shape) != (K, L):
        raise ValueError(f"l_mask has shape {tuple(l_mask.shape)}, expected "
                         f"{(K, L)}")
    if ta.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"TA states must be uint8 or int32, got {ta.dtype}")
    return K, C, L, W, B2


def _check_stream(prng: str, lfsr_bits: int, rand_bits: int) -> None:
    if prng not in ("counter", "lfsr"):
        raise ValueError(f"unknown TA prng mode {prng!r}")
    if prng == "lfsr" and lfsr_bits not in ref.LFSR_TAPS:
        raise ValueError(f"no tap table for LFSR width {lfsr_bits}")
    if not 0 < rand_bits <= 32:
        raise ValueError(f"rand_bits={rand_bits} outside [1, 32]")


def _check_rands(rands, K, B2, C, L) -> None:
    if tuple(rands.shape) != (K, B2, C, L) or rands.dtype != torch.int32:
        raise ValueError(f"rands must be int32 {(K, B2, C, L)}, got "
                         f"{rands.dtype} {tuple(rands.shape)}")


def _plain_rows(ta, lits, cl, t1, t2, l_mask, params, rows, rand_bits, prng,
                lfsr_bits, seed_refresh):
    """The reference update of clause rows ``rows`` of program k, for each
    k: ((new ta rows int32, their include words), ...)."""
    out = []
    L = ta.shape[-1]
    for k in range(ta.shape[0]):
        r = rows[k]
        p = params[k].to(torch.int64) & ref.M32
        new = ref.ta_update_ref(
            ta[k, r], unpack_literals(lits[k], L), cl[k][:, r], t1[k][:, r],
            t2[k][:, r], l_mask[k], p[0], p[1], rand_bits, p[2] != 0,
            p[3], row_idx=r + p[4], prng=prng, lfsr_bits=lfsr_bits,
            seed_refresh=seed_refresh)
        out.append((new, ref.pack_include(new, p[3])))
    return out


def ta_update_plain(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost,
                    n_states, row0=0, rand_bits: int = 16,
                    prng: str = "counter", lfsr_bits: int = 24,
                    seed_refresh: bool = True):
    """Plain version of :func:`ta_update` (``ref.ta_update_ref``)."""
    K, C = ta.shape[:2]
    params = _params(K, seed, p_ta, boost, n_states, row0, ta.device)
    rows = [torch.arange(C, device=ta.device)] * K
    done = _plain_rows(ta, lits, cl, t1, t2, l_mask, params, rows, rand_bits,
                       prng, lfsr_bits, seed_refresh)
    return (torch.stack([d[0] for d in done]).to(ta.dtype),
            torch.stack([d[1] for d in done]))


def stream_rands(K: int, B2: int, C: int, L: int, seed, device, row0=0,
                 rand_bits: int = 16, prng: str = "counter",
                 lfsr_bits: int = 24, seed_refresh: bool = True
                 ) -> torch.Tensor:
    """The numbers the in-kernel streams of :func:`ta_update` consume, as
    ``rands`` int32 [K, B2, C, L] (``ref.ta_rand_stream`` keyed on the
    kernel's padded stride and the rows ``row0 + r``), made on ``device``
    without a host read."""
    _check_stream(prng, lfsr_bits, rand_bits)
    p = _params(K, seed, 0, 0, 0, row0, device).to(torch.int64) & ref.M32
    rows = p[:, 4:5] + torch.arange(C, dtype=torch.int64, device=device)
    return ref.ta_rand_stream(p[:, 0], B2, C, L, rand_bits, prng, lfsr_bits,
                              seed_refresh, row_idx=rows, device=device)


def ta_update_streamed_plain(ta, lits, cl, t1, t2, l_mask, rands, p_ta,
                             boost, n_states):
    """Plain version of :func:`ta_update_streamed` (``ref.ta_update_ref``
    on the given random words)."""
    K, C, L = ta.shape
    params = _params(K, 0, p_ta, boost, n_states, 0, ta.device)
    news, incs = [], []
    for k in range(K):
        p = params[k].to(torch.int64) & ref.M32
        new = ref.ta_update_ref(
            ta[k], unpack_literals(lits[k], L), cl[k], t1[k], t2[k],
            l_mask[k], 0, p[1], boost=p[2] != 0, n_states=p[3],
            rands=rands[k])
        news.append(new)
        incs.append(ref.pack_include(new, p[3]))
    return torch.stack(news).to(ta.dtype), torch.stack(incs)


def ta_update_sparse_plain(ta, lits, cl, t1, t2, l_mask, inc, tile_idx,
                           count, seed, p_ta, boost, n_states, row0=0,
                           rand_bits: int = 16, prng: str = "counter",
                           lfsr_bits: int = 24, seed_refresh: bool = True,
                           inplace: bool = False):
    """Plain version of :func:`ta_update_sparse`.  It reads ``count``
    on the host."""
    _check_inplace(ta, inc, inplace)
    K, C = ta.shape[:2]
    params = _params(K, seed, p_ta, boost, n_states, row0, ta.device)
    rows = []
    for k in range(K):
        g = tile_idx[k, :max(int(count[k]), 0)].to(torch.int64)
        r = (g[:, None] * GROUP + torch.arange(GROUP, device=ta.device))
        r = r.reshape(-1)
        rows.append(r[(r >= 0) & (r < C)])   # negative and past-C groups drop
    new_ta, new_inc = (ta, inc) if inplace else (ta.clone(), inc.clone())
    done = _plain_rows(ta, lits, cl, t1, t2, l_mask, params, rows, rand_bits,
                       prng, lfsr_bits, seed_refresh)
    for k, (t, i) in enumerate(done):
        new_ta[k, rows[k]] = t.to(ta.dtype)
        new_inc[k, rows[k]] = i
    return new_ta, new_inc


def _check_inplace(ta, inc, inplace: bool) -> None:
    if inplace and not (ta.is_contiguous() and inc.is_contiguous()
                        and inc.dtype == torch.int32):
        raise ValueError("an in-place TA update needs a contiguous ta and "
                         "a contiguous int32 inc")


def _route(*ts) -> str:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return "cuda"
    raise ValueError(f"no kernel for operands on "
                     f"{sorted(str(t.device) for t in ts)}")


def _feedback(cl, t1, t2):
    """[cl, t1, t2] as the kernel reads them, contiguous int32: the
    engine's feedback as it is, any other dtype as its > 0 test."""
    return [(t if t.dtype == torch.int32 else (t > 0).to(torch.int32))
            .contiguous() for t in (cl, t1, t2)]


def _operands(lits, cl, t1, t2, l_mask, K: int, C: int, B2: int,
              streamed: bool = False):
    """The kernel's read-only operands (lits, cl, t1, t2, l_mask),
    contiguous, feedback and l_mask int32: the engine's tensors as they
    are.  Raises for a launch the kernel does not take."""
    if lits.dtype != torch.int32:
        raise TypeError(f"packed literals must be int32, got {lits.dtype}")
    if K > 65535:
        raise ValueError(f"K={K} programs exceed the grid's y limit")
    if sparse_smem(C, B2, streamed) > _SMEM_LIMIT:
        raise ValueError(f"2B={B2} batch rows and C={C} clauses overflow "
                         "the kernel's shared memory")
    return [lits.contiguous(), *_feedback(cl, t1, t2),
            l_mask.to(torch.int32).contiguous()]


def _blocks(S: int, C: int, W: int, dev) -> int:
    from .clause_eval import sm_count
    return sparse_blocks(S, C, W, sm_count(dev.index or 0))


def _launcher(wrapper, name: str, argtypes, args, keep):
    """The bare launch of C entry point ``name`` on the current stream,
    counted on ``wrapper``.  ``launch.args`` are its C arguments (the
    stream apart) and ``launch.keep`` the tensors and records they point
    into.  The library and its signature are resolved here, before any
    launch."""
    lib, fn = _build.entry("ta_update", name, argtypes)

    def launch():
        dev = torch.device("cuda", torch.cuda.current_device())
        status = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, name)
        wrapper.launches += 1
    launch.args, launch.keep = args, keep
    return launch


def _dense_outputs(ta, K: int, C: int, W: int):
    return (torch.empty(ta.shape, dtype=ta.dtype, device=ta.device),
            torch.empty((K, C, W), dtype=torch.int32, device=ta.device))


def prepare_ta_update(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost,
                      n_states, row0=0, rand_bits: int = 16,
                      prng: str = "counter", lfsr_bits: int = 24,
                      seed_refresh: bool = True):
    """(launch or None, (new_ta, new_inc)) of :func:`ta_update` on CUDA
    operands; the outputs hold the result once ``launch()`` has run."""
    K, C, L, W, B2 = _check(ta, lits, cl, t1, t2, l_mask)
    _check_stream(prng, lfsr_bits, rand_bits)
    out, inc = _dense_outputs(ta, K, C, W)
    if out.numel() == 0:
        return None, (out, inc)
    dev = ta.device
    ta = ta.contiguous()
    ops_ = _operands(lits, cl, t1, t2, l_mask, K, C, B2)
    scal, held = _scalars(K, dev, seed, p_ta, boost, n_states, row0)
    G = -(-C // GROUP)
    lfsr = prng == "lfsr"
    args = ([ta.data_ptr()] + [t.data_ptr() for t in ops_]
            + [ctypes.addressof(scal), out.data_ptr(), inc.data_ptr(), K, C,
               L, W, B2, ta.element_size(), int(lfsr), int(lfsr_bits),
               int(lfsr_refresh(prng, lfsr_bits, seed_refresh, B2)),
               int(rand_bits), ref.LFSR_TAPS[lfsr_bits] if lfsr else 0,
               _blocks(G, C, W, dev)])
    launch = _launcher(ta_update, "dtm_ta_update", _DENSE_ARGTYPES, args,
                       [ta, *ops_, out, inc, scal, *held])
    return launch, (out, inc)


def _on_device(fn, dev):
    with torch.cuda.device(dev):
        fn()


def ta_update(ta, lits, cl, t1, t2, l_mask, seed, p_ta, boost, n_states,
              row0=0, rand_bits: int = 16, prng: str = "counter",
              lfsr_bits: int = 24, seed_refresh: bool = True):
    """Dense TA update of K programs (module docstring)."""
    _check(ta, lits, cl, t1, t2, l_mask)
    _check_stream(prng, lfsr_bits, rand_bits)
    kw = dict(rand_bits=rand_bits, prng=prng, lfsr_bits=lfsr_bits,
              seed_refresh=seed_refresh)
    if _route(ta, lits, cl, t1, t2, l_mask) == "cpu":
        return ta_update_plain(ta, lits, cl, t1, t2, l_mask, seed, p_ta,
                               boost, n_states, row0, **kw)
    launch, out = prepare_ta_update(ta, lits, cl, t1, t2, l_mask, seed,
                                    p_ta, boost, n_states, row0, **kw)
    if launch is not None:
        _on_device(launch, ta.device)
    return out


def _check_sparse(ta, lits, cl, t1, t2, l_mask, inc, tile_idx, count,
                  prng, lfsr_bits, rand_bits, inplace):
    K, C, L, W, B2 = _check(ta, lits, cl, t1, t2, l_mask)
    _check_stream(prng, lfsr_bits, rand_bits)
    if tile_idx.dim() != 2 or tile_idx.shape[0] != K or \
            tuple(count.shape) != (K,) or tuple(inc.shape) != (K, C, W):
        raise ValueError(f"tile_idx {tuple(tile_idx.shape)}, count "
                         f"{tuple(count.shape)} and inc {tuple(inc.shape)} "
                         f"do not fit K={K}, C={C}, W={W}")
    _check_inplace(ta, inc, inplace)
    return K, C, L, W, B2


def prepare_ta_update_sparse(ta, lits, cl, t1, t2, l_mask, inc, tile_idx,
                             count, seed, p_ta, boost, n_states, row0=0,
                             rand_bits: int = 16, prng: str = "counter",
                             lfsr_bits: int = 24, seed_refresh: bool = True,
                             inplace: bool = False):
    """(launch or None, (new_ta, new_inc)) of :func:`ta_update_sparse` on
    CUDA operands.  With ``inplace`` and the engine's operands (contiguous
    int32 words, index and count tensors) nothing is copied or converted."""
    K, C, L, W, B2 = _check_sparse(ta, lits, cl, t1, t2, l_mask, inc,
                                   tile_idx, count, prng, lfsr_bits,
                                   rand_bits, inplace)
    dev = ta.device
    S = tile_idx.shape[1]
    if inplace:
        out, new_inc = ta, inc
    else:
        out = ta.clone(memory_format=torch.contiguous_format)
        new_inc = inc.to(torch.int32, memory_format=torch.contiguous_format,
                         copy=True)
    if out.numel() == 0 or S == 0:
        return None, (out, new_inc)
    ops_ = _operands(lits, cl, t1, t2, l_mask, K, C, B2)
    idx = tile_idx.to(torch.int32).contiguous()
    cnt = count.to(torch.int32).contiguous()
    scal, held = _scalars(K, dev, seed, p_ta, boost, n_states, row0)
    lfsr = prng == "lfsr"
    args = ([out.data_ptr()] + [t.data_ptr() for t in ops_]
            + [ctypes.addressof(scal), idx.data_ptr(), cnt.data_ptr(),
               new_inc.data_ptr(), K, C, L, W, B2, S, out.element_size(),
               int(lfsr), int(lfsr_bits),
               int(lfsr_refresh(prng, lfsr_bits, seed_refresh, B2)),
               int(rand_bits), ref.LFSR_TAPS[lfsr_bits] if lfsr else 0,
               _blocks(S, C, W, dev)])
    launch = _launcher(ta_update_sparse, "dtm_ta_update_sparse",
                       _SPARSE_ARGTYPES, args,
                       [out, new_inc, *ops_, idx, cnt, scal, *held])
    return launch, (out, new_inc)


def ta_update_sparse(ta, lits, cl, t1, t2, l_mask, inc, tile_idx, count,
                     seed, p_ta, boost, n_states, row0=0,
                     rand_bits: int = 16, prng: str = "counter",
                     lfsr_bits: int = 24, seed_refresh: bool = True,
                     inplace: bool = False):
    """Compacted TA update: only the groups ``tile_idx[k, :count[k]]``
    (int32 [K, S] and [K]); ``inc`` [K, C, W] is the include bitplane of
    ``ta`` and supplies the rows left alone.  ``inplace`` writes the
    updated groups into ``ta`` and ``inc`` (contiguous, ``inc`` int32) and
    returns them (module docstring)."""
    _check_sparse(ta, lits, cl, t1, t2, l_mask, inc, tile_idx, count, prng,
                  lfsr_bits, rand_bits, inplace)
    kw = dict(rand_bits=rand_bits, prng=prng, lfsr_bits=lfsr_bits,
              seed_refresh=seed_refresh, inplace=inplace)
    if _route(ta, lits, cl, t1, t2, l_mask, inc, tile_idx, count) == "cpu":
        return ta_update_sparse_plain(ta, lits, cl, t1, t2, l_mask, inc,
                                      tile_idx, count, seed, p_ta, boost,
                                      n_states, row0, **kw)
    launch, out = prepare_ta_update_sparse(
        ta, lits, cl, t1, t2, l_mask, inc, tile_idx, count, seed, p_ta,
        boost, n_states, row0, **kw)
    if launch is not None:
        _on_device(launch, ta.device)
    return out


def prepare_ta_update_streamed(ta, lits, cl, t1, t2, l_mask, rands, p_ta,
                               boost, n_states):
    """(launch or None, (new_ta, new_inc)) of :func:`ta_update_streamed`
    on CUDA operands."""
    K, C, L, W, B2 = _check(ta, lits, cl, t1, t2, l_mask)
    _check_rands(rands, K, B2, C, L)
    out, inc = _dense_outputs(ta, K, C, W)
    if out.numel() == 0:
        return None, (out, inc)
    dev = ta.device
    ta, rands = ta.contiguous(), rands.contiguous()
    ops_ = _operands(lits, cl, t1, t2, l_mask, K, C, B2, streamed=True)
    scal, held = _scalars(K, dev, 0, p_ta, boost, n_states, 0)
    args = ([ta.data_ptr()] + [t.data_ptr() for t in ops_]
            + [ctypes.addressof(scal), rands.data_ptr(), out.data_ptr(),
               inc.data_ptr(), K, C, L, W, B2, ta.element_size(),
               _blocks(-(-C // GROUP), C, W, dev)])
    launch = _launcher(ta_update_streamed, "dtm_ta_update_streamed",
                       _STREAMED_ARGTYPES, args,
                       [ta, *ops_, rands, out, inc, scal, *held])
    return launch, (out, inc)


def ta_update_streamed(ta, lits, cl, t1, t2, l_mask, rands, p_ta, boost,
                       n_states):
    """Dense TA update of K programs with pre-made random words ``rands``
    int32 [K, 2B, C, L] (module docstring; :func:`stream_rands` makes the
    ones the in-kernel streams would use)."""
    K, C, L, W, B2 = _check(ta, lits, cl, t1, t2, l_mask)
    _check_rands(rands, K, B2, C, L)
    if _route(ta, lits, cl, t1, t2, l_mask, rands) == "cpu":
        return ta_update_streamed_plain(ta, lits, cl, t1, t2, l_mask, rands,
                                        p_ta, boost, n_states)
    launch, out = prepare_ta_update_streamed(ta, lits, cl, t1, t2, l_mask,
                                             rands, p_ta, boost, n_states)
    if launch is not None:
        _on_device(launch, ta.device)
    return out


ta_update.launches = 0
ta_update_sparse.launches = 0
ta_update_streamed.launches = 0
