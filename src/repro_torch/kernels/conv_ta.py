"""The conv train step's TA stage: two Hopper kernels and their plain
version.

A conv train step of K programs (``DTMEngine._train_conv_impl``) draws
its random words, runs the clause stage on every patch row and both
Alg-3 rounds; then, for each (batch row, clause), Type I/II feedback
against one random matching patch.  :func:`conv_ta_update` is that
feedback.  From the program's TA states ``ta`` [K, R, L] (uint8, or int32
when ``ta_bits`` > 8) and include bitplane ``inc`` [K, R, W], the packed
patch literals ``plits`` [K, B, P, Wl], the per-patch clause outputs
``cl_p`` [K, B, P, R] and their OR ``cl`` [K, B, R], both selections
``sel_lab``/``sel_neg`` [K, B, R], the weights [K, H, R], the target and
negated classes ``labels``/``neg`` [K, B], the step's full-width draws
``patch_rand`` [K, B, P, Rg] and ``ta_rand`` [K, 2, B, Rg, L] (int64
words below 2^32, read at rows ``row0`` + r), ``l_mask`` [K, L],
``cl_mask`` [K, R] and the per-program ``p_ta``, ``boost`` and
``n_states`` [K] it returns

    new_ta  [K, R, L]  ta.dtype  the states after the summed deltas,
                                 masked and clipped to [0, n_states − 1]
    new_inc [K, R, W]  int32     their include bitplane (pack_include)

The program holds ``R`` rows; ``Rg`` is the draws' row count.  A
clause-sharded step passes its window's program rows and the full-width
draws with the window's first row as ``row0``, so both versions read the
window's words where they lie.

CUDA tensors launch ``csrc/conv_ta.cu``: ``conv_patch_pick`` (the picked
patch of each (batch row, clause), into a [K, B, R] int32 scratch) and
``conv_ta_update`` (the deltas, masks, clip and include words); CPU
tensors run :func:`conv_ta_update_plain`, the engine's torch chain;
anything else raises.  The kernels are exact for the engine's operands:
clause outputs in [0, 2^21) with ``cl`` their maximum over the patches
(what ``_conv_clauses`` gives), ``labels`` and ``neg`` in [0, H).  The
plain version takes any values.  ``prepare_conv_ta_update`` returns
``(launch, outputs)``: ``launch()`` is the bare launch of both kernels.
``conv_ta_update.launches`` counts kernel launches (two a call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.booleanize import unpack_literals
from . import _build
from .ref import M32, pack_include
from .ta_update import _route

# ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights, labels, neg,
# patch_rand, ta_rand, l_mask, cl_mask, p_ta, boost, n_states, pidx,
# ta_out, inc_out; K, B, P, R, Rg, row0, L, Wl, W, H, ta_bytes, vec; stream
_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 12 + [ctypes.c_void_p]

_I32 = ("inc", "plits", "cl_p", "cl", "sel_lab", "sel_neg", "weights",
        "labels", "neg", "l_mask", "cl_mask", "p_ta", "n_states")


def conv_ta_update_plain(ta, inc, plits, cl_p, cl, sel_lab, sel_neg,
                         weights, labels, neg, patch_rand, ta_rand, l_mask,
                         cl_mask, p_ta, boost, n_states, row0: int = 0):
    """Plain version of :func:`conv_ta_update`: the engine's torch chain."""
    K, R, L = ta.shape
    B = plits.shape[1]
    rows = slice(row0, row0 + R)
    patch_rand, ta_rand = patch_rand[..., rows], ta_rand[..., rows, :]

    # one random matching patch per (datapoint, clause) and its
    # literals: an index gather (the reference's one-hot product)
    noise = (patch_rand % 997).to(torch.int32)                # [K,B,P,R]
    patch_idx = torch.argmax(cl_p * 1000 + noise, dim=2)      # [K,B,R]
    pl_dense = unpack_literals(plits, L)                      # [K,B,P,L]
    litb = torch.gather(pl_dense, 2, patch_idx[..., None].expand(
        K, B, R, L)) > 0                                      # [K,B,R,L]

    def rows_of(cls):
        return torch.gather(weights, 1,
                            cls.long()[..., None].expand(K, B, R))
    w_lab, w_neg = rows_of(labels), rows_of(neg)
    rounds = ((sel_lab * (w_lab >= 0), sel_lab * (w_lab < 0),
               ta_rand[:, 0]),
              (sel_neg * (w_neg < 0), sel_neg * (w_neg >= 0),
               ta_rand[:, 1]))

    # Type I/II deltas against the selected patch's literals (Alg 5),
    # gated by the OR-level clause output; include from the bitplane
    clb = (cl > 0)[..., None]                                 # [K,B,R,1]
    incb = (unpack_literals(inc, L) > 0)[:, None]             # [K,1,R,L]
    cl_and_lit = clb & litb
    inc2 = (clb & ~litb & ~incb).to(torch.int32)
    p_ta = (p_ta.to(torch.int64) & M32)[:, None, None, None]
    boost = boost[:, None, None, None]
    delta = torch.zeros((K, R, L), dtype=torch.int32, device=ta.device)
    for t1, t2, tr in rounds:
        low = tr < p_ta
        inc1 = torch.where(boost, cl_and_lit, cl_and_lit & ~low)
        d1 = inc1.to(torch.int32) - (~cl_and_lit & low).to(torch.int32)
        delta += (t1[..., None] * d1 + t2[..., None] * inc2).sum(
            dim=1, dtype=torch.int32)
    delta = delta * l_mask[:, None, :] * cl_mask[:, :, None]
    new_ta = torch.maximum(
        torch.minimum(ta.to(torch.int32) + delta,
                      (n_states - 1)[:, None, None]),
        torch.zeros_like(delta))
    return new_ta.to(ta.dtype), pack_include(new_ta, n_states)


def _check(ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights, labels, neg,
           patch_rand, ta_rand, l_mask, cl_mask, p_ta, boost, n_states,
           row0: int):
    """Validate the operands (shapes, dtypes, the draws' layout); returns
    (K, B, P, R, Rg, L, Wl, W, H)."""
    if ta.dim() != 3 or plits.dim() != 4 or weights.dim() != 3 \
            or patch_rand.dim() != 4:
        raise ValueError(f"expected ta [K, R, L], plits [K, B, P, Wl], "
                         f"weights [K, H, R], patch_rand [K, B, P, Rg]; got "
                         f"{tuple(ta.shape)}, {tuple(plits.shape)}, "
                         f"{tuple(weights.shape)}, {tuple(patch_rand.shape)}")
    K, R, L = ta.shape
    _, B, P, Wl = plits.shape
    H, Rg, W = weights.shape[1], patch_rand.shape[-1], -(-L // 32)
    want = {"inc": (inc, (K, R, W)), "plits": (plits, (K, B, P, Wl)),
            "cl_p": (cl_p, (K, B, P, R)), "cl": (cl, (K, B, R)),
            "sel_lab": (sel_lab, (K, B, R)), "sel_neg": (sel_neg, (K, B, R)),
            "weights": (weights, (K, H, R)), "labels": (labels, (K, B)),
            "neg": (neg, (K, B)), "patch_rand": (patch_rand, (K, B, P, Rg)),
            "ta_rand": (ta_rand, (K, 2, B, Rg, L)),
            "l_mask": (l_mask, (K, L)), "cl_mask": (cl_mask, (K, R)),
            "p_ta": (p_ta, (K,)), "boost": (boost, (K,)),
            "n_states": (n_states, (K,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if 32 * Wl < L:
        raise ValueError(f"plits hold {32 * Wl} literals, fewer than L={L}")
    if not 0 <= row0 <= Rg - R:
        raise ValueError(f"rows [{row0}, {row0 + R}) lie outside the draws' "
                         f"{Rg}")
    if ta.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"ta must be uint8 or int32, got {ta.dtype}")
    dtypes = {name: want[name][0].dtype for name in _I32}
    dtypes.update(patch_rand=patch_rand.dtype, ta_rand=ta_rand.dtype,
                  boost=boost.dtype)
    for name, dt in dtypes.items():
        need = (torch.int64 if name.endswith("_rand") else
                torch.bool if name == "boost" else torch.int32)
        if dt != need:
            raise TypeError(f"{name} must be {need}, got {dt}")
    for name, t in (("patch_rand", patch_rand), ("ta_rand", ta_rand)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the full-width "
                             "draw; pass row0 for a window)")
    return K, B, P, R, Rg, L, Wl, W, H


def prepare_conv_ta_update(ta, inc, plits, cl_p, cl, sel_lab, sel_neg,
                           weights, labels, neg, patch_rand, ta_rand, l_mask,
                           cl_mask, p_ta, boost, n_states, row0: int = 0):
    """(launch or None, outputs) of :func:`conv_ta_update` on CUDA
    operands; the outputs hold the result once ``launch()`` has run."""
    K, B, P, R, Rg, L, Wl, W, H = _check(
        ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights, labels, neg,
        patch_rand, ta_rand, l_mask, cl_mask, p_ta, boost, n_states, row0)
    dev = ta.device
    ta = ta.contiguous()
    small = [t.contiguous() for t in (inc, plits, cl_p, cl, sel_lab, sel_neg,
                                      weights, labels, neg)]
    per = [t.contiguous() for t in (l_mask, cl_mask, p_ta, boost, n_states)]
    ins = [ta] + small + [patch_rand, ta_rand] + per
    pidx = torch.empty((K, B, R), dtype=torch.int32, device=dev)
    new_ta = torch.empty_like(ta)
    new_inc = torch.empty((K, R, W), dtype=torch.int32, device=dev)
    outs = (new_ta, new_inc)
    if K == 0 or R == 0:
        return None, outs
    if K > 65535 or B > 65535:
        raise ValueError(f"K={K}, B={B} exceed the grids' limits")
    align = 16 if ta.dtype == torch.int32 else 4
    vec = int(L % 4 == 0 and ta.data_ptr() % align == 0
              and ta_rand.data_ptr() % 16 == 0)
    lib, fn = _build.entry("conv_ta", "dtm_conv_ta", _ARGTYPES)
    cargs = ([t.data_ptr() for t in ins]
             + [t.data_ptr() for t in (pidx, new_ta, new_inc)]
             + [K, B, P, R, Rg, int(row0), L, Wl, W, H, ta.element_size(),
                vec])

    def launch():
        status = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, "dtm_conv_ta")
        conv_ta_update.launches += 2 if B else 1
    launch.keep = (ins, outs, pidx)   # the tensors its pointers point into
    return launch, outs


def conv_ta_update(ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights,
                   labels, neg, patch_rand, ta_rand, l_mask, cl_mask, p_ta,
                   boost, n_states, row0: int = 0):
    """The conv step's TA stage, two launches on the card (module
    docstring).  Returns (new_ta, new_inc)."""
    args = (ta, inc, plits, cl_p, cl, sel_lab, sel_neg, weights, labels,
            neg, patch_rand, ta_rand, l_mask, cl_mask, p_ta, boost, n_states)
    if _route(*args) == "cpu":
        _check(*args, row0)
        return conv_ta_update_plain(*args, row0=row0)
    launch, outs = prepare_conv_ta_update(*args, row0=row0)
    if launch is not None:
        with torch.cuda.device(ta.device):
            launch()
    return outs


conv_ta_update.launches = 0
