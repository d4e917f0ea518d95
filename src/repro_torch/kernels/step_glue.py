"""The train step's glue around its front half: two Hopper kernels and
their plain versions.

A train step of K programs (``DTMEngine._train_impl``) draws its random
words, runs the front half (``fused_step`` or its unfused stages), then
the TA update.  What lies between is integer glue; here it is two
launches.

:func:`step_prologue` runs after the three draws and before the front
half.  From the draws ``c_rand`` [K, B], ``seed_bits`` [K, 2] and
``sel_rand`` [K, 2, B, R] (int64 words below 2^32), the labels [K, B],
``h_mask`` [K, H] and ``regression`` [K] it writes

    labels  [K, B] int32   the labels as int32
    cls_lab [K, B] int32   the target round's class (0 for a regression
                           program, whose labels are vote targets)
    neg     [K, B] int32   the negated round's class: c_rand mod
                           max(n_cls − 1, 1), skipping cls_lab
    ta_seed [K]    int64   (seed_bits[0] << rand_bits | seed_bits[1]) & M32
    sel_rand [K, 2, B, R] int32  the selection words as the front half
                           reads them

:func:`step_epilogue` runs after the front half.  From the packed
literals [K, B, W], the clause outputs ``cl``, the class sums ``sums``
[K, B, H], both selections ``sel_lab``/``sel_neg`` [K, B, R], the int32
selection words, the prologue's labels and classes and the program's
weights [K, H, R], ``cl_mask`` [K, R], ``w_frozen``, ``w_clip``, ``T``
and ``regression`` [K] it writes, in one launch,

    lit2, cl2, t1, t2   the TA update's operands: [K, 2B, W] and
                        [K, 2B, R], target rows then negated rows; t1/t2
                        the Type I / II feedback (by the sign of the
                        class's weight; a regression program's by the
                        sign of the error of its clipped vote count)
    tile_idx, count     the Alg-6 group list [K, G], [K] of
                        :func:`active_groups` (128-row groups with any
                        Type I or II feedback, in order, then zeros)
    weights             the Alg-4 nudged, clipped weights [K, H, R]
    stats               int32 [len(STAT_KEYS), K]: selected,
                        active_groups and total_groups (on the engine's
                        ``y``-row groups), correct, abs_err

The kernels are exact for the engine's operands: clause outputs,
selections and ``cl_mask`` in {0, 1} (what the front half writes and a
program holds) and labels in [0, H).  The plain versions are the engine's
torch glue and take any values; they also take the clause-sharded step's
collectives (``vote_sum``, ``gather``).

CUDA tensors launch ``csrc/step_glue.cu``; CPU tensors run the plain
versions; anything else raises.  The epilogue runs one thread-block
cluster per program over the clause axis (:func:`epilogue_geometry`):
128 columns × 4 batch-row groups a block, the partial vote counts,
group flags and stat partials meeting in distributed shared memory.
That kernel holds the rows and its columns' class signs in shared
memory, so it takes H <= :data:`MAX_CLASSES` and as many rows as fit
(about 4,150 at H=16 on the H100); a launch past either takes the wide
kernel in the same layout, which keeps the rows' errors in a [K, B]
scratch tensor, reads each row's class weights from device memory and
adds the nudges by atomics: the same outputs for any B and H.
``inplace`` writes the new weights over ``weights`` (a donated step), as
the compacted TA update writes the TA states.  ``prepare_step_prologue`` and
``prepare_step_epilogue`` return ``(launch, outputs)``: ``launch()`` is
the bare kernel launch.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import M32
from .ta_update import GROUP, _route

N_STATS = 5            # len(core.dtm.STAT_KEYS), in its order
MAX_CLASSES = 64       # classes of the cluster kernel (csrc kMaxClasses)
MAX_CLUSTER = 16       # blocks of an epilogue cluster (csrc kMaxCluster)
TILE = 128             # clause columns of an epilogue tile (csrc kCols)
PROLOGUE_THREADS = 256

# c_rand, seed_bits, sel_rand, labels, h_mask, regression, cls_lab, neg,
# ta_seed, sel_out; K, B, H; n_sel; rand_bits, blocks; stream
_PRO_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
# lit, cl, sums, sel_lab, sel_neg, rand, labels, cls_lab, neg, w, cl_mask,
# frozen, clip, T, regression, lit2, cl2, t1, t2, tile_idx, count, w_out,
# stats, err; K, B, R, W, H, y, rand_bits, cluster, wide; stream
_EPI_ARGTYPES = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p])


# --------------------------------------------------------------------- #
# plain versions (the engine's glue)                                    #
# --------------------------------------------------------------------- #
def step_prologue_plain(labels, c_rand, seed_bits, sel_rand, h_mask,
                        regression, rand_bits: int = 16):
    """Plain version of :func:`step_prologue`."""
    n_cls = h_mask.sum(dim=-1)                                     # [K]
    reg = regression
    ta_seed = ((seed_bits[:, 0] << rand_bits) | seed_bits[:, 1]) & M32
    # regression programs carry a vote target in `labels`; the class
    # machinery runs on a pinned in-range label
    labels = labels.to(torch.int32)
    cls_lab = torch.where(reg[:, None], torch.zeros_like(labels), labels)
    rn = (c_rand % torch.clamp(n_cls - 1, min=1)[:, None]).to(torch.int32)
    neg = torch.where(rn < cls_lab, rn, rn + 1)                    # [K, B]
    return labels, cls_lab, neg, ta_seed, sel_rand.to(torch.int32)


def active_groups(t1: torch.Tensor, t2: torch.Tensor, group: int = GROUP):
    """The Alg-6 compaction on the device: clause groups of ``group`` rows
    that get Type I or II feedback from any batch row.  t1/t2 [K, 2B, C]
    -> (tile_idx int32 [K, G], the active groups first, in order; count
    int32 [K]).  No host read: cumsum and scatter."""
    K, _, C = t1.shape
    G = -(-C // group)
    rows = torch.zeros((K, G * group), dtype=torch.bool, device=t1.device)
    rows[:, :C] = ((t1 > 0) | (t2 > 0)).any(dim=1)
    grp = rows.reshape(K, G, group).any(dim=-1)
    count = grp.sum(dim=-1, dtype=torch.int32)
    pos = torch.cumsum(grp.to(torch.int64), dim=-1) - 1
    dest = torch.where(grp, pos, torch.full_like(pos, G))   # G: a spare slot
    src = torch.arange(G, dtype=torch.int32, device=t1.device).expand(K, G)
    idx = torch.zeros((K, G + 1), dtype=torch.int32, device=t1.device)
    return idx.scatter_(1, dest, src)[:, :G], count


def weights_and_stats_plain(weights, w_frozen, w_clip, cl_mask, cl, sel_lab,
                            sel_neg, lab, neg, correct, abs_err, y: int,
                            gather=None):
    """Alg-4 weight nudges as exact int32 scatter-adds, and the Alg-6
    group accounting on ``y``-row groups -> (new weights, stats int32
    [N_STATS, K]).  ``gather`` (clause-sharded: the JAX
    ``_weights_and_stats_sharded``) gathers the selection counts and the
    clause mask to all R rows before the group accounting (a window can
    be smaller than a group); the nudges act on the window's columns."""
    K, B, R = cl.shape
    d_w = torch.zeros_like(weights)
    d_w.scatter_add_(1, lab.long()[..., None].expand(K, B, R),
                     sel_lab * cl)
    d_w.scatter_add_(1, neg.long()[..., None].expand(K, B, R),
                     -(sel_neg * cl))
    clip = w_clip[:, None, None]
    new_w = torch.where(w_frozen[:, None, None], weights,
                        torch.clamp(weights + d_w, -clip, clip))
    d_sel = (sel_lab + sel_neg).sum(dim=1, dtype=torch.int32)     # [K, R]
    if gather is not None:
        d_sel, cl_mask = gather(d_sel), gather(cl_mask)
    g = (d_sel > 0).to(torch.int32).reshape(K, -1, y).amax(dim=-1)
    gmask = cl_mask.reshape(K, -1, y).amax(dim=-1)
    stats = torch.stack([d_sel.sum(dim=-1, dtype=torch.int32),
                         (g * gmask).sum(dim=-1, dtype=torch.int32),
                         gmask.sum(dim=-1, dtype=torch.int32),
                         correct, abs_err])
    return new_w, stats


def step_epilogue_plain(lits, cl, sums, sel_lab, sel_neg, sel_rand, labels,
                        cls_lab, neg, weights, cl_mask, w_frozen, w_clip, T,
                        regression, y: int = 128, rand_bits: int = 16,
                        vote_sum=None, gather=None):
    """Plain version of :func:`step_epilogue`.  ``vote_sum`` (the
    clause-sharded step's all-reduce) sums the vote counts over the
    ranks; ``gather``: :func:`weights_and_stats_plain`."""
    K, B = cl.shape[:2]
    reg = regression                                               # [K]
    hits = (torch.argmax(sums, dim=-1) == labels).sum(
        dim=-1, dtype=torch.int32)
    correct = torch.where(reg, torch.zeros_like(hits), hits)

    # Regression TM: clipped vote count against the target; the error
    # picks Type I (under) or Type II (over) through the same compare
    Tc = T[:, None]
    votes = cl.sum(dim=-1, dtype=torch.int32)
    if vote_sum is not None:        # the global vote count
        votes = vote_sum(votes)
    votes = torch.minimum(votes.clamp(min=0), Tc)
    err = labels - votes                                           # [K, B]
    sel_reg = ((sel_rand[:, 0].to(torch.int32) * (2 * Tc)[..., None])
               < (err.abs()[..., None] << rand_bits))
    sel_reg = sel_reg.to(torch.int32) * cl_mask[:, None, :]
    abs_err = err.abs().sum(dim=-1, dtype=torch.int32)

    # Type I / II split per round by the sign of the class's weight
    # row (regression: by the sign of the error)
    def rows_of(cls):
        idx = cls.long()[..., None].expand(K, B, cl.shape[-1])
        return torch.gather(weights, 1, idx)
    w_lab, w_neg = rows_of(cls_lab), rows_of(neg)
    regb = reg[:, None, None]
    zero = torch.zeros_like(sel_lab)
    t1_lab = torch.where(regb, sel_reg * (err > 0)[..., None],
                         sel_lab * (w_lab >= 0))
    t2_lab = torch.where(regb, sel_reg * (err < 0)[..., None],
                         sel_lab * (w_lab < 0))
    t1_neg = torch.where(regb, zero, sel_neg * (w_neg < 0))
    t2_neg = torch.where(regb, zero, sel_neg * (w_neg >= 0))
    sel_lab = torch.where(regb, sel_reg, sel_lab)
    sel_neg = torch.where(regb, zero, sel_neg)

    # both rounds joined into one 2B batch (target rows, then negated)
    lit2 = torch.cat([lits, lits], dim=1)
    cl2 = torch.cat([cl, cl], dim=1)
    t1 = torch.cat([t1_lab, t1_neg], dim=1)
    t2 = torch.cat([t2_lab, t2_neg], dim=1)
    tile_idx, count = active_groups(t1, t2)
    new_w, stats = weights_and_stats_plain(
        weights, w_frozen, w_clip, cl_mask, cl, sel_lab, sel_neg, cls_lab,
        neg, correct, abs_err, y, gather)
    return lit2, cl2, t1, t2, tile_idx, count, new_w, stats


# --------------------------------------------------------------------- #
# the kernels                                                           #
# --------------------------------------------------------------------- #
def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as the kernel reads it: itself when it is contiguous and of
    ``dtype``, else a contiguous copy."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _check_prologue(labels, c_rand, seed_bits, sel_rand, h_mask,
                    regression):
    """Validate the prologue's operands; returns (K, B, R, H)."""
    if c_rand.dim() != 2 or sel_rand.dim() != 4 or h_mask.dim() != 2:
        raise ValueError(f"expected c_rand [K, B], sel_rand [K, 2, B, R], "
                         f"h_mask [K, H]; got {tuple(c_rand.shape)}, "
                         f"{tuple(sel_rand.shape)}, {tuple(h_mask.shape)}")
    K, B = c_rand.shape
    R, H = sel_rand.shape[-1], h_mask.shape[1]
    want = {"labels": (labels, (K, B)), "seed_bits": (seed_bits, (K, 2)),
            "sel_rand": (sel_rand, (K, 2, B, R)), "h_mask": (h_mask, (K, H)),
            "regression": (regression, (K,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    return K, B, R, H


def prepare_step_prologue(labels, c_rand, seed_bits, sel_rand, h_mask,
                          regression, rand_bits: int = 16):
    """(launch or None, outputs) of :func:`step_prologue` on CUDA
    operands; the outputs hold the result once ``launch()`` has run."""
    K, B, R, H = _check_prologue(labels, c_rand, seed_bits, sel_rand,
                                 h_mask, regression)
    dev = c_rand.device
    labels = _as(labels, torch.int32)
    ins = [_as(c_rand, torch.int64), _as(seed_bits, torch.int64),
           _as(sel_rand, torch.int64), labels, _as(h_mask, torch.int32),
           _as(regression, torch.bool)]
    cls_lab = torch.empty((K, B), dtype=torch.int32, device=dev)
    neg = torch.empty_like(cls_lab)
    ta_seed = torch.empty(K, dtype=torch.int64, device=dev)
    sel = torch.empty((K, 2, B, R), dtype=torch.int32, device=dev)
    outs = (labels, cls_lab, neg, ta_seed, sel)
    if K == 0:
        return None, outs
    lib, fn = _build.entry("step_glue", "dtm_step_prologue", _PRO_ARGTYPES)
    n_sel = sel.numel()
    from .clause_eval import sm_count
    per_block = 4 * PROLOGUE_THREADS          # words a block converts a pass
    blocks = max(1, min(-(-max(n_sel, K * B) // per_block),
                        4 * sm_count(dev.index or 0)))
    cargs = ([t.data_ptr() for t in ins]
             + [t.data_ptr() for t in (cls_lab, neg, ta_seed, sel)]
             + [K, B, H, n_sel, int(rand_bits), blocks])

    def launch():
        status = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, "dtm_step_prologue")
        step_prologue.launches += 1
    launch.keep = (ins, outs)       # the tensors its pointers point into
    return launch, outs


def step_prologue(labels, c_rand, seed_bits, sel_rand, h_mask, regression,
                  rand_bits: int = 16):
    """The step's glue before the front half, one launch (module
    docstring).  Returns (labels, cls_lab, neg, ta_seed, sel_rand)."""
    args = (labels, c_rand, seed_bits, sel_rand, h_mask, regression)
    _check_prologue(*args)
    if _route(*args) == "cpu":
        return step_prologue_plain(*args, rand_bits=rand_bits)
    launch, outs = prepare_step_prologue(*args, rand_bits=rand_bits)
    if launch is not None:
        with torch.cuda.device(c_rand.device):
            launch()
    return outs


def epilogue_geometry(R: int) -> int:
    """Blocks of an epilogue cluster: one per :data:`TILE`-column tile of
    the clause axis, at most :data:`MAX_CLUSTER` (block q takes tiles q,
    q + cluster, ...).  Pure: the CPU tests check it."""
    return max(1, min(-(-R // TILE), MAX_CLUSTER))


def _check_epilogue(lits, cl, sums, sel_lab, sel_neg, sel_rand, labels,
                    cls_lab, neg, weights, cl_mask, w_frozen, w_clip, T,
                    regression, y):
    """Validate the epilogue's operands; returns (K, B, R, W, H)."""
    if lits.dim() != 3 or cl.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"expected lits [K, B, W], cl [K, B, R], weights "
                         f"[K, H, R]; got {tuple(lits.shape)}, "
                         f"{tuple(cl.shape)}, {tuple(weights.shape)}")
    K, B, R = cl.shape
    W, H = lits.shape[2], weights.shape[1]
    want = {"lits": (lits, (K, B, W)), "sums": (sums, (K, B, H)),
            "sel_lab": (sel_lab, (K, B, R)), "sel_neg": (sel_neg, (K, B, R)),
            "sel_rand": (sel_rand, (K, 2, B, R)), "labels": (labels, (K, B)),
            "cls_lab": (cls_lab, (K, B)), "neg": (neg, (K, B)),
            "weights": (weights, (K, H, R)), "cl_mask": (cl_mask, (K, R)),
            "w_frozen": (w_frozen, (K,)), "w_clip": (w_clip, (K,)),
            "T": (T, (K,)), "regression": (regression, (K,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if y < 1 or R % y:
        raise ValueError(f"R={R} clause rows are not whole groups of y={y}")
    return K, B, R, W, H


def prepare_step_epilogue(lits, cl, sums, sel_lab, sel_neg, sel_rand, labels,
                          cls_lab, neg, weights, cl_mask, w_frozen, w_clip, T,
                          regression, y: int = 128, rand_bits: int = 16,
                          inplace: bool = False, geometry=None):
    """(launch or None, outputs) of :func:`step_epilogue` on CUDA
    operands; the outputs hold the result once ``launch()`` has run.
    ``geometry`` ({"cluster", "wide"}) replaces :func:`epilogue_geometry`'s
    cluster size (1: one block a program) and the choice of the wide
    kernel (:func:`epilogue_wide`; 0 raises where it is needed)."""
    K, B, R, W, H = _check_epilogue(lits, cl, sums, sel_lab, sel_neg,
                                    sel_rand, labels, cls_lab, neg, weights,
                                    cl_mask, w_frozen, w_clip, T, regression,
                                    y)
    if inplace and not (weights.is_contiguous()
                        and weights.dtype == torch.int32):
        raise ValueError("an in-place epilogue needs contiguous int32 "
                         "weights")
    dev = cl.device
    i32 = torch.int32
    ins = [_as(lits, i32), _as(cl, i32), _as(sums, i32), _as(sel_lab, i32),
           _as(sel_neg, i32), _as(sel_rand, i32), _as(labels, i32),
           _as(cls_lab, i32), _as(neg, i32), _as(weights, i32),
           _as(cl_mask, i32), _as(w_frozen, torch.bool), _as(w_clip, i32),
           _as(T, i32), _as(regression, torch.bool)]
    G = -(-R // GROUP)
    lit2 = torch.empty((K, 2 * B, W), dtype=i32, device=dev)
    cl2 = torch.empty((K, 2 * B, R), dtype=i32, device=dev)
    t1, t2 = torch.empty_like(cl2), torch.empty_like(cl2)
    tile_idx = torch.empty((K, G), dtype=i32, device=dev)
    count = torch.empty(K, dtype=i32, device=dev)
    new_w = ins[9] if inplace else torch.empty((K, H, R), dtype=i32,
                                               device=dev)
    stats = torch.empty((N_STATS, K), dtype=i32, device=dev)
    outs = (lit2, cl2, t1, t2, tile_idx, count, new_w, stats)
    if K == 0 or B == 0 or R == 0:
        return None, outs
    if K > 65535:
        raise ValueError(f"K={K} programs exceed the grid's z limit")
    g = _build.geometry_override(geometry, ("cluster", "wide"),
                                 "step_epilogue")
    cluster = g.get("cluster") or epilogue_geometry(R)
    need = epilogue_wide(B, H, R, y, dev)
    wide = g.get("wide", int(need))
    if need and not wide:
        raise ValueError(f"B={B}, H={H} need the wide epilogue kernel")
    # the wide kernel's row errors (written before they are read)
    err = torch.empty((K, B), dtype=i32, device=dev) if wide else None
    lib, fn = _build.entry("step_glue", "dtm_step_epilogue", _EPI_ARGTYPES)
    cargs = ([t.data_ptr() for t in ins] + [t.data_ptr() for t in outs]
             + [None if err is None else err.data_ptr()]
             + [K, B, R, W, H, int(y), int(rand_bits), cluster, wide])

    def launch():
        status = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, status, "dtm_step_epilogue")
        step_epilogue.launches += 1
    launch.keep = (ins, outs, err)
    return launch, outs


def epilogue_wide(B: int, H: int, R: int, y: int, device) -> bool:
    """Whether an epilogue of B rows and H classes over R clause rows takes
    the wide kernel on CUDA ``device``: more than :data:`MAX_CLASSES`
    classes, or more shared memory than the card gives a block."""
    if H > MAX_CLASSES:
        return True
    _, smem = _build.entry("step_glue", "dtm_step_epilogue_smem",
                           [ctypes.c_int] * 5, ctypes.c_size_t)
    return smem(B, H, R, int(y), 0) > _smem_optin(
        torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    """Shared memory bytes a block may opt in to on CUDA card ``index``."""
    lib, fn = _build.entry("step_glue", "dtm_smem_optin", [ctypes.c_int])
    optin = fn(index)
    if optin < 0:
        _build.check(lib, -optin, "dtm_smem_optin")
    return optin


def step_epilogue(lits, cl, sums, sel_lab, sel_neg, sel_rand, labels,
                  cls_lab, neg, weights, cl_mask, w_frozen, w_clip, T,
                  regression, y: int = 128, rand_bits: int = 16,
                  inplace: bool = False, geometry=None):
    """The step's glue after the front half, one launch (module
    docstring).  Returns (lit2, cl2, t1, t2, tile_idx, count, weights,
    stats); with ``inplace`` the weights are ``weights`` itself, updated
    (CUDA; the plain version returns new weights)."""
    args = (lits, cl, sums, sel_lab, sel_neg, sel_rand, labels, cls_lab,
            neg, weights, cl_mask, w_frozen, w_clip, T, regression)
    _check_epilogue(*args, y)
    if _route(*args) == "cpu":
        return step_epilogue_plain(*args, y=y, rand_bits=rand_bits)
    launch, outs = prepare_step_epilogue(*args, y=y, rand_bits=rand_bits,
                                         inplace=inplace, geometry=geometry)
    if launch is not None:
        with torch.cuda.device(cl.device):
            launch()
    return outs


step_prologue.launches = 0
step_epilogue.launches = 0
