"""Atomic, step-addressed checkpoints, in the JAX package's file format.

One directory per step, ``step_XXXXXXXX/``, holding ``shard-0-of-1.npz``
(arrays ``leaf_0`` … ``leaf_{n-1}``) and ``meta.json`` (``step``,
``n_leaves``, ``process_count``, ``treedef``, ``dtypes``, ``time``,
``extra``).  A save writes a ``step_X.tmp.<pid>`` directory and publishes
it with one ``os.replace``, so a crash mid-save never leaves a step that
:func:`latest_step` would pick; the first writer of a step wins.

The files cross between the two packages.  A tree is dicts (lists,
tuples) of arrays, tensors and :class:`~repro_torch.core.prng.PRNG` s,
flattened in JAX's pytree order (:mod:`repro_torch.core.tree`): a dict by
sorted key, a PRNG as its state's leaves
(``lanes, master, cycles`` for lfsr, the one counter word for counter,
the one key [2] for threefry);
``TM.save``'s ``{"ta", "weights", "prng"}`` is therefore ``prng…, ta,
weights``.  Leaves are written with the JAX dtypes: the PRNG's words
(int64 tensors here) as uint32.  ``treedef`` describes the structure; a
reader checks only the leaf count, shapes and dtypes.  ``process_count``
is 1.

Concurrent readers: :func:`latest_step` records the step it resolved
and :func:`restore` pins its step while it reads; the retention sweep
(``_gc``) skips pinned steps and steps resolved within the last
``_GC_GRACE_S`` seconds.
"""
from __future__ import annotations

import errno
import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

# ---- reader/GC coordination (process-local) --------------------------------
# _RESOLVED:  ckpt_dir -> (step, monotonic time of the last latest_step())
# _PINNED:    (ckpt_dir, step) -> refcount of in-progress restore() calls
_GC_GRACE_S = 30.0
_REG_LOCK = threading.Lock()
_RESOLVED: dict = {}
_PINNED: dict = {}


def _protected_steps(ckpt_dir: str) -> set:
    """Steps _gc must not delete: pinned by an in-progress restore, or
    resolved by a latest_step() call within the grace window."""
    key = os.path.abspath(ckpt_dir)
    now = time.monotonic()
    with _REG_LOCK:
        keep = {s for (d, s), n in _PINNED.items() if d == key and n > 0}
        got = _RESOLVED.get(key)
        if got is not None and now - got[1] < _GC_GRACE_S:
            keep.add(got[0])
    return keep


def _note_resolved(ckpt_dir: str, step: int) -> None:
    with _REG_LOCK:
        _RESOLVED[os.path.abspath(ckpt_dir)] = (step, time.monotonic())


def _pin(ckpt_dir: str, step: int, delta: int) -> None:
    key = (os.path.abspath(ckpt_dir), step)
    with _REG_LOCK:
        n = _PINNED.get(key, 0) + delta
        if n <= 0:
            _PINNED.pop(key, None)
        else:
            _PINNED[key] = n


# ---- flatten / unflatten in JAX's leaf order --------------------------------
# A leaf is (value, u32): u32 marks a PRNG word, uint32 in the JAX package
# and int64 here.

def _u32_marks(td: tree_lib.TreeDef, in_prng: bool = False) -> List[bool]:
    if td.kind == "leaf":
        return [in_prng]
    inner = in_prng or td.kind == "prng"
    return [m for c in td.children for m in _u32_marks(c, inner)]


def _flatten(tree) -> Tuple[List[Tuple[Any, bool]], str]:
    """(leaves with their PRNG marks, structure description) of a tree of
    dicts, lists, tuples, PRNGs and arrays (:mod:`repro_torch.core.
    tree`)."""
    leaves, td = tree_lib.flatten(tree)
    return list(zip(leaves, _u32_marks(td))), str(td)


def _to_numpy(x, u32: bool) -> np.ndarray:
    a = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))
    if u32:
        a = a.astype(np.uint32)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"cannot checkpoint a leaf of dtype {a.dtype}")
    return a


def _like_leaf(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """``arr`` from the file as a tensor of ``ref``'s dtype and device."""
    t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=ref.device, dtype=ref.dtype)


# ---- save / restore -----------------------------------------------------------

def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomic save; returns the published directory.  ``keep`` newest
    steps are retained (0 keeps all)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)

    leaves, treedef = _flatten(tree)
    arrs = {f"leaf_{i}": _to_numpy(x, u32)
            for i, (x, u32) in enumerate(leaves)}
    np.savez(os.path.join(tmp, "shard-0-of-1.npz"), **arrs)
    meta = {
        "step": step,
        "n_leaves": len(leaves),
        "process_count": 1,
        "treedef": treedef,
        "dtypes": [str(a.dtype) for a in arrs.values()],
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    try:
        # os.replace fails (ENOTEMPTY/EEXIST) when another writer already
        # published this step: the first writer wins, this tmp goes
        os.replace(tmp, final)
    except OSError as e:
        if e.errno not in (errno.ENOTEMPTY, errno.EEXIST, errno.ENOTDIR):
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    _gc(ckpt_dir, keep)
    return final


def _tmp_is_live(name: str) -> bool:
    """A ``step_X.tmp.<pid>`` dir belongs to a live writer iff its pid is
    still running (this process counts: another thread may be saving)."""
    try:
        pid = int(name.rsplit(".", 1)[-1])
    except ValueError:
        return True                    # unparseable: leave it alone
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False                   # writer died mid-save: an orphan
    except (PermissionError, OverflowError):
        return True                    # exists (or unknowable): keep
    return True


def _gc(ckpt_dir: str, keep: int) -> None:
    entries = os.listdir(ckpt_dir)
    # tmp dirs of writers killed mid-save go here; a live writer's stay
    for d in entries:
        if d.startswith("step_") and ".tmp." in d and not _tmp_is_live(d):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    protected = _protected_steps(ckpt_dir)
    steps = sorted(d for d in entries if d.startswith("step_")
                   and ".tmp" not in d)
    for d in steps[:-keep] if keep > 0 else []:
        if int(d.split("_")[1]) in protected:
            continue                   # a concurrent reader resolved it
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir`` (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp" not in d:
            p = os.path.join(ckpt_dir, d)
            if os.path.exists(os.path.join(p, "meta.json")):
                steps.append(int(d.split("_")[1]))
    if not steps:
        return None
    step = max(steps)
    _note_resolved(ckpt_dir, step)     # shields it from a concurrent _gc
    return step


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, dict]:
    """Restore a step into the structure of ``like`` (dicts of tensors and
    PRNGs): each leaf takes the dtype and device of ``like``'s leaf
    (shapes and the leaf count must match).  Returns (tree, extra)."""
    _pin(ckpt_dir, step, +1)
    try:
        return _restore_pinned(ckpt_dir, step, like)
    finally:
        _pin(ckpt_dir, step, -1)


def _restore_pinned(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, dict]:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    pc = meta["process_count"]
    leaves_like, _ = _flatten(like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the "
                         f"target structure has {len(leaves_like)}: config "
                         "mismatch?")
    out = []
    with np.load(os.path.join(path, f"shard-0-of-{pc}.npz")) as data:
        for i, (ref, _) in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: saved {tuple(arr.shape)} != "
                                 f"expected {tuple(ref.shape)}")
            out.append(_like_leaf(arr, ref))
    return tree_lib.unflatten(tree_lib.flatten(like)[1], out), meta["extra"]


def restore_latest(ckpt_dir: str, like: Any
                   ) -> Optional[Tuple[int, Any, dict]]:
    """(step, tree, extra) of the newest step, or None."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = restore(ckpt_dir, step, like)
    return step, tree, extra
