"""Nested containers of tensors, flattened in JAX's pytree order.

A node is a dict (children by sorted key), a list, a tuple (a NamedTuple
keeps its type and field order), ``None`` (a node without children) or a
:class:`~repro_torch.core.prng.PRNG` (its state's leaves: ``lanes,
master, cycles`` for lfsr, the one word or key otherwise); anything else
is a leaf.  ``jax.tree.flatten`` of the same structure gives the same
leaves in the same order, which is what the checkpoint files and the
optimizer's states rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from .prng import PRNG, LFSRState

IsLeaf = Optional[Callable[[Any], bool]]
_END = object()


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree: ``kind`` (``"leaf"``, ``"none"``,
    ``"dict"``, ``"list"``, ``"tuple"``, ``"prng"``), ``meta`` (the dict's
    sorted keys, the tuple's type, the PRNG itself) and the children's
    structures."""

    kind: str
    meta: Any = None
    children: Tuple["TreeDef", ...] = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind == "prng":
            names = ("lanes", "master", "cycles") if \
                self.meta.backend == "lfsr" else ("state",)
            return f"PRNG[{self.meta.backend}]({', '.join(names)})"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "list":
            return f"[{inner}]"
        if self.meta is not tuple:
            return f"{self.meta.__name__}({inner})"
        return f"({inner}{',' if len(self.children) == 1 else ''})"


def _node(tree, is_leaf: IsLeaf) -> Tuple[str, Any, list]:
    """(kind, meta, children) of one level of ``tree``."""
    if is_leaf is not None and is_leaf(tree):
        return "leaf", None, []
    if tree is None:
        return "none", None, []
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, list):
        return "list", None, list(tree)
    if isinstance(tree, tuple):
        return "tuple", type(tree), list(tree)
    if isinstance(tree, PRNG):
        return "prng", tree, list(tree.leaves())
    return "leaf", None, []


def flatten(tree, is_leaf: IsLeaf = None) -> Tuple[List[Any], TreeDef]:
    """(leaves in JAX's order, structure)."""
    leaves: List[Any] = []

    def walk(t) -> TreeDef:
        kind, meta, kids = _node(t, is_leaf)
        if kind == "leaf":
            leaves.append(t)
            return TreeDef("leaf")
        return TreeDef(kind, meta, tuple(walk(k) for k in kids))
    return leaves, walk(tree)


def leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def unflatten(treedef: TreeDef, leaves_) -> Any:
    """A tree of ``treedef``'s structure with the given leaves."""
    it = iter(leaves_)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.meta, kids))
        if td.kind == "list":
            return kids
        if td.kind == "prng":
            st = (LFSRState(*kids) if td.meta.backend == "lfsr"
                  else kids[0])
            return dataclasses.replace(td.meta, state=st)
        return td.meta(*kids) if hasattr(td.meta, "_fields") \
            else td.meta(kids)
    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


def flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """The subtrees of ``tree`` at ``treedef``'s leaf positions (JAX's
    ``treedef.flatten_up_to``): ``tree`` must have ``treedef``'s nodes
    down to them."""
    out: List[Any] = []

    def walk(td: TreeDef, t):
        if td.kind == "leaf":
            out.append(t)
            return
        kind, meta, kids = _node(t, None)
        if kind != td.kind or len(kids) != len(td.children) or (
                kind == "dict" and meta != td.meta):
            raise ValueError(f"tree structure {kind} does not match "
                             f"{td.kind} ({td})")
        for c, k in zip(td.children, kids):
            walk(c, k)
    walk(treedef, tree)
    return out


def map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (``jax.tree.map``)."""
    flat, td = flatten(tree, is_leaf)
    others = [flatten_up_to(td, r) for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])
