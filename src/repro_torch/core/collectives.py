"""The port's collectives over ``torch.distributed`` process groups, and
a rank's window of clause rows: what the engine's clause-sharded stages
(:mod:`repro_torch.core.dtm`), the pod layer
(:mod:`repro_torch.launch.pod`), distributed training
(:mod:`repro_torch.core.distributed`), the scheduler's pod mode and the
compressed reductions (:mod:`repro_torch.runtime.compression`) share.

One process per device (SPMD): every rank of a group calls each of these
in the same order.  The caller starts the process group; nothing here
does.  ``all_gather_into_tensor`` gathers: present in every torch this
runs on (the newest name is not).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

Groups = Union[object, Sequence[object]]


def _groups(groups: Groups) -> tuple:
    return tuple(groups) if isinstance(groups, (list, tuple)) else (groups,)


def all_sum(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """``t`` summed over every rank of each group in turn (JAX's ``psum``
    over one or more axes), a new tensor; ``t`` is left as it was."""
    out = t.clone()
    for g in _groups(groups):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    return out


def all_max(t: torch.Tensor, groups: Groups) -> torch.Tensor:
    """The element-wise maximum of ``t`` over every rank of each group in
    turn (JAX's ``pmax``), a new tensor."""
    out = t.clone()
    for g in _groups(groups):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    return out


def gather_dim(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in group-rank order (JAX's
    ``all_gather`` + reshape, or a ``P(axis)`` output re-assembled)."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank of ``group`` (others
    pass a tensor of the same shape and dtype to receive into)."""
    t = t.contiguous()
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def row_window(rows: int, group, axis: str = "clauses"
               ) -> Tuple[int, int, int]:
    """(shards, row0, r_loc): this rank's window ``[row0, row0 + r_loc)``
    of ``rows`` clause rows split evenly over ``group`` (a mesh axis
    named ``axis``), by its rank in the group."""
    shards = dist.get_world_size(group)
    if rows % shards:
        raise ValueError(f"R={rows} clause rows do not split over {shards} "
                         f"'{axis}' shards")
    r_loc = rows // shards
    return shards, dist.get_rank(group) * r_loc, r_loc
