"""AdamW with a configurable moment dtype and global-norm clipping, the
JAX package's ``optim/adam.py`` in PyTorch.

* moments in float32 (default), bfloat16, or int8 with a per-tensor
  absmax scale (4× smaller state);
* ZeRO-1 sharding as specs: :func:`zero_pspecs` gives each moment its
  parameter's spec plus the ``data`` axis on the largest still-unsharded
  dimension that the axis divides.

Trees are nested dicts, lists and tuples of tensors
(:mod:`repro_torch.core.tree`, JAX's leaf order).  A spec is a tuple of
axis names (a name, a tuple of names, or ``None`` per dimension), equal
element by element to ``tuple(PartitionSpec)`` of the JAX package's.
Every tensor follows the device of the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import tree as tree_lib

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamState(NamedTuple):
    """``m_scale``/``v_scale``: per-tensor scales of int8 moments; zeros
    from :func:`init`, and ``None`` at every leaf after a step of float
    moments, as in the JAX package."""

    step: torch.Tensor
    m: Any
    v: Any
    m_scale: Any
    v_scale: Any


def _q_store(x: torch.Tensor, dtype: str):
    """A float32 moment -> (stored moment, float32 scale or None)."""
    if dtype != "int8":
        return x.to(_DTYPES[dtype]), None
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _q_load(q: torch.Tensor, scale, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return q.to(torch.float32) * scale
    return q.to(torch.float32)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def _device(params) -> torch.device:
    leaves = tree_lib.leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init(cfg: AdamWConfig, params) -> AdamState:
    if cfg.state_dtype not in _DTYPES:
        raise ValueError(f"state_dtype={cfg.state_dtype!r}; use one of "
                         f"{tuple(_DTYPES)}")
    dt = _DTYPES[cfg.state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def zero_scale(p):
        # always a 0-d leaf, so every state tree has the params' structure
        return torch.zeros((), dtype=torch.float32, device=p.device)

    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=tree_lib.map(zeros, params), v=tree_lib.map(zeros, params),
        m_scale=tree_lib.map(zero_scale, params),
        v_scale=tree_lib.map(zero_scale, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    total = 0
    for g in tree_lib.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply(cfg: AdamWConfig, params, grads, state: AdamState
          ) -> Tuple[Any, AdamState, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m_q, v_q, ms, vs):
        g = g.to(torch.float32) * scale
        m = _q_load(m_q, ms, cfg.state_dtype)
        v = _q_load(v_q, vs, cfg.state_dtype)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * u).to(p.dtype)
        m_q2, ms2 = _q_store(m, cfg.state_dtype)
        v_q2, vs2 = _q_store(v, cfg.state_dtype)
        return new_p, m_q2, v_q2, ms2, vs2

    flat_p, td = tree_lib.flatten(params)
    rest = [tree_lib.flatten_up_to(td, t) for t in (
        grads, state.m, state.v, state.m_scale, state.v_scale)]
    out = [upd(*args) for args in zip(flat_p, *rest)]

    def tree_of(i):
        return tree_lib.unflatten(td, [o[i] for o in out])
    return tree_of(0), AdamState(step, tree_of(1), tree_of(2), tree_of(3),
                                 tree_of(4)), {"grad_norm": gnorm, "lr": lr}


def zero_pspecs(param_specs, mesh, param_shapes) -> Any:
    """ZeRO-1: each moment takes its parameter's spec plus ``data`` on
    the largest still-unsharded dimension that the ``data`` axis divides.
    ``param_shapes`` is the params tree (tensors, or anything with a
    ``shape``); ``param_specs`` holds a spec at each of its leaves.  A
    mesh without a ``data`` axis counts it as size 1, as JAX's does."""
    from repro_torch.launch.mesh import mesh_axis_size
    dd = (mesh_axis_size(mesh, "data") if "data" in mesh.mesh_dim_names
          else 1)

    def shard_more(spec: tuple, shape) -> tuple:
        shp = tuple(shape.shape)
        used = set(a for a in spec if a)
        if "data" in used or not shp:
            return tuple(spec)
        dims = list(spec) + [None] * (len(shp) - len(spec))
        for i in sorted(range(len(dims)), key=lambda i: -shp[i]):
            if dims[i] is None and shp[i] % dd == 0 and shp[i] >= dd:
                dims[i] = "data"
                break
        return tuple(dims)

    flat_shapes, td = tree_lib.flatten(param_shapes)
    specs = tree_lib.flatten_up_to(td, param_specs)
    return tree_lib.unflatten(td, [shard_more(s, p) for s, p in
                                   zip(specs, flat_shapes)])


def state_pspecs(cfg: AdamWConfig, param_specs, mesh, param_shapes
                 ) -> AdamState:
    """The specs of an :class:`AdamState`: moments by :func:`zero_pspecs`,
    the step and the scales replicated (``()``)."""
    mom = zero_pspecs(param_specs, mesh, param_shapes)
    _, td = tree_lib.flatten(param_shapes)
    scale = tree_lib.unflatten(td, [()] * td.num_leaves)
    return AdamState(step=(), m=mom, v=mom, m_scale=scale, v_scale=scale)
