"""Device meshes over ``torch.distributed`` and the card's hardware model:
the rates and launch limits of one NVIDIA H100.

The mesh constructors are the JAX package's (``make_tenant_mesh``,
``make_clause_mesh``, ``make_host_mesh``, ``make_production_mesh``), each
a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's named
axes over the ranks of the default process group, one rank per device.
The caller initialises that group (``dist.init_process_group`` with an
explicit ``init_method``, world size and rank: ``gloo`` for CPU meshes,
``nccl`` on the cards); a constructor raises when no group is
initialised or when the mesh's size is not the world's.  Meshes are on
the cards (``device_type="cuda"``) unless the caller asks for ``"cpu"``.
:func:`mesh_axis_size`, :func:`mesh_chips` and :func:`data_axes` read a
mesh's shape by axis name.

:data:`H100` is the SXM part at its data-sheet rates;
:meth:`HardwareModel.from_device` fills the SM count, the opt-in shared
memory a block may take, the L2 size and the device memory from
``torch.cuda.get_device_properties`` of a live card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def _device_mesh(shape: Sequence[int], names: Sequence[str],
                 device_type: str):
    """A DeviceMesh of ``shape`` named ``names`` over the default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group(backend, init_method=..., "
                           "world_size=..., rank=...) first")
    size = 1
    for d in shape:
        size *= int(d)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {tuple(shape)} over {names} has {size} "
                         f"devices; the process group has {world} ranks")
    return init_device_mesh(device_type, tuple(int(d) for d in shape),
                            mesh_dim_names=tuple(names))


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod (16, 16) = 256 devices over (data, model), or two, (2, 16,
    16) over (pod, data, model); pod is pure data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """Whatever the group holds: (n // model_axis, model_axis) over
    (data, model)."""
    n = _world()
    return _device_mesh((max(n // model_axis, 1), model_axis),
                        ("data", "model"), device_type)


def make_tenant_mesh(n: Optional[int] = None, device_type: str = "cuda"):
    """1-D serving mesh over a ``tenants`` axis (:mod:`repro_torch.launch.
    pod`: each rank hosts a device-local slice of a stacked bank); ``n``
    defaults to the world size."""
    return _device_mesh((_world() if n is None else n,), ("tenants",),
                        device_type)


def make_clause_mesh(n: Optional[int] = None, device_type: str = "cuda"):
    """1-D mesh over a ``clauses`` axis (one machine's clause rows spread
    over the ranks); ``n`` defaults to the world size."""
    return _device_mesh((_world() if n is None else n,), ("clauses",),
                        device_type)


def mesh_axis_size(mesh, axis: str) -> int:
    """Devices along one named axis."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]


def mesh_chips(mesh) -> int:
    """Devices in the mesh."""
    n = 1
    for d in mesh.shape:
        n *= int(d)
    return n


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh: ``pod`` and ``data``, in order."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Rates and launch limits of one card.

    Rates: ``hbm_bw`` bytes/s of device memory; ``int32_ops`` 32-bit
    integer instructions per clock per SM (add, logic, shift, compare,
    multiply-add on compute capability 9.0) at ``sm_clock_hz`` on ``sms``
    SMs; ``int8_ops_per_s`` the dense int8 tensor-core rate;
    ``b1_mma_per_s`` the m16n8k256 ``.b1`` products a second that
    ``chip_smoke.py`` measures with its ``b1_mma_per_s`` probe, whose warps
    (2 blocks of 8 an SM) each run 8 independent chains of products
    (``b1_probe_chains_per_sm``).  Limits: threads a
    block, the dynamic shared memory a block may opt into, the portable
    and the non-portable cluster size, and the grid's y and z extents.

    ``l2_bytes`` is the L2 cache (50 MiB on the SXM part) and the pod
    planner's per-device budget (:func:`repro_torch.api.plan_for`; the
    JAX planner's is the TPU's VMEM): a train step rereads a program's
    TA plane and include words from the level that holds them, and a
    program that fits L2 is served from it across steps, so one that
    does not is clause-sharded until its window does.  That threshold is
    a premise, not a measurement: no run has yet timed clause sharding
    over NCCL against one card reading the program from HBM.

    ``nvlink_links`` and ``nvlink_link_bw`` (NVLink 4: 18 links at 25 GB/s
    each way, 900 GB/s both ways) are the data sheet's, like ``l2_bytes``:
    one card cannot measure an interconnect, so :meth:`collective_bw` is a
    premise of the shard cost model (``tm_perf.clause_shard_step_s``)."""

    name: str = "NVIDIA H100 80GB HBM3"
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    l2_bytes: int = 50 * 1024 * 1024
    sms: int = 132
    sm_clock_hz: float = 1.98e9
    int32_ops: int = 64
    int8_ops_per_s: float = 1.979e15
    b1_mma_per_s: float = 1.5e11
    b1_probe_chains_per_sm: int = 128
    max_threads_per_block: int = 1024
    smem_per_block_optin: int = 227 * 1024
    max_cluster: int = 8
    max_cluster_nonportable: int = 16
    max_grid_yz: int = 65535
    max_grid_x: int = 2 ** 31 - 1
    nvlink_links: int = 18
    nvlink_link_bw: float = 25e9           # B/s per link, each way

    def collective_bw(self) -> float:
        """The card's NVLink rate available to a collective, each way:
        links × rate (450 GB/s on the H100 SXM)."""
        return self.nvlink_link_bw * self.nvlink_links

    def int32_ops_per_s(self) -> float:
        """32-bit integer instructions a second over the whole card."""
        return self.int32_ops * self.sms * self.sm_clock_hz

    @classmethod
    def from_device(cls, index: int = 0) -> "HardwareModel":
        """The model with the SM count, the opt-in shared memory per block
        and the device memory of card ``index`` (the rates stay the data
        sheet's and the probe's)."""
        import torch
        p = torch.cuda.get_device_properties(index)
        smem = getattr(p, "shared_memory_per_block_optin",
                       cls.smem_per_block_optin)
        return cls(name=p.name, sms=p.multi_processor_count,
                   smem_per_block_optin=int(smem),
                   l2_bytes=int(getattr(p, "L2_cache_size", cls.l2_bytes)),
                   hbm_bytes=float(p.total_memory))


H100 = HardwareModel()
