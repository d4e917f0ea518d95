"""The card's hardware model: the rates and launch limits of one NVIDIA H100.

The JAX package's ``launch/mesh.py`` builds device meshes and holds the
TPU v5e constants its roofline and pod planner read.  Only the model is
ported here, with the H100's own figures; the mesh functions belong to
the pod layer, which is not ported.  :data:`H100` is the SXM part at its
data-sheet rates; :meth:`HardwareModel.from_device` fills the SM count,
the opt-in shared memory a block may take and the device memory from
``torch.cuda.get_device_properties`` of a live card.
"""
from __future__ import annotations

import dataclasses


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
    and the non-portable cluster size, and the grid's y and z extents."""

    name: str = "NVIDIA H100 80GB HBM3"
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
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
                   hbm_bytes=float(p.total_memory))


H100 = HardwareModel()
