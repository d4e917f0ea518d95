"""The port's H100 cost model against the JAX package's v5e one (CPU).

The byte counts are facts of the layouts, so they equal the JAX model's
wherever the layouts agree; the seconds are each card's own.  The
program bytes are the port's own layout (``DTMProgram.nbytes``).  The
eval model's ``winner`` crosses from the edge kernel to the tile kernel
once as the batch grows.
"""
import pytest

from repro.launch import tm_perf as jperf
from repro_torch import api as tapi
from repro_torch.core import threefry
from repro_torch.core.types import TileConfig
from repro_torch.launch import mesh, tm_perf

SHAPES = ((256, 128, 4), (1024, 512, 16), (1664, 2048, 16),
          (2048, 2048, 16), (3200, 4224, 16))          # L, C, H
BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


@pytest.mark.parametrize("L,C,H", SHAPES)
def test_byte_counts_equal_jax(L, C, H):
    for B in BATCHES:
        for packed in (False, True):
            assert tm_perf.clause_eval_bytes(B, L, C, packed) == \
                jperf.clause_eval_bytes(B, L, C, packed)
        mine, theirs = tm_perf.train_front_costs(B, L, C, H), \
            jperf.train_front_costs(B, L, C, H)
        for k in ("flops", "unfused_bytes", "fused_bytes"):
            assert mine[k] == theirs[k], k
        assert tm_perf.packed_eval_costs(B, L, C)["bytes"] == \
            jperf.packed_eval_costs(B, L, C)["bytes"]
        assert tm_perf.ta_rand_bytes(B, L, C)["streamed_rand_bytes"] == \
            jperf.ta_rand_bytes(B, L, C)["streamed_rand_bytes"]


@pytest.mark.parametrize("L,C,H", SHAPES)
def test_winner_crosses_once_as_the_batch_grows(L, C, H):
    winners = [tm_perf.packed_eval_costs(B, L, C)["winner"]
               for B in range(1, 8193)]
    flips = [B for B in range(2, 8193) if winners[B - 1] != winners[B - 2]]
    assert winners[0] == "packed_vpu"
    if L < 1024:
        # 8 words a row: the edge kernel's work stays under the bytes of
        # the clause matrix it writes, so both legs tie on bytes
        assert flips == []
    else:
        assert len(flips) == 1 and winners[-1] == "mxu_popcount", flips


def test_seconds_are_the_cards():
    hw = mesh.H100
    assert hw.int32_ops_per_s() == 64 * 132 * 1.98e9
    c = tm_perf.packed_eval_costs(1, 3200, 4224)
    assert c["vpu_s"] == c["bytes"] / 3.35e12        # bound by its bytes
    assert tm_perf.roofline_s(0, 3.35e12) == 1.0
    assert tm_perf.roofline_s(hw.int32_ops_per_s(), 0) == 1.0
    half = mesh.HardwareModel(hbm_bw=hw.hbm_bw / 2)
    assert tm_perf.roofline_s(0, 3.35e12, half) == 2.0
    # the tile's chains: full occupancy only with enough n-tiles
    assert tm_perf.packed_eval_costs(8, 3200, 4224)["occupancy"] < 1
    assert tm_perf.packed_eval_costs(4096, 3200, 4224)["occupancy"] == 1


@pytest.mark.parametrize("features,clauses,classes", [(21, 48, 4),
                                                      (300, 200, 10)])
def test_program_bytes_is_the_ports_program(features, clauses, classes):
    spec = tapi.TMSpec.coalesced(features=features, classes=classes,
                                 clauses=clauses, T=8)
    eng = tapi.compile(tapi.tile_for(spec), device="cpu")
    prog = eng.lower(spec, threefry.key(0, "cpu"))
    assert prog.nbytes == tm_perf.program_bytes(eng.L, eng.R, eng.H,
                                                P=eng.P)


def test_hardware_model_limits():
    hw = mesh.H100
    assert (hw.max_threads_per_block, hw.smem_per_block_optin,
            hw.max_cluster, hw.max_cluster_nonportable,
            hw.max_grid_yz) == (1024, 227 * 1024, 8, 16, 65535)
    assert hw.sms == 132 and hw.b1_mma_per_s == 1.5e11
    assert isinstance(TileConfig().padded_dims(), tuple)


@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("L,C,H", SHAPES)
def test_clause_shard_step_is_jaxs_formula_on_the_cards_rates(
        L, C, H, shards, monkeypatch):
    """JAX's ``clause_shard_step_s`` with its v5e collective rate swapped
    for the H100's NVLink rate and its ``train_front_costs`` for the
    port's gives the port's numbers, key for key."""
    assert mesh.H100.collective_bw() == 18 * 25e9
    monkeypatch.setattr(jperf, "train_front_costs",
                        lambda B, L, C, H: tm_perf.train_front_costs(
                            B, L, C, H))
    monkeypatch.setattr(jperf, "V5E", mesh.H100)   # for its collective_bw
    for B in (1, 32, 1024):
        mine = tm_perf.clause_shard_step_s(B, L, C, H, shards)
        theirs = jperf.clause_shard_step_s(B, L, C, H, shards)
        assert set(mine) == set(theirs) == {"local_s", "psum_bytes",
                                            "ici_s", "step_s"}
        assert mine == theirs
        if shards == 1:
            assert mine["ici_s"] == 0 and mine["psum_bytes"] == 0
        else:
            assert mine["psum_bytes"] == 2 * (shards - 1) / shards * B * H * 4
