"""Launch geometry of the cluster kernels ``fused_step`` and ``class_sum``,
of the tensor-core ``packed_clause_tile`` and of the edge kernel
``packed_clause_eval`` (CPU: pure functions of the shapes).

Each clause row belongs to exactly one block of a cluster, a cluster has
at most 16 blocks, and the main path's shapes put enough blocks in flight.
The card tests (``test_torch_cuda.py``) hold the kernels themselves
against their plain versions.
"""
import pytest

from repro_torch import api  # noqa: F401  (the package before its kernels)
from repro_torch.kernels import class_sum as cs_mod
from repro_torch.kernels import fused_step as fs_mod
from repro_torch.kernels import packed_clause as pc_mod

SHAPES = [(1, 1, 1), (1, 1, 17), (1, 5, 300), (3, 33, 4224), (4, 32, 4224),
          (1, 32, 2048), (1, 1, 4224), (2, 7, 4101), (1, 1, 100000)]


@pytest.mark.parametrize("K,B,R", SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_class_sum_split_covers_every_clause_once(K, B, R, sms):
    rows, cs, span = cs_mod.class_sum_split(K, B, R, sms)
    assert rows == (1 if B == 1 else cs_mod.ROWS)
    assert 1 <= cs <= cs_mod.MAX_CLUSTER and span % 4 == 0 and span >= 4
    owner = [r // span for r in range(R)]
    assert owner[-1] == cs - 1 and all(0 <= o < cs for o in owner)


@pytest.mark.parametrize("K,B,R,blocks", [(4, 32, 4224, 264),
                                          (1, 32, 2048, 128),
                                          (1, 1, 4224, 16), (1, 1, 2048, 16)])
def test_class_sum_split_fills_the_card_on_the_main_path(K, B, R, blocks):
    """Serving bank, mxu fit and edge: about two blocks an SM where the
    clause axis allows it, each block at least MIN_SPAN clauses."""
    rows, cs, span = cs_mod.class_sum_split(K, B, R, 132)
    assert K * -(-B // rows) * cs >= blocks
    assert span >= min(R, cs_mod.MIN_SPAN)


@pytest.mark.parametrize("R", [1, 17, 255, 256, 257, 2048, 4096, 4224,
                               100000])
def test_fused_split_gives_every_block_a_tile(R):
    cs = fs_mod.fused_split(R)
    tiles = -(-R // fs_mod.TILE)
    assert 1 <= cs <= min(tiles, fs_mod.MAX_CLUSTER)
    owned = sorted(t for q in range(cs) for t in range(q, tiles, cs))
    assert owned == list(range(tiles))


def test_fused_split_at_the_training_shape():
    """MNIST CoTM (R=2048): 8 blocks of 256 clause rows, one cluster per
    tile of 4 batch rows, so B=32 runs 64 blocks."""
    assert fs_mod.fused_split(2048) == 8
    assert fs_mod.ROWS == 4 and fs_mod.TILE == 256


@pytest.mark.parametrize("W,R,aligned,fits,bulk", [
    (52, 2048, True, True, True), (100, 4224, True, True, True),
    (256, 2048, True, False, False), (101, 2048, True, True, False),
    (52, 2047, True, True, False), (52, 2048, False, True, False)])
def test_fused_bulk_copies_only_aligned_rows_that_fit(W, R, aligned, fits,
                                                      bulk):
    smem = fs_mod.SMEM_LIMIT + (0 if fits else 1)
    assert fs_mod.fused_bulk(W, R, aligned, smem) == bulk


@pytest.mark.parametrize("K,B,R", SHAPES + [(1, 8, 4224)])
@pytest.mark.parametrize("sms", [1, 132])
def test_tile_warps_covers_every_clause_once(K, B, R, sms):
    """1, 2 or 4 warps of 16 clause rows a block; the tallest tile that
    still gives two blocks an SM; every clause row in exactly one block;
    the grid within its limits."""
    warps = pc_mod.tile_warps(K, B, R, sms)
    assert warps in (1, 2, pc_mod.MAX_WARPS)
    rows = pc_mod.MMA_ROWS * warps
    blocks = -(-R // rows)
    owner = [r // rows for r in range(R)]
    assert owner[-1] == blocks - 1 and all(0 <= o < blocks for o in owner)
    assert blocks < 2 ** 31 and -(-B // pc_mod.TILE_B) <= 65535
    tiles = K * -(-B // pc_mod.TILE_B)
    if warps > 1:
        assert tiles * blocks >= pc_mod.BLOCKS_PER_SM * sms
    if warps < pc_mod.MAX_WARPS:
        assert tiles * -(-R // (2 * rows)) < pc_mod.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("K,B,R,warps,blocks", [(4, 32, 4224, 4, 264),
                                                (1, 8, 4224, 1, 264),
                                                (1, 32, 2048, 1, 128)])
def test_tile_warps_fills_the_card_on_the_main_path(K, B, R, warps, blocks):
    """The serving bank, one program's batch of 8 and the MNIST widths."""
    assert pc_mod.tile_warps(K, B, R, 132) == warps
    rows = pc_mod.MMA_ROWS * warps
    assert K * -(-B // pc_mod.TILE_B) * -(-R // rows) == blocks


EDGE_R = [1, 31, 33, 2048, 4224, 4241, 100000]


@pytest.mark.parametrize("W", [1, 3, 4, 13, 52, 100, 3100])
@pytest.mark.parametrize("sms", [1, 132])
def test_edge_geometry_covers_every_row_once(W, sms):
    """For B = 1..8 and several R: lanes a power of two reading every
    16-byte chunk of a row, at most EDGE_CHUNKS a lane unless the row takes
    passes at 32 lanes, and no fewer lanes would do; every clause row in
    exactly one (block, warp, lane group), every batch row in exactly one
    group of at most EDGE_ROWS; the grid within its limits; fewer warps a
    block only where more would leave SMs idle."""
    chunks = -(-W // 4)
    for B in range(1, 9):
        for R in EDGE_R:
            lanes, rpw, warps, (gx, gy) = pc_mod.edge_geometry(B, R, W, sms)
            assert lanes in (1, 2, 4, 8, 16, 32) and rpw == 32 // lanes
            assert 1 <= warps <= pc_mod.EDGE_MAX_WARPS
            per_lane = -(-chunks // lanes)
            assert per_lane <= pc_mod.EDGE_CHUNKS or lanes == 32
            if lanes > 1:           # no fewer lanes would do
                assert -(-chunks // (lanes // 2)) > pc_mod.EDGE_CHUNKS
            rows = rpw * warps
            owner = [r // rows for r in range(R)]
            assert owner[-1] == gx - 1 and gx * rows >= R > (gx - 1) * rows
            groups = [b // pc_mod.EDGE_ROWS for b in range(B)]
            assert groups[-1] == gy - 1 and gy <= 65535
            assert gx < 2 ** 31
            if warps < pc_mod.EDGE_MAX_WARPS:
                assert gy * -(-R // (rpw * 2 * warps)) < sms


@pytest.mark.parametrize("B,R,W,geometry", [
    (1, 4224, 100, (8, 4, 4, (264, 1))),     # serving edge request
    (4, 4224, 100, (8, 4, 4, (264, 1))),     # four requests of one tenant
    (1, 2048, 52, (4, 8, 1, (256, 1))),      # edge training (partial_fit)
    (5, 2048, 52, (4, 8, 2, (128, 2))),      # a direct call past B = 4
    (1, 4224, 3100, (32, 1, 4, (1056, 1)))])  # past the old width limit
def test_edge_geometry_at_the_main_path(B, R, W, geometry):
    """One wave over the 132 SMs at the edge shapes: 8 lanes a row at
    W=100 (25 chunks, 7 idle lane slots of 32), 4 at W=52 (13 chunks, 3
    idle of 16)."""
    assert pc_mod.edge_geometry(B, R, W, 132) == geometry
