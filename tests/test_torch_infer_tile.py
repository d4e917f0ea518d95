"""The tensor-core ``packed_clause_tile`` and the streaming ``tm_infer``
against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (decided inside the fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_infer_tile.py

The datapath is integer, so kernel and plain version must agree exactly.
"""
import pytest
import torch

from repro_torch import api  # noqa: F401  (the package before its kernels)
from repro_torch.kernels.clause_eval import (CHUNK, MAX_CHUNKS,
                                             clause_split, sm_count)
from repro_torch.kernels.packed_clause import (packed_clause_tile,
                                               packed_clause_tile_plain,
                                               tile_warps)
from repro_torch.kernels.tm_infer import (prepare_tm_infer, tm_infer,
                                          tm_infer_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _words(gen, shape, density):
    """int32 words whose 32 bits are each set with ``density`` (CPU)."""
    bits = torch.rand((*shape, 32), generator=gen) < density
    w = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _tile_operands(K, B, R, W, seed):
    """Literals and include words with all-zero include rows, all-ones
    literal rows and include rows whose only bits lie past n_bits."""
    gen = torch.Generator().manual_seed(seed)
    lit = _words(gen, (K, B, W), 0.8)
    inc = _words(gen, (K, R, W), 1.5 / (32 * W))
    inc[:, ::7] = 0                       # empty rows: the eval-mode gate
    lit[:, ::4] = -1                      # all-ones literal rows
    inc[:, 3::11] = 0
    inc[:, 3::11, -1] = -(1 << 28)        # only bits 28..31 of the last word
    return lit, inc


TILE_W = [1, 7, 8, 9, 52, 100, 129]
TILE_R = [1, 63, 65, 4224 + 17]
TILE_KB = [(1, 5), (3, 31), (1, 32), (3, 33), (1, 64)]


@pytest.mark.parametrize("W", TILE_W)
@pytest.mark.parametrize("R", TILE_R)
def test_packed_clause_tile_edges(dev, W, R):
    """Every k-step tail (W), clause-tile edges (R: 1, 2 or 4 warps a
    block at the large R), batch-tile edges (B), K, both modes and both
    n_bits: the tile equals its plain version exactly."""
    warps = set()
    for K, B in TILE_KB:
        lit, inc = _tile_operands(K, B, R, W, W * 1000 + R + B)
        lit, inc = lit.to(dev), inc.to(dev)
        warps.add(tile_warps(K, B, R, sm_count(0)))
        for n_bits in (32 * W - 5, 32 * W):
            for eval_mode in (False, True):
                want = packed_clause_tile_plain(lit, inc, eval_mode, n_bits)
                got = packed_clause_tile(lit, inc, eval_mode, n_bits)
                torch.cuda.synchronize()
                assert got.dtype == torch.int32
                assert torch.equal(got, want), (K, B, n_bits, eval_mode)
                if R > 1 and n_bits < 32 * W:
                    assert 0 < int(want.sum()) < want.numel()
    if R > 4096:
        assert warps == {1, 2, 4}


@pytest.mark.parametrize("W", [8, 100, 129])
def test_packed_clause_tile_strided_and_unaligned(dev, W):
    """A stride-0 program axis, a program stride that is not a multiple of
    4 words and a base one word off 16-byte alignment all take the right
    copies and give the plain result."""
    K, B, R = 3, 33, 300
    lit, inc = _tile_operands(1, B, R, W, W)
    lit, inc = lit.to(dev), inc.to(dev)
    n_bits = 32 * W - 5
    want = packed_clause_tile_plain(lit.expand(K, -1, -1),
                                    inc.expand(K, -1, -1), True, n_bits)
    assert torch.equal(packed_clause_tile(lit.expand(K, -1, -1),
                                          inc.expand(K, -1, -1), True,
                                          n_bits), want)
    flat = torch.zeros(K * (R * W + 1), dtype=torch.int32, device=dev)
    odd = flat.as_strided((K, R, W), (R * W + 1, W, 1))   # aligned base
    odd.copy_(inc.expand(K, -1, -1))
    lits = torch.zeros(K * (B * W + 1) + 1, dtype=torch.int32, device=dev)
    lodd = lits[1:].as_strided((K, B, W), (B * W + 1, W, 1))
    lodd.copy_(lit.expand(K, -1, -1))
    for l_, i_ in ((lodd, odd), (lit.expand(K, -1, -1), odd),
                   (lodd, inc.expand(K, -1, -1))):
        assert torch.equal(packed_clause_tile(l_, i_, True, n_bits), want)


def _dense(K, B, C, L, seed):
    """int8 literals and include, bytes other than 0 and 1, empty rows and
    clauses that fire."""
    gen = torch.Generator().manual_seed(seed)
    lit = torch.randint(-128, 128, (K, B, L), generator=gen,
                        dtype=torch.int8)
    lit[torch.rand((K, B, L), generator=gen) < 0.3] = 0
    inc = torch.randint(-128, 128, (K, C, L), generator=gen,
                        dtype=torch.int8)
    inc[torch.rand((K, C, L), generator=gen) < 1 - 2.0 / L] = 0
    inc[:, ::5] = 0                        # empty rows
    inc[:, 1::6] = 0
    inc[:, 1::6, -1] = 9                   # one-literal clauses at the end
    lit[:, ::3, -1] = 1
    return lit, inc


TMI_L = [16, 100, 3200, 65536 + 128]
TMI_H = [1, 16, 17, 40]


@pytest.mark.parametrize("L", TMI_L)
@pytest.mark.parametrize("H", TMI_H)
def test_tm_infer_edges(dev, L, H):
    """One chunk (16), the byte path (100), literal splits (3200) and
    ranges past 64 Ki literals; H in passes of 16; ragged C; B of 1 and
    33; K=4, both modes, negative weights; a view one byte off 16-byte
    alignment."""
    K, C = 4, 300
    splits, cps = clause_split(K, 33, C, L, sm_count(0))
    if L > 65536:
        assert cps > MAX_CHUNKS
    if L == 3200:
        assert splits > 1
    for B in (1, 33):
        lit, inc = _dense(K, B, C, L, L + H + B)
        gen = torch.Generator().manual_seed(H)
        w = torch.randint(-2047, 2048, (K, H, C), generator=gen,
                          dtype=torch.int32)
        lit, inc, w = lit.to(dev), inc.to(dev), w.to(dev)
        for eval_mode in (False, True):
            want = tm_infer_plain(lit, inc, w, eval_mode)
            got = tm_infer(lit, inc, w, eval_mode)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32
            assert torch.equal(got, want), (B, eval_mode)
        assert int(want.abs().sum()) > 0
        base = torch.zeros(lit.numel() + 1, dtype=torch.int8, device=dev)
        base[1:] = lit.reshape(-1)
        assert torch.equal(tm_infer(base[1:].view(lit.shape), inc, w, True),
                           tm_infer_plain(lit, inc, w, True))


def test_tm_infer_many_clusters_back_to_back(dev):
    """Several clusters per SM launched back to back on one stream: every
    launch gives the plain sums."""
    K, B, C, L, H = 3, 40, 600, 1664, 17
    assert clause_split(K, B, C, L, sm_count(0))[0] > 1
    lit, inc = _dense(K, B, C, L, 5)
    w = torch.randint(-9, 10, (K, H, C), generator=torch.Generator()
                      .manual_seed(1), dtype=torch.int32)
    lit, inc, w = lit.to(dev), inc.to(dev), w.to(dev)
    want = tm_infer_plain(lit, inc, w, True)
    outs = [tm_infer(lit, inc, w, True) for _ in range(64)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def test_prepare_tm_infer_is_the_bare_launch(dev):
    lit, inc = _dense(2, 33, 130, CHUNK * 3 + 5, 3)
    w = torch.randint(-9, 10, (2, 17, 130), generator=torch.Generator()
                      .manual_seed(2), dtype=torch.int32)
    lit, inc, w = lit.to(dev), inc.to(dev), w.to(dev)
    want = tm_infer(lit, inc, w, False)
    before = tm_infer.launches
    launch, got = prepare_tm_infer(lit, inc, w, False)
    assert tm_infer.launches == before and not bool(got.any())
    launch()
    torch.cuda.synchronize()
    assert tm_infer.launches == before + 1
    assert torch.equal(got, want)
