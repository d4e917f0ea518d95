"""The edge clause kernel ``packed_clause_eval`` against its plain version,
on the card.

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (decided inside the fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_edge.py

The datapath is integer, so kernel and plain version must agree exactly.
The cases cover every lane count of ``edge_geometry`` (W 1 to 3100, past
the 3072 words the earlier kernel refused), ragged clause blocks (R), one
to three batch groups with a ragged last group (B), K programs, both
``n_bits`` and both modes, and the 4-byte load path (odd W, odd program
strides, unaligned bases, a stride-0 program axis).
"""
import pytest
import torch

from repro_torch import api  # noqa: F401  (the package before its kernels)
from repro_torch.kernels.clause_eval import sm_count
from repro_torch.kernels.packed_clause import (edge_geometry,
                                               packed_clause_eval,
                                               packed_clause_eval_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _edge_operands(K, B, R, W, seed, dev):
    """Literal words with about 3/4 of their bits set, the first batch row
    all ones; include rows of about 1.5 set bits, every 7th row empty, row
    0 holding bit 0 (so clause (0, 0) fires in both modes), and every 11th
    row holding only bits 28..31 of its last word (empty at 32 W - 5)."""
    gen = torch.Generator().manual_seed(seed)
    full = (-2 ** 31, 2 ** 31)
    lit = (torch.randint(*full, (K, B, W), generator=gen, dtype=torch.int32)
           | torch.randint(*full, (K, B, W), generator=gen,
                           dtype=torch.int32))
    lit[:, 0] = -1
    hit = torch.rand((K, R, W), generator=gen) < 1.5 / W
    bit = torch.randint(0, 32, (K, R, W), generator=gen, dtype=torch.int64)
    inc = torch.where(hit, torch.ones_like(bit) << bit, 0)
    inc = torch.where(inc >= 2 ** 31, inc - 2 ** 32, inc).to(torch.int32)
    inc[:, 5::7] = 0
    inc[:, 3::11] = 0
    inc[:, 3::11, -1] = -(1 << 28)
    inc[:, 0, 0] |= 1
    return lit.to(dev), inc.to(dev)


EDGE_W = [1, 3, 13, 52, 100, 101, 3100]
EDGE_R = [1, 31, 33, 2048, 4224 + 17]


@pytest.mark.parametrize("W", EDGE_W)
@pytest.mark.parametrize("R", EDGE_R)
def test_packed_clause_eval_edges(dev, W, R):
    """Each (K, B, n_bits, mode) case equals the plain version exactly and
    fires some of its clauses."""
    lanes = set()
    for K in (1, 3):
        for B in (1, 2, 3, 4, 5, 9):
            lit, inc = _edge_operands(K, B, R, W, W * 1000 + R + 10 * B + K,
                                      dev)
            lanes.add(edge_geometry(B, R, W, sm_count(0))[0])
            for n_bits in (32 * W, 32 * W - 5):
                for eval_mode in (False, True):
                    want = packed_clause_eval_plain(lit, inc, eval_mode,
                                                    n_bits)
                    got = packed_clause_eval(lit, inc, eval_mode, n_bits)
                    torch.cuda.synchronize()
                    assert got.dtype == torch.int32 and got.is_cuda
                    assert torch.equal(got, want), (K, B, n_bits, eval_mode)
                    assert int(want.sum()) > 0
    if W == 3100:
        assert lanes == {32}


@pytest.mark.parametrize("W", [8, 13, 100])
def test_packed_clause_eval_strided_and_unaligned(dev, W):
    """A stride-0 program axis, program strides that are not a multiple of
    4 words and bases one word off 16-byte alignment, for the literal and
    the include, each give the plain result."""
    K, B, R = 3, 5, 300
    lit, inc = _edge_operands(1, B, R, W, W, dev)
    n_bits = 32 * W - 5
    want = packed_clause_eval_plain(lit.expand(K, -1, -1),
                                    inc.expand(K, -1, -1), True, n_bits)
    assert torch.equal(packed_clause_eval(lit.expand(K, -1, -1),
                                          inc.expand(K, -1, -1), True,
                                          n_bits), want)
    flat = torch.zeros(K * (R * W + 1), dtype=torch.int32, device=dev)
    iodd = flat.as_strided((K, R, W), (R * W + 1, W, 1))   # odd stride
    iodd.copy_(inc.expand(K, -1, -1))
    base = torch.zeros(K * R * W + 1, dtype=torch.int32, device=dev)
    ishift = base[1:].view(K, R, W)                         # base off by 1
    ishift.copy_(inc.expand(K, -1, -1))
    lits = torch.zeros(K * (B * W + 1) + 1, dtype=torch.int32, device=dev)
    lodd = lits[1:].as_strided((K, B, W), (B * W + 1, W, 1))
    lodd.copy_(lit.expand(K, -1, -1))
    lcont = lit.expand(K, -1, -1).contiguous()
    for l_, i_ in ((lodd, iodd), (lcont, iodd), (lodd, inc.expand(K, -1, -1)),
                   (lcont, ishift), (lodd, ishift)):
        assert torch.equal(packed_clause_eval(l_, i_, True, n_bits), want)


def test_packed_clause_eval_takes_rows_past_the_old_width_limit(dev):
    """W = 3100 words (99,200 literals) at the serving clause count, B = 1:
    the earlier kernel's shared literal rows refused W > 3072."""
    lit, inc = _edge_operands(1, 1, 4224, 3100, 1, dev)
    before = packed_clause_eval.launches
    got = packed_clause_eval(lit, inc, True, 32 * 3100 - 16)
    torch.cuda.synchronize()
    assert packed_clause_eval.launches == before + 1
    assert torch.equal(got, packed_clause_eval_plain(lit, inc, True,
                                                     32 * 3100 - 16))


def test_packed_clause_eval_many_launches_back_to_back(dev):
    """The serving and training edge shapes, 64 launches each on one
    stream: every launch gives the plain clauses."""
    for B, R, W in ((1, 4224, 100), (4, 4224, 100), (1, 2048, 52)):
        lit, inc = _edge_operands(1, B, R, W, R + W, dev)
        want = packed_clause_eval_plain(lit, inc, True, 32 * W - 16)
        outs = [packed_clause_eval(lit, inc, True, 32 * W - 16)
                for _ in range(64)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)
