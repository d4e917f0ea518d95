"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (decided inside the fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The datapath is integer, so kernel and plain version must agree exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import ops
from repro_torch.kernels.class_sum import class_sum, class_sum_plain
from repro_torch.kernels.packed_clause import (packed_clause_eval,
                                               packed_clause_eval_plain,
                                               packed_clause_tile,
                                               packed_clause_tile_plain)
from repro_torch.launch.serve_tm import TMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _words(gen, shape, density, dev):
    """int32 words whose 32 bits are each set with ``density``."""
    bits = torch.rand((*shape, 32), generator=gen) < density
    w = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32).to(dev)


def _operands(K, B, R, W, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lit = _words(gen, (K, B, W), 0.75, dev)
    inc = _words(gen, (K, R, W), 0.01, dev)
    inc[:, ::7] = 0                      # empty clauses: the eval-mode gate
    return lit, inc


SHAPES = [(1, 1, 1, 1), (1, 3, 17, 2), (2, 4, 130, 5), (3, 5, 33, 4),
          (2, 32, 200, 101), (1, 33, 65, 8), (4, 7, 64, 100)]


@pytest.mark.parametrize("K,B,R,W", SHAPES)
@pytest.mark.parametrize("eval_mode", [False, True])
def test_clause_kernels_match_plain(dev, K, B, R, W, eval_mode):
    lit, inc = _operands(K, B, R, W, dev, seed=K * B + R)
    for n_bits in (32 * W, 32 * W - 5 if W > 1 else 20):
        want = packed_clause_eval_plain(lit, inc, eval_mode, n_bits)
        assert torch.equal(want, packed_clause_tile_plain(lit, inc, eval_mode,
                                                          n_bits))
        for fn in (packed_clause_eval, packed_clause_tile):
            got = fn(lit, inc, eval_mode, n_bits)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want), (fn.__name__, n_bits)


def test_clause_kernels_take_strided_and_unaligned_operands(dev):
    lit, inc = _operands(1, 3, 50, 8, dev, seed=3)
    want = packed_clause_eval_plain(lit.expand(3, -1, -1),
                                    inc.expand(3, -1, -1), True)
    for fn in (packed_clause_eval, packed_clause_tile):
        got = fn(lit.expand(3, -1, -1), inc.expand(3, -1, -1), True)
        assert torch.equal(got, want), fn.__name__
    # an include view one word off 16-byte alignment takes the scalar loads
    base = torch.zeros(inc.numel() + 1, dtype=torch.int32, device=dev)
    base[1:] = inc.reshape(-1)
    shifted = base[1:].view(inc.shape)
    for fn in (packed_clause_eval, packed_clause_tile):
        assert torch.equal(fn(lit, shifted, True),
                           packed_clause_eval_plain(lit, inc, True))


@pytest.mark.parametrize("K,B,R,H", [(1, 1, 1, 1), (1, 3, 300, 4),
                                     (4, 32, 4224, 16), (2, 5, 77, 19),
                                     (3, 9, 130, 33)])
def test_class_sum_kernel_matches_plain(dev, K, B, R, H):
    gen = torch.Generator().manual_seed(K + B + R + H)
    cl = torch.randint(0, 2, (K, B, R), generator=gen,
                       dtype=torch.int32).to(dev)
    w = torch.randint(-2047, 2048, (K, H, R), generator=gen,
                      dtype=torch.int32).to(dev)
    got = class_sum(cl, w)
    torch.cuda.synchronize()
    assert torch.equal(got, class_sum_plain(cl, w))


def test_wrappers_count_launches_and_never_fall_back(dev):
    ops.reset_launch_counts()
    lit, inc = _operands(1, 2, 40, 3, dev)
    ops.packed_clause_eval_op(lit[0], inc[0], eval_mode=True)
    ops.packed_clause_mxu_op(lit, inc, eval_mode=True)
    ops.class_sum_op(torch.ones((2, 40), dtype=torch.int32, device=dev),
                     torch.ones((3, 40), dtype=torch.int32, device=dev))
    assert ops.launch_counts() == {"packed_clause_eval": 1,
                                   "packed_clause_tile": 1, "class_sum": 1}
    with pytest.raises(ValueError):
        packed_clause_eval(lit, inc.cpu())
    with pytest.raises(TypeError):
        class_sum(lit.to(torch.int64), inc)


def test_server_on_card_matches_cpu(dev):
    roster = {"a": api.TMSpec.coalesced(features=40, classes=5, clauses=64),
              "b": api.TMSpec.vanilla(features=33, classes=3, clauses=10),
              "c": api.TMSpec.regression(features=40, clauses=30, T=20)}
    tile = api.tile_for(*roster.values())
    rng = np.random.default_rng(0)
    servers = {}
    for device in ("cpu", "cuda"):
        for slot in (2, 16):
            eng = api.compile(tile, device=device)
            srv = TMServer(eng, batch_slot=slot)
            for i, (name, spec) in enumerate(roster.items()):
                cfg = spec.tm_config()
                ta = np.random.default_rng(i).integers(
                    0, 128, (cfg.total_clauses, cfg.literals))
                ta[:, :2] = 200                     # two includes per row
                w = None if spec.kind != "coalesced" else np.random.default_rng(
                    i).integers(-3, 4, (cfg.classes, cfg.clauses))
                srv.register(name, spec,
                             program=eng.lower(spec, ta=ta, weights=w))
            servers[device, slot] = srv
    xs = {n: (rng.random((16, s.features)) < 0.5).astype(np.int8)
          for n, s in roster.items()}
    for slot in (2, 16):
        outs = []
        for device in ("cpu", "cuda"):
            srv = servers[device, slot]
            for n, x in xs.items():
                srv.enqueue(n, x[:slot])
            outs.append(srv.flush())
            outs.append({n: srv.predict(n, x[:slot]) for n, x in xs.items()})
        for a, b in ((outs[0], outs[2]), (outs[1], outs[3])):
            for n in roster:
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)
