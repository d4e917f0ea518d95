"""The conv step's TA stage kernels against their plain version, on the card.

``conv_patch_pick`` and ``conv_ta_update`` (``csrc/conv_ta.cu``, one
wrapper call) must equal ``conv_ta_update_plain`` bit for bit, new TA
states and include words: at the conv cell's step (K=1, B=32, P=361,
R=2048, L=384, W=12) and at B=1, on the operands of real engine steps;
on a clause-sharded window (row0 = 1024, 512 rows, the full-width draws);
with no selection and with every clause selected; on made-up operands
(int32 states, K=2, a literal count that is no multiple of 4, boost off,
a window); and captured in a CUDA graph.  A conv fit's epoch graph counts
two launches a step.  Every test skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_conv_ta_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import ops
from repro_torch.kernels.conv_ta import (conv_ta_update, conv_ta_update_plain,
                                         prepare_conv_ta_update)
from repro_torch.kernels.ref import pack_include
from repro_torch.launch.kernel_bench import conv_ta_operands

pytestmark = pytest.mark.cuda

ROWS = (0, 1, 3, 4, 5, 6, 7, 13)    # the operands indexed by clause row
ROW_DIM = (1, 1, 3, 2, 2, 2, 2, 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _cell_step(B, seed):
    """The wrapper's operands of one engine conv step of B images at the
    conv cell's shape (``kernel_bench.conv_ta_operands``)."""
    a = conv_ta_operands(torch, B, seed)
    assert a[2].shape == (1, B, 361, 12) and a[11].shape[-2:] == (2048, 384)
    return a


def _same(a, row0=0):
    got = conv_ta_update(*a, row0=row0)
    want = conv_ta_update_plain(*a, row0=row0)
    torch.cuda.synchronize()
    assert got[0].dtype == want[0].dtype == a[0].dtype
    assert torch.equal(got[0], want[0]), "TA states differ"
    assert torch.equal(got[1], want[1]), "include words differ"
    return got


@pytest.mark.parametrize("B", [32, 1])
def test_kernels_equal_plain_at_the_cells_step(dev, B):
    a = _cell_step(B, seed=B)
    fires = (a[3] > 0).float().mean().item()
    assert 0.0 < fires < 1.0           # clauses fire on some patches only
    n = conv_ta_update.launches
    got = _same(a)
    assert conv_ta_update.launches == n + 2
    assert not torch.equal(got[0], a[0])


def test_kernels_equal_plain_on_a_sharded_window(dev):
    a = _cell_step(32, seed=7)
    full = conv_ta_update(*a)
    win = list(a)
    for i, d in zip(ROWS, ROW_DIM):
        win[i] = a[i].narrow(d, 1024, 512).contiguous()
    got = _same(win, row0=1024)
    assert torch.equal(got[0], full[0][:, 1024:1536])
    assert torch.equal(got[1], full[1][:, 1024:1536])


@pytest.mark.parametrize("sel", [0, 1])
def test_no_selection_and_every_clause_selected(dev, sel):
    a = _cell_step(32, seed=3)
    cl_mask = a[13][:, None]
    a[5] = torch.full_like(a[5], sel) * cl_mask
    a[6] = torch.full_like(a[6], sel) * cl_mask
    got = _same(a)
    if sel == 0:     # no feedback: the states stay, the include is theirs
        assert torch.equal(got[0], a[0])
        assert torch.equal(got[1], pack_include(a[0], a[16]))


def _made_up(dev, K, B, P, R, L, Wl, H, seed, ta_bits=8, Rg=None, boost=None,
             pfire=0.1):
    g = torch.Generator().manual_seed(seed)
    Rg = Rg or R

    def ri(lo, hi, shape, dt=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, dtype=dt)
    n_states = torch.full((K,), 1 << ta_bits, dtype=torch.int32)
    ta = ri(0, 1 << ta_bits, (K, R, L)).to(
        torch.uint8 if ta_bits <= 8 else torch.int32)
    real = torch.randint(1, L + 1, (K,), generator=g)
    l_mask = (torch.arange(L)[None] < real[:, None]).to(torch.int32)
    cl_mask = (torch.rand((K, R), generator=g) < 0.9).to(torch.int32)
    cl_p = (torch.rand((K, B, P, R), generator=g) < pfire).to(torch.int32)
    cl_p[..., P - 1, :] = 0                      # a padded patch slot
    sel = [(torch.rand((K, B, R), generator=g) < 0.4).to(torch.int32)
           * cl_mask[:, None] for _ in range(2)]
    labels = ri(0, H, (K, B))
    a = [ta, pack_include(ta, n_states),
         ri(-2 ** 31, 2 ** 31, (K, B, P, Wl), torch.int64).to(torch.int32),
         cl_p, cl_p.amax(dim=2), *sel, ri(-3, 4, (K, H, R)), labels,
         (labels + 1) % H, ri(0, 1 << 16, (K, B, P, Rg), torch.int64),
         ri(0, 1 << 16, (K, 2, B, Rg, L), torch.int64), l_mask, cl_mask,
         torch.full((K,), 6554, dtype=torch.int32),
         torch.tensor([(k % 2 == 0) if boost is None else boost
                       for k in range(K)]), n_states]
    return [t.to(dev) for t in a]


@pytest.mark.parametrize("case", [
    dict(K=2, B=5, P=7, R=12, L=72, Wl=3, H=3, seed=1, ta_bits=10),
    dict(K=2, B=3, P=5, R=40, L=50, Wl=2, H=2, seed=2),
    dict(K=1, B=3, P=5, R=40, L=50, Wl=2, H=2, seed=3, ta_bits=12),
    dict(K=1, B=70, P=4, R=9, L=136, Wl=5, H=3, seed=4, boost=False,
         pfire=0.5),
    dict(K=3, B=33, P=9, R=130, L=260, Wl=9, H=4, seed=5),
])
def test_kernels_equal_plain_on_made_up_operands(dev, case):
    _same(_made_up(dev, **case))


def test_made_up_window_reads_the_draws_at_row0(dev):
    a = _made_up(dev, K=2, B=4, P=6, R=16, L=64, Wl=2, H=3, seed=6, Rg=48)
    _same(a, row0=32)
    _same(a, row0=0)
    with pytest.raises(ValueError):
        conv_ta_update(*a, row0=33)


def test_capture_in_a_cuda_graph_equals_eager(dev):
    a = _cell_step(32, seed=9)
    want = conv_ta_update(*a)
    launch, outs = prepare_conv_ta_update(*a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        launch()
    for t in outs:
        t.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])


def test_a_conv_fit_counts_two_launches_a_step(dev):
    spec = api.TMSpec.conv(12, 12, 5, classes=10, clauses=256, T=500,
                           s=10.0, ta_bits=8, weight_bits=12,
                           prng_backend="lfsr", lfsr_bits=24, rand_bits=16)
    eng = api.compile(api.tile_for(spec))
    tm = api.TM(spec, engine=eng, seed=1)
    rng = np.random.default_rng(1)
    x = (rng.random((64, 12, 12)) < 0.5).astype(np.int8)
    y = rng.integers(0, 10, 64)
    ops.reset_launch_counts()
    tm.fit(x, y, epochs=1, batch=16, rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["conv_ta_update"] == 2 * 4
    assert eng.cache_report()["path_per_stage"]["train_conv_ta"] == "conv_ta"
