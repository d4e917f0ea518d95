"""The train step's glue kernels against their plain versions, on the card.

``step_prologue`` and ``step_epilogue`` (``csrc/step_glue.cu``) must equal
``step_prologue_plain`` and ``step_epilogue_plain`` bit for bit: one
program and banks of four, a batch row and a batch slot, the engine's
clause counts, banks that mix classifier and regression programs,
frozen weights, padded classes and the launch layouts, on both epilogue
kernels: the cluster kernel and the wide one (more classes or rows than
the cluster kernel holds).  Also the donated step: the epilogue writes
the weights in place, and the undonated step leaves its input program as
it was.  Every test skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_step_glue_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.dtm import FIELDS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF_SUM
from repro_torch.kernels.step_glue import (epilogue_wide,
                                           prepare_step_epilogue,
                                           step_epilogue,
                                           step_epilogue_plain,
                                           step_prologue,
                                           step_prologue_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _case(K, B, R, W=52, H=16, y=128, reg=(), frozen=(), classes=None,
          seed=0):
    """The glue's operands on the CPU: K programs, ``reg`` and ``frozen``
    the indices of regression and frozen-weight programs, ``classes[k]``
    the real classes of program k (the rest padded)."""
    g = torch.Generator().manual_seed(seed)
    classes = classes or [H - 1 - (k % 3) for k in range(K)]
    h_mask = torch.zeros((K, H), dtype=torch.int32)
    for k, n in enumerate(classes):
        h_mask[k, :n] = 1
    regression = torch.tensor([k in reg for k in range(K)])
    w_frozen = torch.tensor([k in frozen for k in range(K)])
    T = torch.randint(1, 600, (K,), generator=g, dtype=torch.int32)
    w_clip = torch.full((K,), 2047, dtype=torch.int32)
    w_clip[-1] = 3
    real = torch.randint(R // 2, R + 1, (K,), generator=g)
    cl_mask = (torch.arange(R)[None] < real[:, None]).to(torch.int32)
    labels = torch.stack([
        torch.randint(0, 2 * int(T[k]) if k in reg else classes[k], (B,),
                      generator=g) for k in range(K)]).to(torch.int32)
    c_rand = torch.randint(0, 1 << 16, (K, B), generator=g)
    seed_bits = torch.randint(0, 1 << 16, (K, 2), generator=g)
    sel_rand = torch.randint(0, 1 << 16, (K, 2, B, R), generator=g)
    pro = step_prologue_plain(labels, c_rand, seed_bits, sel_rand, h_mask,
                              regression)
    labels, cls_lab, neg, _, sel32 = pro

    def bits(p):
        return (torch.rand((K, B, R), generator=g) < p).to(torch.int32) \
            * cl_mask[:, None]
    cl, sel_lab, sel_neg = bits(0.3), bits(0.1), bits(0.1)
    sel_lab[0, 0] = cl_mask[0]          # a row selected everywhere
    sums = torch.randint(-50, 50, (K, B, H), generator=g, dtype=torch.int32)
    sums = torch.where(h_mask[:, None] > 0, sums,
                       torch.full_like(sums, NEG_INF_SUM))
    weights = torch.randint(-4, 5, (K, H, R), generator=g, dtype=torch.int32)
    lits = torch.randint(-2 ** 31, 2 ** 31, (K, B, W), generator=g,
                         dtype=torch.int64).to(torch.int32)
    draws = (labels, c_rand, seed_bits, sel_rand, h_mask, regression)
    epi = (lits, cl, sums, sel_lab, sel_neg, sel32, labels, cls_lab, neg,
           weights, cl_mask, w_frozen, w_clip, T, regression)
    return draws, epi, y


def _to(ts, dev):
    return [t.to(dev) for t in ts]


def _assert_equal(got, want, names):
    for n, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, n
        assert torch.equal(a.cpu(), b.cpu()), n


PRO_NAMES = ("labels", "cls_lab", "neg", "ta_seed", "sel_rand")
EPI_NAMES = ("lit2", "cl2", "t1", "t2", "tile_idx", "count", "weights",
             "stats")
SHAPES = [(1, 1, 2048), (1, 32, 2048), (4, 1, 4224), (4, 32, 4224),
          (1, 32, 4224), (4, 32, 2048), (2, 33, 256), (3, 64, 384)]


@pytest.mark.parametrize("K,B,R", SHAPES)
def test_prologue_equals_plain(dev, K, B, R):
    draws, _, _ = _case(K, B, R, reg=(K - 1,) if K > 1 else ())
    got = step_prologue(*_to(draws, dev))
    torch.cuda.synchronize()
    _assert_equal(got, step_prologue_plain(*draws), PRO_NAMES)


def test_prologue_unaligned_words(dev):
    """Selection words at an offset that is not 16-byte aligned take the
    kernel's one-word path."""
    draws, _, _ = _case(2, 5, 256)
    sel = draws[3].to(dev)
    buf = torch.empty(sel.numel() + 1, dtype=torch.int64, device=dev)
    off = buf[1:].view(sel.shape)
    off.copy_(sel)
    got = step_prologue(draws[0].to(dev), draws[1].to(dev),
                        draws[2].to(dev), off, draws[4].to(dev),
                        draws[5].to(dev))
    torch.cuda.synchronize()
    _assert_equal(got, step_prologue_plain(*draws), PRO_NAMES)


WIDE = [None, {"wide": 1}]      # the kernel the shape takes; the wide one


@pytest.mark.parametrize("geometry", WIDE)
@pytest.mark.parametrize("K,B,R", SHAPES)
def test_epilogue_equals_plain(dev, K, B, R, geometry):
    _, epi, y = _case(K, B, R, seed=K * 100 + B,
                      frozen=(1,) if K > 1 else ())
    got = step_epilogue(*_to(epi, dev), y=y, geometry=geometry)
    torch.cuda.synchronize()
    _assert_equal(got, step_epilogue_plain(*epi, y=y), EPI_NAMES)


@pytest.mark.parametrize("geometry", WIDE)
@pytest.mark.parametrize("B", [1, 32])
def test_epilogue_mixed_bank(dev, B, geometry):
    """Classifier, regression and frozen programs in one launch, padded
    classes of different counts."""
    _, epi, y = _case(4, B, 4224, reg=(1, 3), frozen=(2,),
                      classes=[10, 1, 16, 3], seed=7)
    got = step_epilogue(*_to(epi, dev), y=y, geometry=geometry)
    torch.cuda.synchronize()
    want = step_epilogue_plain(*epi, y=y)
    _assert_equal(got, want, EPI_NAMES)
    assert int(want[5].min()) > 0          # every program has feedback


@pytest.mark.parametrize("geometry", WIDE)
@pytest.mark.parametrize("y,R", [(64, 2048), (16, 48), (256, 4096)])
def test_epilogue_stat_groups(dev, y, R, geometry):
    """The engine's stat groups of y rows: warp-sized and larger, and
    smaller than a warp."""
    _, epi, _ = _case(2, 8, R, reg=(1,), seed=y)
    got = step_epilogue(*_to(epi, dev), y=y, geometry=geometry)
    torch.cuda.synchronize()
    _assert_equal(got, step_epilogue_plain(*epi, y=y), EPI_NAMES)


@pytest.mark.parametrize("geometry", [
    {"cluster": 1}, {"cluster": 3}, {"cluster": 8}, {"cluster": 16},
    {"cluster": 1, "wide": 1}, {"cluster": 3, "wide": 1},
    {"cluster": 16, "wide": 1}])
def test_epilogue_layouts(dev, geometry):
    _, epi, y = _case(2, 32, 4224, reg=(1,), seed=3)
    got = step_epilogue(*_to(epi, dev), y=y, geometry=geometry)
    torch.cuda.synchronize()
    _assert_equal(got, step_epilogue_plain(*epi, y=y), EPI_NAMES)


@pytest.mark.parametrize("H", [17, 40, 64, 65, 100, 2048])
def test_epilogue_many_classes(dev, H):
    """More classes than 16: each thread holds more of its column's
    class weights; past 64 the wide kernel runs."""
    _, epi, y = _case(2, 32, 512, H=H, classes=[H, H - 5], reg=(1,),
                      seed=H)
    assert epilogue_wide(32, H, 512, y, dev) == (H > 64)
    got = step_epilogue(*_to(epi, dev), y=y)
    torch.cuda.synchronize()
    _assert_equal(got, step_epilogue_plain(*epi, y=y), EPI_NAMES)
    if H > 64:
        with pytest.raises(ValueError, match="wide"):
            step_epilogue(*_to(epi, dev), y=y, geometry={"wide": 0})


@pytest.mark.parametrize("K,B,R,H,wide", [(1, 5000, 256, 16, True),
                                          (2, 4000, 384, 64, True),
                                          (1, 1025, 2048, 100, True),
                                          (1, 3000, 256, 16, False)])
def test_epilogue_many_rows(dev, K, B, R, H, wide):
    """More rows than the cluster kernel holds in shared memory (about
    4,150 at H=16, 3,400 at H=64), and, at 1,025 rows and more, more than
    one of the wide kernel's vote segments; 3,000 rows still fit."""
    _, epi, y = _case(K, B, R, H=H, reg=(K - 1,) if K > 1 else (),
                      seed=B)
    assert epilogue_wide(B, H, R, y, dev) == wide
    got = step_epilogue(*_to(epi, dev), y=y)
    torch.cuda.synchronize()
    _assert_equal(got, step_epilogue_plain(*epi, y=y), EPI_NAMES)


@pytest.mark.parametrize("geometry", WIDE)
def test_epilogue_in_place(dev, geometry):
    _, epi, y = _case(2, 32, 2048, frozen=(1,), seed=9)
    want = step_epilogue_plain(*epi, y=y)
    ops_ = _to(epi, dev)
    w = ops_[9]
    ptr = w.data_ptr()
    launch, out = prepare_step_epilogue(*ops_, y=y, inplace=True,
                                        geometry=geometry)
    n = step_epilogue.launches
    launch()
    torch.cuda.synchronize()
    assert step_epilogue.launches == n + 1
    assert out[6].data_ptr() == ptr
    _assert_equal(out, want, EPI_NAMES)
    with pytest.raises(ValueError):
        step_epilogue(*ops_[:9], w.transpose(1, 2).contiguous()
                      .transpose(1, 2), *ops_[10:], y=y, inplace=True)


def _program(dev, kind="coalesced", seed=1, B=32, features=784, classes=10,
             clauses=2000):
    spec = (api.TMSpec.regression(features=features, clauses=clauses, T=500,
                                  prng_backend="lfsr")
            if kind == "regression" else
            api.TMSpec.coalesced(features=features, classes=classes,
                                 clauses=clauses, T=500,
                                 prng_backend="lfsr"))
    eng = api.compile(api.tile_for(spec))
    tm = api.TM(spec, engine=eng, seed=seed)
    rng = np.random.default_rng(seed)
    x = (rng.random((B, features)) < 0.5).astype(np.int8)
    y = (rng.random(B) * 400 if kind == "regression"
         else rng.integers(0, classes, B))
    return eng, tm.program, tm.prng, eng.encode(spec, x), \
        spec.encode_labels(y).to(eng.device)


@pytest.mark.parametrize("kind", ["coalesced", "regression"])
@pytest.mark.parametrize("B", [1, 32])
def test_train_step_runs_both_kernels_and_equals_cpu(dev, kind, B):
    eng, prog, prng, lits, labels = _program(dev, kind, B=B)
    cpu = api.compile(eng.tile, device="cpu")
    ops.reset_launch_counts()
    got = eng.train_step(prog, prng, lits, labels)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["step_prologue"] == counts["step_epilogue"] == 1
    want = cpu.train_step(prog.to("cpu"), prng.to("cpu"), lits.cpu(),
                          labels.cpu())
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f)), f
    assert torch.equal(got[2].row.cpu(), want[2].row)


@pytest.mark.parametrize("B,classes", [(32, 100), (4500, 10)])
def test_wide_train_step_equals_cpu(dev, B, classes):
    """A step past the cluster kernel's classes or rows (the wide kernel)
    equals the CPU engine's, donated too."""
    eng, prog, prng, lits, labels = _program(dev, B=B, features=64,
                                             classes=classes, clauses=256)
    assert epilogue_wide(B, eng.H, eng.R, eng.tile.y, dev)
    cpu = api.compile(eng.tile, device="cpu")
    want = cpu.train_step(prog.to("cpu"), prng.to("cpu"), lits.cpu(),
                          labels.cpu())
    ops.reset_launch_counts()
    got = eng.train_step(prog, prng, lits, labels, donate=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["step_epilogue"] == 1
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f)), f
    assert torch.equal(got[2].row.cpu(), want[2].row)


def test_donated_step_writes_weights_in_place(dev):
    eng, prog, prng, lits, labels = _program(dev)
    # every TA excluded: each clause is empty and fires in training, so
    # the step nudges weights
    prog = dataclasses.replace(prog, ta=torch.zeros_like(prog.ta),
                               inc=torch.zeros_like(prog.inc))
    before = prog.map(torch.clone)
    want = eng.train_step(prog, prng, lits, labels)
    for f in FIELDS:           # the undonated step leaves its input alone
        assert torch.equal(getattr(prog, f), getattr(before, f)), f
    ptr = prog.weights.data_ptr()
    got = eng.train_step(prog, prng, lits, labels, donate=True)
    torch.cuda.synchronize()
    assert got[0].weights.data_ptr() == ptr
    assert got[0].ta.data_ptr() == prog.ta.data_ptr()
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert not torch.equal(got[0].weights, before.weights)


def test_ref_path_launches_no_glue_kernel(dev):
    eng, prog, prng, lits, labels = _program(dev)
    ref = api.compile(eng.tile, kernel_path="ref")
    ops.reset_launch_counts()
    got = ref.train_step(prog, prng, lits, labels)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["step_prologue"] == counts["step_epilogue"] == 0
    want = eng.train_step(prog, prng, lits, labels)
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
