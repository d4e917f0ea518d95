"""The lfsr cluster kernel against its plain version, and the conv step on
the card against the CPU engine.

The CPU tests pin the wrapper's contract (the plain loop on CPU state,
the JAX package's words at every width and word size, its refusals).
The ``cuda`` tests need an NVIDIA card and nvcc and skip without one
(decided inside the fixture, never at import); run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lfsr.py

Words and state are integers, so kernel and plain version must agree
exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro.core.types import TMConfig as JConfig
from repro_torch import api, convert
from repro_torch.core import prng as tprng, threefry
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.core.types import TMConfig
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.lfsr import lfsr_bits, lfsr_bits_plain
from test_torch_prng import jax_prng_numpy


def _state(width, lanes=8192, k=None, seed=3, cycles=0, device="cpu"):
    """A cluster's (lanes, master, cycles), optionally a K bank of seeds
    seed, seed + 1, ... with ``cycles`` already run."""
    seeds = [seed] if k is None else [seed + i for i in range(k)]
    sts = [tprng.make_cluster(s, lanes, width, device="cpu") for s in seeds]
    leaves = [torch.stack(ls) for ls in zip(*((s.lanes, s.master,
                                               s.cycles) for s in sts))]
    if k is None:
        leaves = [t[0] for t in leaves]
    leaves[2] = leaves[2] + cycles
    return tuple(t.to(device) for t in leaves)


# ---------------------------------------------------------------- CPU ---- #

@pytest.mark.parametrize("width,rand_bits,refresh", [
    (4, 16, True), (4, 16, False), (8, 4, True), (12, 32, True),
    (16, 16, True), (32, 16, True), (32, 32, False), (24, 8, True)])
def test_plain_words_match_jax(width, rand_bits, refresh):
    """rand_bits above the width zero-extends, below it truncates; the
    4-bit refresh fires within the calls."""
    kw = dict(prng_backend="lfsr", lfsr_bits=width, rand_bits=rand_bits,
              seed_refresh=refresh)
    j = jprng.PRNG.create(JConfig(**kw), 11, n_lanes=100)
    t = tprng.PRNG.create(TMConfig(**kw), 11, n_lanes=100, device="cpu")
    for shape in ((250,), (3, 7), (1,), (1700,)):
        j, want = j.bits(shape)
        t, got = t.bits(shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k, v in jax_prng_numpy(j).items():
        np.testing.assert_array_equal(
            np.asarray(convert.prng_to_numpy(t)[k]), np.asarray(v), err_msg=k)


def test_prng_bits_on_cpu_runs_the_plain_loop():
    cfg = TMConfig(prng_backend="lfsr", lfsr_bits=4, rand_bits=16)
    p = tprng.PRNG.create(cfg, 2, n_lanes=50, device="cpu")
    ops.reset_launch_counts()
    p2, words = p.bits((7, 30))
    assert ops.launch_counts()["lfsr_bits"] == 0
    st, rows = p.state, []
    for _ in range(5):                   # ceil(210 / 50) cycles
        st, v = tprng.cluster_next(st, 4, True, 16)
        rows.append(v)
    assert torch.equal(words, torch.cat(rows, -1)[:210].reshape(7, 30))
    for a, b in zip(p2.leaves(), (st.lanes, st.master, st.cycles)):
        assert torch.equal(a, b)


def test_plain_leaves_its_state_and_takes_size_zero():
    lanes, master, cycles = _state(8, lanes=40, k=2)
    before = [t.clone() for t in (lanes, master, cycles)]
    out, *new = lfsr_bits(lanes, master, cycles, 0, 8, 16, True)
    assert out.shape == (2, 0)
    out, *new = lfsr_bits(lanes, master, cycles, 130, 8, 16, True)
    assert out.shape == (2, 130) and int(new[2][0]) == 4
    for a, b in zip(before, (lanes, master, cycles)):
        assert torch.equal(a, b)


def test_wrapper_refuses_other_devices_and_bad_state():
    lanes, master, cycles = _state(24, lanes=16)
    with pytest.raises(ValueError, match="no kernel"):
        lfsr_bits(lanes, master.to("meta"), cycles, 10, 24, 16, True)
    with pytest.raises(ValueError, match="no kernel"):
        lfsr_bits(*(t.to("meta") for t in (lanes, master, cycles)), 10, 24,
                  16, True)
    with pytest.raises(TypeError):
        lfsr_bits(lanes.to(torch.int32), master, cycles, 10, 24, 16, True)
    with pytest.raises(ValueError):
        lfsr_bits(lanes, master[None], cycles, 10, 24, 16, True)


# --------------------------------------------------------------- card ---- #

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _check(dev, width, rand_bits, refresh, size, lanes=8192, k=None,
           cycles=0, seed=3):
    st = _state(width, lanes, k, seed, cycles)
    want = lfsr_bits_plain(*st, size, width, rand_bits, refresh)
    before = lfsr_bits.launches
    got = lfsr_bits(*(t.to(dev) for t in st), size, width, rand_bits,
                    refresh)
    torch.cuda.synchronize()
    assert lfsr_bits.launches == before + 1
    for name, g, w in zip(("words", "lanes", "master", "cycles"), got, want):
        assert g.is_cuda and g.dtype == torch.int64 and g.shape == w.shape
        assert torch.equal(g.cpu(), w), name


# the default flat step's draws (B=32, R=2048: c_rand, sel_rand, seed bits)
# and the full-width conv step's (P=361, R=2048, L=384)
FLAT = [32, 2 * 32 * 2048, 2]
CONV = [32, 32 * 361 * 2048, 2 * 32 * 2048, 2 * 32 * 2048 * 384]


@pytest.mark.cuda
@pytest.mark.parametrize("size", FLAT + CONV)
def test_kernel_matches_plain_at_the_main_paths_draws(dev, size):
    _check(dev, 24, 16, True, size)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8, 12, 32])
@pytest.mark.parametrize("refresh", [True, False])
def test_kernel_matches_plain_at_every_width(dev, width, refresh):
    # 4 bits refresh every 15 cycles: 40 cycles cross it twice; a start
    # near the period crosses it at once at 8 and 12 bits
    near = (1 << width) - 3 if width < 32 else 0
    _check(dev, width, 16, refresh, 40 * 8192, cycles=near)


@pytest.mark.cuda
@pytest.mark.parametrize("width,rand_bits", [(8, 16), (4, 32), (24, 8),
                                             (32, 16), (12, 12), (32, 32)])
def test_kernel_matches_plain_above_and_below_rand_bits(dev, width,
                                                        rand_bits):
    _check(dev, width, rand_bits, True, 3 * 8192 + 5,
           cycles=(1 << width) - 2 if width < 32 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 63, 100, 8191])
def test_kernel_matches_plain_off_the_block(dev, lanes):
    _check(dev, 4, 16, True, 37 * lanes + 1, lanes=lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 24])
def test_kernel_matches_plain_for_a_bank(dev, width):
    _check(dev, width, 16, True, 5 * 8192 + 17, k=2, cycles=9)


@pytest.mark.cuda
def test_prng_bits_on_the_card_is_one_launch(dev):
    cfg = TMConfig(prng_backend="lfsr", lfsr_bits=24, rand_bits=16)
    p = tprng.PRNG.create(cfg, 5, device=dev)
    ops.reset_launch_counts()
    p2, words = p.bits((2, 32, 2048))
    torch.cuda.synchronize()
    assert ops.launch_counts()["lfsr_bits"] == 1
    c2, want = p.to("cpu").bits((2, 32, 2048))
    assert torch.equal(words.cpu(), want)
    for a, b in zip(p2.leaves(), c2.leaves()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,width", [("lfsr", 24), ("lfsr", 4),
                                           ("counter", 24)])
def test_conv_step_on_the_card_equals_the_cpu_engine(dev, backend, width):
    spec = api.TMSpec.conv(10, 10, 4, classes=3, clauses=40, T=10,
                           prng_backend=backend, lfsr_bits=width)
    tile = api.tile_for(spec, x=32, y=16, m=16, n=4)
    gpu = api.compile(tile, device=dev)
    cpu = api.compile(tile, device="cpu")
    prog = cpu.lower(spec, threefry.key(1, "cpu"))
    prng = tprng.PRNG.create(spec.tm_config(), 2, device="cpu")
    rng = np.random.default_rng(4)
    pg, rg = prog.to(dev), prng.to(dev)
    ops.reset_launch_counts()
    for s in range(3):
        x = (rng.random((8, 10, 10)) < 0.5).astype(np.int8)
        y = rng.integers(0, 3, 8).astype(np.int32)
        pg, rg, sg = gpu.train_conv(pg, rg, gpu.encode(spec, x),
                                    torch.as_tensor(y, device=dev))
        prog, prng, sc = cpu.train_conv(prog, prng, cpu.encode(spec, x),
                                        torch.as_tensor(y))
        torch.cuda.synchronize()
        for a, b in zip(pg.leaves() + rg.leaves(),
                        prog.leaves() + prng.leaves()):
            assert torch.equal(a.cpu(), b), s
        assert {k: int(sg[k]) for k in STAT_KEYS} == \
            {k: int(sc[k]) for k in STAT_KEYS}
        sums_g, _ = gpu.infer_conv(pg, gpu.encode(spec, x))
        sums_c, _ = cpu.infer_conv(prog, cpu.encode(spec, x))
        assert torch.equal(sums_g.cpu(), sums_c)
    counts = ops.launch_counts()
    # the clause kernel of the plan for the [B·P, W] view (its seed plan
    # keeps the edge kernel at this small shape)
    path = autotune.planned_path("eval", 8 * gpu.P, (gpu.L, gpu.R, gpu.H),
                                 device=dev)
    clause = {"packed_vpu": "packed_clause_eval",
              "mxu_popcount": "packed_clause_tile"}[path]
    assert counts[clause] == 6 and counts["class_sum"] == 6
    assert counts["lfsr_bits"] == (12 if backend == "lfsr" else 0)
