"""The threefry PRNG and the seed-drawn program of the port against the
JAX package (CPU, exact).

``key``, ``split``, ``bits`` and ``bernoulli_half`` against
``jax.random`` (seeds past 32 bits and below zero keep the low word, as
JAX without x64 does); a threefry ``PRNG`` over consecutive ``bits``
calls, one program and a stacked bank; ``TM(spec, seed).program`` for all
five kinds; a threefry fit from the seed alone; ``TMServer.register``;
a JAX durable directory whose untrained tenant cold-starts in the port;
``TM.save``/``TM.load`` with a threefry PRNG both ways; and the
``threefry_bits`` wrapper's CPU contract.  The ``cuda`` test holds the
kernel against its plain version and skips without a card (decided in
the fixture); run it on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_threefry.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import prng as jprng
from repro.core.types import TMConfig as JConfig
from repro.launch.serve_tm import TMServer as JServer
from repro.launch.serve_tm import demo_specs as jdemo_specs
from repro_torch import api as tapi, checkpoint as tckpt, convert
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.core import prng as tprng, threefry
from repro_torch.core.types import TileConfig, TMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.threefry import threefry_bits, threefry_bits_plain
from repro_torch.launch.serve_tm import TMServer
from test_torch_prng import jax_prng_numpy
from test_torch_train import _assert_same, _data, _jspec, _tspec

SEEDS = [0, 1, 12345, -5, 2 ** 32 + 5]
_CALIB = np.random.default_rng(42).standard_normal((64, 5)).astype(np.float32)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# ---------------------------------------------------------------------------
# jax.random, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_bernoulli_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.key(seed, "cpu")
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    assert int(tk[0]) == 0 and int(tk[1]) == seed % 2 ** 32
    ja, jb = jax.random.split(jk)
    ta, tb = threefry.split(tk)
    np.testing.assert_array_equal(ta.numpy(), _u32(ja))
    np.testing.assert_array_equal(tb.numpy(), _u32(jb))
    for n in (1, 2, 255, 1000):
        np.testing.assert_array_equal(
            threefry.bits(tb, n).numpy(),
            _u32(jax.random.bits(jb, (n,), jnp.uint32)))
    for shape in ((13, 17), (1000,), (2, 3, 5)):
        np.testing.assert_array_equal(
            threefry.bernoulli_half(ta, shape).numpy(),
            np.asarray(jax.random.bernoulli(ta.numpy().astype(np.uint32),
                                            0.5, shape)))
    # a bank of keys draws per key
    bank = torch.stack([ta, tb])
    np.testing.assert_array_equal(threefry.bits(bank, 9)[1].numpy(),
                                  threefry.bits(tb, 9).numpy())
    np.testing.assert_array_equal(threefry.split(bank)[0][0].numpy(),
                                  threefry.split(ta)[0].numpy())


def test_as_key_takes_jax_and_numpy_keys():
    jk = jax.random.PRNGKey(7)
    for k in (jk, np.asarray(jk), threefry.key(7, "cpu"), [0, 7]):
        got = threefry.as_key(k, "cpu")
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), _u32(jk))
    with pytest.raises(ValueError):
        threefry.as_key(np.zeros(3, np.uint32), "cpu")
    with pytest.raises(TypeError):
        threefry.as_key(np.zeros(2, np.float32), "cpu")


@pytest.mark.parametrize("rand_bits", [8, 16, 24, 32])
@pytest.mark.parametrize("seed", [0, -5])
def test_prng_bits_match_jax_over_consecutive_calls(rand_bits, seed):
    kw = dict(prng_backend="threefry", rand_bits=rand_bits)
    j = jprng.PRNG.create(JConfig(**kw), seed)
    t = tprng.PRNG.create(TMConfig(**kw), seed, device="cpu")
    assert t.lead == () and t.state.shape == (2,)
    for shape in [(5,), (2, 3, 40), (2,), (1,), (255,)]:
        j, want = j.bits(shape)
        t, got = t.bits(shape)
        assert got.shape == shape and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), _u32(want))
        assert int(got.max()) < 2 ** rand_bits
    for k, v in convert.prng_to_numpy(t).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(jax_prng_numpy(j)[k]))


def test_bank_prng_matches_jax_vmap():
    cfg = TMConfig(prng_backend="threefry")
    singles = [tprng.PRNG.create(cfg, s, device="cpu") for s in (1, 2, 3)]
    bank = tprng.PRNG.stack(singles)
    assert bank.lead == (3,) and bank.state.shape == (3, 2)
    jbank = jax.tree.map(lambda *ls: jnp.stack(ls),
                         *(jprng.PRNG.create(JConfig(prng_backend="threefry"),
                                             s) for s in (1, 2, 3)))
    for shape in [(5,), (2, 40), (3,)]:
        bank, got = bank.bits(shape)
        jbank, want = jax.vmap(lambda p: p.bits(shape))(jbank)
        assert got.shape == (3, *shape)
        np.testing.assert_array_equal(got.numpy(), _u32(want))
        for k in range(3):
            singles[k], one = singles[k].bits(shape)
            assert torch.equal(got[k], one)
    np.testing.assert_array_equal(bank.state.numpy(), _u32(jbank.state))
    for k in range(3):
        assert torch.equal(bank[k].state, singles[k].state)


def test_numpy_round_trip_and_prng_defaults_to_the_card(monkeypatch):
    j = jprng.PRNG.create(JConfig(prng_backend="threefry"), 5)
    t = convert.prng_from_numpy(jax_prng_numpy(j), device="cpu")
    assert t.backend == "threefry" and t.state.shape == (2,)
    d = convert.prng_to_numpy(t)
    assert d["state"].dtype == np.uint32 and d["state"].shape == (2,)
    j, want = j.bits((3, 11))
    t, got = t.bits((3, 11))
    np.testing.assert_array_equal(got.numpy(), _u32(want))
    with pytest.raises(ValueError):
        convert.prng_from_numpy({**d, "state": np.zeros(3, np.uint32)},
                                device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprng.PRNG.create(TMConfig(prng_backend="threefry"), 1)


# ---------------------------------------------------------------------------
# the threefry_bits wrapper (CPU contract) and the kernel (card)
# ---------------------------------------------------------------------------

def test_threefry_bits_cpu_route_is_the_plain_version():
    ops.reset_launch_counts()
    keys = torch.stack([threefry.key(s, "cpu") for s in (0, 9)])
    new, words = threefry_bits(keys, 300, 16)
    assert ops.launch_counts()["threefry_bits"] == 0
    a, b = threefry.split(keys)
    assert torch.equal(new, a)
    assert torch.equal(words, threefry.bits(b, 300) >> 16)
    same, raw = threefry_bits(keys, 7, 32, split=False)
    assert torch.equal(same, keys) and torch.equal(raw,
                                                   threefry.bits(keys, 7))
    before = keys.clone()
    threefry_bits(keys, 5, 8)
    assert torch.equal(keys, before)
    with pytest.raises(ValueError):
        threefry_bits(keys[:, :1], 4, 16)
    with pytest.raises(ValueError):
        threefry_bits(keys, 4, 0)
    with pytest.raises(TypeError):
        threefry_bits(keys.to(torch.int32), 4, 16)
    with pytest.raises(ValueError, match="no kernel"):
        threefry_bits(torch.zeros((1, 2), dtype=torch.int64,
                                  device="meta"), 4, 16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size,rand_bits,split", [
    (1, 16, True), (255, 8, True), (1025, 32, True), (131072, 16, True),
    (2000 * 1568, 1, False), (0, 16, True)])
def test_threefry_bits_kernel_matches_plain(dev, size, rand_bits, split):
    keys = torch.stack([threefry.key(s, dev) for s in (0, 1, -5, 2 ** 32 + 5)])
    ops.reset_launch_counts()
    got = threefry_bits(keys, size, rand_bits, split)
    want = threefry_bits_plain(keys, size, rand_bits, split)
    torch.cuda.synchronize()
    assert ops.launch_counts()["threefry_bits"] == 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.int64 and g.shape == w.shape
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the program draw and the entry points that draw from a seed
# ---------------------------------------------------------------------------

def _kind_spec(kind):
    if kind == "conv":
        return japi.TMSpec.conv(6, 6, 3, classes=2, clauses=16, T=8,
                                prng_backend="threefry")
    if kind == "head":
        return japi.TMSpec.head(_CALIB, classes=3, therm_bits=3, clauses=16,
                                T=10, prng_backend="threefry")
    return _jspec(kind, "threefry")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["vanilla", "coalesced", "conv",
                                  "regression", "head"])
def test_tm_program_matches_jax(kind, seed):
    jspec = _kind_spec(kind)
    jtm = japi.TM(jspec, seed=seed)
    ttm = tapi.TM(_tspec(jspec), device="cpu", seed=seed,
                  tile=TileConfig(**dataclasses.asdict(jtm.engine.tile)))
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    # lower() takes the JAX key as it is
    again = ttm.engine.lower(_tspec(jspec), jax.random.PRNGKey(seed))
    for a, b in zip(again.leaves(), ttm.program.leaves()):
        assert torch.equal(a, b)


def test_program_needs_a_key_or_states():
    spec = tapi.TMSpec.coalesced(features=8, classes=2, clauses=4)
    eng = tapi.compile(tapi.tile_for(spec), device="cpu")
    with pytest.raises(ValueError, match="threefry key"):
        eng.lower(spec)
    cfg = spec.tm_config()
    ta = np.full((cfg.total_clauses, cfg.literals), cfg.include_threshold)
    with pytest.raises(ValueError, match="threefry key"):
        eng.lower(spec, ta=ta)        # the weights are still to draw
    eng.lower(spec, ta=ta, weights=np.ones((2, 4)))
    with pytest.raises(ValueError, match="one threefry key"):
        eng.lower(spec, torch.zeros((2, 2), dtype=torch.int64))


@pytest.fixture(scope="module")
def engines():
    kinds = ("coalesced", "regression", "head")
    tile = japi.tile_for(*(_jspec(k) for k in kinds), x=32, y=128, m=128,
                         n=4)
    ttile = tapi.tile_for(*(_tspec(_jspec(k)) for k in kinds), x=32, y=128,
                          m=128, n=4)
    return japi.compile(tile, backend="ref"), tapi.compile(ttile,
                                                           device="cpu")


@pytest.mark.parametrize("kind", ["coalesced", "regression"])
def test_threefry_fit_from_a_seed_matches_jax(engines, kind):
    jeng, teng = engines
    jspec = _jspec(kind, "threefry")
    x, y = _data(jspec, 72, 3)
    jtm = japi.TM(jspec, engine=jeng, seed=11)
    ttm = tapi.TM(_tspec(jspec), engine=teng, seed=11)
    want = jtm.fit(x, y, epochs=2, batch=24, rng=np.random.default_rng(4))
    got = ttm.fit(x, y, epochs=2, batch=24, rng=np.random.default_rng(4))
    assert got == want and ttm.steps == jtm.steps == 6
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    for lo in (0, 3):                  # the edge step, B <= 4
        want = jtm.partial_fit(x[lo:lo + 3], y[lo:lo + 3])
        got = ttm.partial_fit(x[lo:lo + 3], y[lo:lo + 3])
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)


def test_threefry_bank_step_matches_jax(engines):
    jeng, teng = engines
    specs = [_jspec(k, "threefry") for k in ("coalesced", "head")]
    jtms = [japi.TM(s, engine=jeng, seed=20 + i) for i, s in enumerate(specs)]
    ttms = [tapi.TM(_tspec(s), engine=teng, seed=20 + i)
            for i, s in enumerate(specs)]
    jbank = japi.stack([t.program for t in jtms], jeng,
                       prngs=[t.prng for t in jtms])
    tbank = tapi.stack([t.program for t in ttms], teng,
                       prngs=[t.prng for t in ttms])
    data = [_data(s, 6, 30 + i) for i, s in enumerate(specs)]
    jl = jnp.stack([jeng.encode(s, jnp.asarray(d[0]))
                    for s, d in zip(specs, data)])
    tl = torch.stack([teng.encode(_tspec(s), d[0])
                      for s, d in zip(specs, data)])
    labels = np.stack([d[1] for d in data])
    jst, tst = jbank.train(jl, jnp.asarray(labels)), tbank.train(tl, labels)
    for k in tst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    for k in range(2):
        _assert_same(tbank.swap_out(k), tbank.prngs[k],
                     jax.tree.map(lambda t: t[k], jbank.progs),
                     jax.tree.map(lambda t: t[k], jbank.prngs), str(k))


def test_register_from_seed_matches_jax(engines):
    jeng, teng = engines
    jspec = _jspec("coalesced", "threefry")
    jreg = _jspec("regression")
    jsrv, tsrv = JServer(jeng, batch_slot=8), TMServer(teng, batch_slot=8)
    jsrv.register("t", jspec, seed=5)
    jsrv.register("u", jreg, seed=6)
    tsrv.register("t", _tspec(jspec), seed=5)
    tsrv.register("u", _tspec(jreg), seed=6)
    for n in ("t", "u"):
        jt, tt = jsrv.tenants[n], tsrv.tenants[n]
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)


def test_jax_durable_untrained_tenant_cold_starts_to_jax_program(tmp_path):
    """A JAX ``api.serve`` roster with a durable directory: one tenant
    trained and checkpointed, the others never trained.  The port's cold
    start restores the first and lowers the others from their manifest
    seeds, to the JAX package's programs and PRNGs."""
    from test_torch_recovery import BATCH_SLOT, _run_stream
    d = str(tmp_path / "durable")
    jspecs = jdemo_specs(small=True)
    tspecs = {n: tapi.TMSpec.from_dict(s.to_dict()) for n, s in jspecs.items()}
    a = japi.serve(dict(jspecs), batch_slot=BATCH_SLOT, backend="ref",
                   durable_dir=d, seed=4)
    trained = sorted(jspecs)[0]
    _run_stream(a, {trained: tspecs[trained]}, rounds=1, seed0=700)
    a.checkpoint_now()
    assert a.server.tenants[trained].steps == 1
    b = tapi.serve(None, durable_dir=d, device="cpu")
    for n in jspecs:
        jt, tt = a.server.tenants[n], b.server.tenants[n]
        assert tt.steps == jt.steps == (1 if n == trained else 0), n
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)


@pytest.mark.parametrize("kind", ["coalesced", "head"])
def test_tm_save_load_crosses_with_a_threefry_prng(engines, tmp_path, kind):
    jeng, teng = engines
    jspec = _jspec(kind, "threefry")
    x, y = _data(jspec, 32, 13)
    jtm = japi.TM(jspec, engine=jeng, seed=8)
    for s in (0, 8):
        jtm.partial_fit(x[s:s + 8], y[s:s + 8])
    jdir = str(tmp_path / "jax")
    jtm.save(jdir)
    ttm = tapi.TM.load(jdir, device="cpu")
    assert ttm.steps == 2 and ttm.prng.backend == "threefry"
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    for s in (16, 24):                 # both train on identically
        want = jtm.partial_fit(x[s:s + 8], y[s:s + 8])
        got = ttm.partial_fit(x[s:s + 8], y[s:s + 8])
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
    tdir = str(tmp_path / "port")
    ttm.save(tdir)
    back = japi.TM.load(tdir, engine=jeng)
    assert back.steps == 4
    _assert_same(ttm.program, ttm.prng, back.program, back.prng, kind)


def test_checkpoint_leaf_of_a_threefry_prng_is_jax_s(tmp_path):
    j = jprng.PRNG.create(JConfig(prng_backend="threefry"), 3)
    t = tprng.PRNG.create(TMConfig(prng_backend="threefry"), 3, device="cpu")
    jtree = {"prng": j, "w": jnp.arange(4, dtype=jnp.int32)}
    ttree = {"prng": t, "w": torch.arange(4, dtype=torch.int32)}
    leaf, u32 = tck._flatten(ttree)[0][0]
    jleaf = jax.tree.flatten(jtree)[0][0]
    got = tck._to_numpy(leaf, u32)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(jleaf))
    tckpt.save(str(tmp_path / "c"), 1, ttree)
    back, _ = tckpt.restore(str(tmp_path / "c"), 1, ttree)
    assert torch.equal(back["prng"].state, t.state)
    assert back["prng"].state.dtype == torch.int64
