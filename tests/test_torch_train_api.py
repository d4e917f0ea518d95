"""The training entry points of the port against the JAX package (CPU).

``TM.fit`` (history and final program), ``partial_fit`` and
``skip_frac``, ``ProgramBank.train`` against single steps and the JAX
bank, and ``TMServer.train`` with its stale bank slots, all exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.launch.serve_tm import TMServer as JServer
from repro_torch import api as tapi
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.launch.serve_tm import TMServer
from test_torch_train import (KINDS, _assert_same, _bridge, _data, _jspec,
                              _start, _tspec)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (ref backend) and port engines with skip on and
    off, of the geometry of ``test_torch_train``."""
    tile = japi.tile_for(*(_jspec(k) for k in KINDS), x=32, y=128, m=128,
                         n=4)
    ttile = tapi.tile_for(*(_tspec(_jspec(k)) for k in KINDS), x=32, y=128,
                          m=128, n=4)
    return (japi.compile(tile, backend="ref"),
            {skip: tapi.compile(ttile, device="cpu", skip=skip)
             for skip in (True, False)})


@pytest.mark.parametrize("kind,backend", [("coalesced", "lfsr"),
                                          ("regression", "counter")])
def test_fit_matches_jax_history_and_program(engines, kind, backend):
    jeng, tengs = engines
    jspec = _jspec(kind, backend)
    x, y = _data(jspec, 100, 3)
    xt, yt = _data(jspec, 40, 4)
    jtm = japi.TM(jspec, engine=jeng, seed=5)
    ttm = tapi.TM(_tspec(jspec), engine=tengs[True], seed=5)
    ttm.program, ttm.prng = _bridge(jtm.program, jtm.prng)
    want = jtm.fit(x, y, epochs=2, batch=32, x_test=xt, y_test=yt,
                   rng=np.random.default_rng(9))
    got = ttm.fit(x, y, epochs=2, batch=32, x_test=xt, y_test=yt,
                  rng=np.random.default_rng(9))
    assert got == want
    assert ttm.steps == jtm.steps == 6
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    assert ttm.skip_frac == pytest.approx(jtm.skip_frac, abs=0)


def test_partial_fit_and_skip_frac_match_jax(engines):
    jeng, tengs = engines
    jspec = _jspec("head", "lfsr")
    jtm = japi.TM(jspec, engine=jeng, seed=2)
    ttm = tapi.TM(_tspec(jspec), engine=tengs[False], seed=2)
    ttm.program, ttm.prng = _bridge(jtm.program, jtm.prng)
    assert ttm.skip_frac is None and jtm.skip_frac is None
    x, y = _data(jspec, 20, 6)
    for lo, hi in ((0, 3), (3, 6), (6, 14)):
        want = jtm.partial_fit(x[lo:hi], y[lo:hi])
        got = ttm.partial_fit(x[lo:hi], y[lo:hi])
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
    assert ttm.skip_frac == jtm.skip_frac
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng)
    np.testing.assert_array_equal(ttm.predict(x).numpy(),
                                  np.asarray(jtm.predict(x)))


def test_bank_train_matches_single_steps_and_jax(engines):
    jeng, tengs = engines
    teng = tengs[True]        # banks take the dense update regardless
    kinds = ["coalesced", "vanilla", "head"]
    specs = [_jspec(k) for k in kinds]
    starts = [_start(jeng, s, seed=i) for i, s in enumerate(specs)]
    B = 6
    data = [_data(s, B, 10 + i) for i, s in enumerate(specs)]
    jbank = japi.stack([p for p, _ in starts], jeng,
                       prngs=[r for _, r in starts])
    bridged = [_bridge(p, r) for p, r in starts]
    tbank = tapi.stack([p for p, _ in bridged], teng,
                       prngs=[r for _, r in bridged])
    jl = jnp.stack([jeng.encode(s, jnp.asarray(d[0]))
                    for s, d in zip(specs, data)])
    tl = torch.stack([teng.encode(_tspec(s), d[0])
                      for s, d in zip(specs, data)])
    labels = np.stack([d[1] for d in data])
    for _ in range(2):
        jst = jbank.train(jl, jnp.asarray(labels))
        tst = tbank.train(tl, labels)
        for k in STAT_KEYS:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    assert teng.cache_report()["path_per_stage"]["train_bank_ta"] == "dense"
    for k in range(3):
        jp = jax.tree.map(lambda t: t[k], jbank.progs)
        jr = jax.tree.map(lambda t: t[k], jbank.prngs)
        _assert_same(tbank.swap_out(k), tbank.prngs[k], jp, jr, kinds[k])
        # the same program through two single steps
        p, r = bridged[k]
        for _ in range(2):
            p, r, _ = teng.train_step(p, r, tl[k], torch.from_numpy(
                labels[k]))
        for a, b in zip(p.leaves(), tbank.swap_out(k).leaves()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tapi.stack([p for p, _ in bridged], teng).train(tl, labels)


def test_server_train_matches_jax(engines):
    jeng, tengs = engines
    teng = tengs[True]
    roster = {"a": _jspec("coalesced"), "b": _jspec("regression", "lfsr")}
    jsrv, tsrv = JServer(jeng, batch_slot=8), TMServer(teng, batch_slot=8)
    for i, (name, spec) in enumerate(roster.items()):
        jp, jr = _start(jeng, spec, seed=20 + i)
        tp, tr = _bridge(jp, jr)
        jsrv.register(name, spec, program=jp, prng=jr)
        tsrv.register(name, _tspec(spec), program=tp, prng=tr)
    xs = {n: _data(s, 24, 30 + i) for i, (n, s) in enumerate(roster.items())}
    for srv in (jsrv, tsrv):          # build the stacked banks first
        for n, (x, _) in xs.items():
            srv.enqueue(n, x[:8])
        srv.flush()
    for step in range(2):
        for n, (x, y) in xs.items():
            sl = slice(8 * step, 8 * step + 8)
            assert tsrv.train(n, x[sl], y[sl]) == jsrv.train(n, x[sl], y[sl])
    # the stale bank slots are rewritten before the next flush
    for srv in (jsrv, tsrv):
        for n, (x, _) in xs.items():
            srv.enqueue(n, x[16:])
    want, got = jsrv.flush(), tsrv.flush()
    for n in roster:
        np.testing.assert_array_equal(got[n], np.asarray(want[n]))
        assert tsrv.skip_frac(n) == jsrv.skip_frac(n)
        _assert_same(tsrv.swap_out(n), tsrv.tenants[n].prng,
                     jsrv.swap_out(n), jsrv.tenants[n].prng, n)
        assert tsrv.tenants[n].steps == 2
    assert tsrv.stats()["skip_frac"] == jsrv.stats()["skip_frac"]
    with pytest.raises(ValueError):
        tsrv.train("a", xs["a"][0][:3], xs["a"][1][:3])


def test_fit_loop_equals_the_session(engines):
    """The host loop (one step per batch) and the staged session give
    the same history and program from the same start and shuffle."""
    from repro_torch.core.evaluate import fit_loop
    _, tengs = engines
    spec = _tspec(_jspec("vanilla", "lfsr"))
    x, y = _data(spec, 70, 8)
    a = tapi.TM(spec, engine=tengs[True], seed=6)
    b = tapi.TM(spec, engine=tengs[True], seed=6)
    want = a.fit(x, y, epochs=2, batch=16, rng=np.random.default_rng(1))
    got = fit_loop(b.partial_fit, x, y, epochs=2, batch=16,
                   rng=np.random.default_rng(1))
    assert got == want
    for u, v in zip(a.program.leaves() + a.prng.leaves(),
                    b.program.leaves() + b.prng.leaves()):
        assert torch.equal(u, v)
