"""The session and bank executables of the port against the JAX package
(CPU, exact).

On the card an epoch, a session step and a bank flush replay CUDA graphs
(``repro_torch.core.graph``); on the CPU the same step and flush bodies
run eagerly over the same static buffers.  So these tests, which hold
the bodies against the JAX package's session executables, also hold
what the card replays: ``_fit_epoch_impl`` / ``_fit_epoch_conv_impl``
against JAX's (program, PRNG, per-step stats), ``TM.fit`` histories,
``TMSession.dispatches`` and ``conv``, ``cache_report``'s stage keys,
the aliasing contract of handed-out states, and the flush body across
``swap_in``.  One JAX engine (``backend="ref"``), module-scoped.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.prng import PRNG as JPRNG
from repro_torch import api as tapi
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.core.graph import StepGraph
from repro_torch.core.types import TileConfig
from repro_torch.kernels import ops
from test_torch_train import _assert_same, _bridge

FLAT = japi.TMSpec.coalesced(features=12, classes=3, clauses=20, T=8,
                             prng_backend="lfsr", lfsr_bits=12)
FLAT_TF = japi.TMSpec.coalesced(features=12, classes=3, clauses=20, T=8,
                                prng_backend="threefry")
CONV = japi.TMSpec.conv(6, 6, 3, classes=2, clauses=16, T=8,
                        prng_backend="lfsr", lfsr_bits=12)
TILE = dict(x=32, y=16, m=16, n=4)
# the settings whose step bodies are held against JAX's epoch
SETTINGS = {"compacted": (FLAT, {}), "skip_off": (FLAT, {"skip": False}),
            "conv": (CONV, {}), "threefry": (FLAT_TF, {})}


def _tspec(jspec):
    return tapi.TMSpec.from_dict(jspec.to_dict())


def _data(spec, n, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "conv":
        x = (rng.random((n, spec.img_h, spec.img_w)) < 0.5).astype(np.int8)
    else:
        x = (rng.random((n, spec.features)) < 0.5).astype(np.int8)
    return x, rng.integers(0, spec.classes, n).astype(np.int32)


@pytest.fixture(scope="module")
def jeng():
    return japi.compile(japi.tile_for(FLAT, CONV, **TILE), backend="ref")


def _port(jeng, **kw):
    return tapi.compile(TileConfig(**dataclasses.asdict(jeng.tile)),
                        device="cpu", rand_bits=jeng.rand_bits, **kw)


def _start(jeng, spec, seed):
    """A JAX program with a few literals included a clause (so clauses
    fire), its PRNG, and the port's copies of both."""
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    shape = (cfg.total_clauses, cfg.literals)
    ta = cfg.include_threshold - 1 + (rng.random(shape) < 3 / shape[1])
    w = rng.integers(-3, 4, (cfg.classes, cfg.clauses))
    jprog = jeng.lower(spec, jax.random.PRNGKey(seed),
                       ta=jnp.asarray(ta, jnp.int32),
                       weights=jnp.asarray(w, jnp.int32))
    jprng = JPRNG.create(cfg, seed + 1)
    return jprog, jprng, *_bridge(jprog, jprng)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_epoch_body_matches_jax_fit_epoch(jeng, setting):
    """The port's epoch (the captured step's body run per batch of the
    plan) against JAX's ``lax.scan`` epoch: program, PRNG and every
    step's stats, over two epochs."""
    spec, kw = SETTINGS[setting]
    teng, tspec = _port(jeng, **kw), _tspec(spec)
    jprog, jprng, tprog, tprng = _start(jeng, spec, 3)
    x, y = _data(spec, 45, 4)
    jl, jy = jeng.encode(spec, jnp.asarray(x)), spec.encode_labels(y)
    tl, ty = teng.encode(tspec, x), tspec.encode_labels(y)
    conv = spec.kind == "conv"
    jfit = jeng._fit_epoch_conv if conv else jeng._fit_epoch
    tfit = teng._fit_epoch_conv_impl if conv else teng._fit_epoch_impl
    rng = np.random.default_rng(5)
    for _ in range(2):
        idx = rng.permutation(45)[:40].reshape(5, 8)
        jprog, jprng, jst = jfit(jprog, jprng, jl, jy,
                                 jnp.asarray(idx, jnp.int32))
        tprog, tprng, tst = tfit(tprog, tprng, tl, ty, idx)
        assert tst.shape == (5, len(STAT_KEYS)) and tst.dtype == torch.int32
        for i, k in enumerate(STAT_KEYS):
            np.testing.assert_array_equal(tst[:, i].numpy(),
                                          np.asarray(jst[k]), err_msg=k)
        _assert_same(tprog, tprng, jprog, jprng, setting)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fit_through_the_session_matches_jax(jeng, setting):
    spec, kw = SETTINGS[setting]
    teng = _port(jeng, **kw)
    x, y = _data(spec, 40, 6)
    jtm = japi.TM(spec, engine=jeng, seed=7)
    ttm = tapi.TM(_tspec(spec), engine=teng, seed=7)
    jtm.program, jtm.prng, ttm.program, ttm.prng = _start(jeng, spec, 7)
    want = jtm.fit(x, y, epochs=2, batch=8, rng=np.random.default_rng(1))
    got = ttm.fit(x, y, epochs=2, batch=8, rng=np.random.default_rng(1))
    assert got == want and ttm.steps == jtm.steps == 10
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, setting)


@pytest.mark.parametrize("spec", [FLAT, CONV], ids=["flat", "conv"])
def test_dispatches_and_conv_match_jax(jeng, spec):
    """``dispatches`` counts JAX's host-device round trips: one per epoch
    and one per ``step()``; ``replays`` counts graph launches, none on
    the CPU; ``conv`` is JAX's."""
    teng = _port(jeng)
    jprog, jprng, tprog, tprng = _start(jeng, spec, 8)
    x, y = _data(spec, 24, 9)
    js = jeng.bind(jprog, x, y, spec=spec, prng=jprng)
    ts = teng.bind(tprog, x, y, spec=_tspec(spec), prng=tprng)
    assert ts.conv == js.conv == (spec.kind == "conv")
    assert ts.dispatches == js.dispatches == 0
    js.fit_epochs(3, batch=8, rng=np.random.default_rng(2))
    ts.fit_epochs(3, batch=8, rng=np.random.default_rng(2))
    assert ts.dispatches == js.dispatches == 3
    for i in range(2):
        js.step(x[i:i + 2], y[i:i + 2])
        ts.step(x[i:i + 2], y[i:i + 2])
    assert ts.dispatches == js.dispatches == 5
    assert ts.steps == js.steps == 11 and ts.replays == 0
    _assert_same(*ts.state(), *js.state())


def test_conv_property_of_a_specless_session(jeng):
    teng = _port(jeng)
    _, _, tprog, tprng = _start(jeng, FLAT, 1)
    jprog, jprng, _, _ = _start(jeng, FLAT, 1)
    assert teng.bind(tprog, prng=tprng).conv is False
    assert jeng.bind(jprog, prng=jprng).conv is False


def test_cache_report_keeps_jax_stage_keys(jeng):
    """Every JAX stage executable key, counting captured graphs: none on
    the CPU, whatever ran."""
    teng = _port(jeng)
    _, _, tprog, tprng = _start(jeng, FLAT, 2)
    x, y = _data(FLAT, 16, 3)
    tm = tapi.TM(_tspec(FLAT), engine=teng)
    tm.program, tm.prng = tprog, tprng
    tm.fit(x, y, epochs=1, batch=8)
    tm.partial_fit(x[:2], y[:2])
    tapi.stack([tm.program, tm.program], teng).predict(
        teng.encode(_tspec(FLAT), x[:4]).expand(2, -1, -1))
    got, want = teng.cache_report(), jeng.cache_report()
    assert set(got) == set(want)
    assert all(v == 0 for k, v in got.items() if k != "path_per_stage")
    assert got["path_per_stage"]["train"] == "packed_vpu"
    assert teng.graph_report() == [] and not teng.graphed


def test_session_step_equals_the_engine_step(jeng):
    """``TMSession.step`` (the step body at its batch shape) equals the
    eager ``train_step`` at B=1 and B=5, stats included."""
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    _, _, prog, prng = _start(jeng, FLAT, 4)
    session = teng.bind(prog, spec=tspec, prng=prng)
    x, y = _data(FLAT, 12, 5)
    for lo, hi in ((0, 1), (1, 6), (6, 7), (7, 12)):
        lits, lab = teng.encode(tspec, x[lo:hi]), tspec.encode_labels(
            y[lo:hi])
        prog, prng, want = teng.train_step(prog, prng, lits, lab)
        got = session.step(x[lo:hi], y[lo:hi])
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
        for a, b in zip(session.program.leaves() + session.prng.leaves(),
                        prog.leaves() + prng.leaves()):
            assert torch.equal(a, b)


def test_held_state_never_changes(jeng):
    """A (program, PRNG) handed out by ``state()`` or read off
    ``TM.program`` is a copy that no later step or epoch writes."""
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    _, _, prog, prng = _start(jeng, FLAT, 5)
    x, y = _data(FLAT, 24, 6)
    session = teng.bind(prog, x, y, spec=tspec, prng=prng)
    held = [session.state()]
    session.step(x[:3], y[:3])
    held.append(session.state())
    session.fit_epochs(1, batch=8)
    held.append(session.state())
    copies = [[t.clone() for t in p.leaves() + r.leaves()] for p, r in held]
    session.step(x[3:6], y[3:6])
    session.fit_epochs(2, batch=8)
    session.step(x[:1], y[:1])
    for (p, r), c in zip(held, copies):
        assert all(torch.equal(a, b) for a, b in zip(
            p.leaves() + r.leaves(), c))
    tm = tapi.TM(tspec, engine=teng)
    tm.program, tm.prng = prog, prng
    tm.partial_fit(x[:2], y[:2])
    tm_held = (tm.program, tm.prng)
    c = [t.clone() for t in tm_held[0].leaves() + tm_held[1].leaves()]
    tm.partial_fit(x[2:4], y[2:4])
    tm.fit(x, y, epochs=1, batch=8)
    assert all(torch.equal(a, b) for a, b in zip(
        tm_held[0].leaves() + tm_held[1].leaves(), c))


def test_a_rebound_state_is_copied_in(jeng):
    """The other direction: a caller who rebinds the session (or the
    estimator) to another program and PRNG trains from those, not from
    what the step buffers last held."""
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    _, _, p1, r1 = _start(jeng, FLAT, 6)
    _, _, p2, r2 = _start(jeng, FLAT, 9)
    x, y = _data(FLAT, 8, 7)
    session = teng.bind(p1, spec=tspec, prng=r1)
    session.step(x[:2], y[:2])
    session.program, session.prng = p2, r2
    session.step(x[2:4], y[2:4])
    want = teng.train_step(p2, r2, teng.encode(tspec, x[2:4]),
                           tspec.encode_labels(y[2:4]))
    for a, b in zip(session.program.leaves() + session.prng.leaves(),
                    want[0].leaves() + want[1].leaves()):
        assert torch.equal(a, b)
    # and back to the first lineage: its state comes in again
    session.program, session.prng = p1, r1
    session.step(x[4:6], y[4:6])
    want = teng.train_step(p1, r1, teng.encode(tspec, x[4:6]),
                           tspec.encode_labels(y[4:6]))
    for a, b in zip(session.program.leaves() + session.prng.leaves(),
                    want[0].leaves() + want[1].leaves()):
        assert torch.equal(a, b)


def test_flush_body_answers_equal_predict_bank_across_swap_in(jeng):
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    progs = [_start(jeng, FLAT, s)[2] for s in (10, 11, 12)]
    bank = tapi.stack(progs[:2], teng)
    x, _ = _data(FLAT, 10, 8)
    lits = [teng.encode(tspec, x[:5]), teng.encode(tspec, x[5:])]
    answers = []
    for k, prog in ((None, None), (0, progs[2]), (1, progs[0]),
                    (0, progs[1])):
        if k is not None:
            bank.swap_in(k, prog)
        got = bank.predict(lits)
        want = teng.predict_bank(bank.progs, lits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got_i = bank.infer(torch.stack(lits))
        want_i = teng.infer_bank(bank.progs, torch.stack(lits))
        assert all(torch.equal(a, b) for a, b in zip(got_i, want_i))
        answers.append((got, [t.clone() for t in got]))
    for got, copy in answers:       # a later flush wrote none of them
        assert all(torch.equal(a, b) for a, b in zip(got, copy))
    assert not torch.equal(answers[0][0][1], answers[1][0][1])


def test_conv_flush_body_equals_infer_conv_bank_across_swap_in(jeng):
    teng = _port(jeng)
    tspec = _tspec(CONV)
    progs = [_start(jeng, CONV, s)[2] for s in (13, 14)]
    bank = tapi.stack(progs, teng, conv=True)
    x, _ = _data(CONV, 6, 9)
    lits = [teng.encode(tspec, x[:3]), teng.encode(tspec, x[3:])]
    for k, prog in ((None, None), (1, progs[0]), (0, progs[1])):
        if k is not None:
            bank.swap_in(k, prog)
        got = bank.infer(lits)
        want = teng.infer_conv_bank(bank.progs, lits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_bank_rebuilt_by_train_serves_its_new_programs(jeng):
    """``ProgramBank.train`` writes the new programs into the bank's own
    tensors: the next flush reads those through the bank's one flush
    graph (no new graph), and an answer taken before stays as it was."""
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    starts = [_start(jeng, FLAT, s) for s in (15, 16)]
    bank = tapi.stack([s[2] for s in starts], teng,
                      prngs=[s[3] for s in starts])
    x, y = _data(FLAT, 16, 10)
    lits = torch.stack([teng.encode(tspec, x[:8]),
                        teng.encode(tspec, x[8:])])
    before = bank.predict(lits)
    for _ in range(3):
        bank.train(lits, np.stack([y[:8], y[8:]]))
    after = bank.predict(lits)
    want = teng.predict_bank(bank.progs, lits)
    assert all(torch.equal(a, b) for a, b in zip(after, want))
    assert len(bank._flush_graphs) == 1
    assert before is not after


def test_step_graph_runs_its_body_eagerly_off_the_card():
    """Without capture ``run(n)`` is n eager calls of the body over the
    buffers; nothing is captured or counted."""
    calls = []
    buf = {"x": torch.zeros(3, dtype=torch.int64)}

    def body(b):
        calls.append(1)
        b["x"].add_(1)

    g = StepGraph("train", body, buf, capture=False, registry={})
    before = ops.launch_counts()
    g.run(4)
    assert calls == [1] * 4 and torch.equal(buf["x"], torch.full((3,), 4))
    assert g.graph is None and g.replays == 0 and g.launches == {}
    assert ops.launch_counts() == before
    g.mark("state", buf["x"])
    assert g.holds("state", buf["x"]) and not g.holds("state", g)
    g.run()                      # a run writes the state: the mark goes
    assert not g.holds("state", buf["x"])


def test_a_run_that_raises_leaves_no_stale_state_mark():
    """A body that fails part way has written some of the buffers: the
    next caller must copy its state in again, not trust the old mark."""
    buf = {"x": torch.zeros(2, dtype=torch.int64)}

    def body(b):
        b["x"].add_(1)
        raise RuntimeError("part way")

    g = StepGraph("train", body, buf, capture=False, registry={})
    g.mark("state", buf["x"])
    with pytest.raises(RuntimeError):
        g.run()
    assert not g.holds("state", buf["x"])


def test_launch_counts_set_and_add():
    ops.reset_launch_counts()
    ops.add_launches({"fused_step": 2, "lfsr_bits": 3}, times=4)
    counts = ops.launch_counts()
    assert counts["fused_step"] == 8 and counts["lfsr_bits"] == 12
    assert sum(counts.values()) == 20
    ops.set_launch_counts({k: 1 for k in counts})
    assert set(ops.launch_counts().values()) == {1}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_sessions_sharing_a_step_graph_from_threads(jeng):
    """Eight estimators on one engine share its step graph (one set of
    static buffers) and take steps from eight threads at once, with a
    short switch interval: each must end where its own eager chain of
    steps ends (a lost or crossed update would break it)."""
    import sys
    import threading
    teng = _port(jeng)
    tspec = _tspec(FLAT)
    x, y = _data(FLAT, 12, 11)
    starts = [_start(jeng, FLAT, 40 + i)[2:] for i in range(8)]
    tms = []
    for p, r in starts:
        tm = tapi.TM(tspec, engine=teng)
        tm.program, tm.prng = p, r
        tms.append(tm)
    errors = []

    def work(tm):
        try:
            for i in range(0, 12, 2):
                tm.partial_fit(x[i:i + 2], y[i:i + 2])
        except Exception as e:            # reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(tm,)) for tm in tms]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for tm, (p, r) in zip(tms, starts):
        for i in range(0, 12, 2):
            p, r, _ = teng.train_step(p, r, teng.encode(tspec, x[i:i + 2]),
                                      tspec.encode_labels(y[i:i + 2]))
        for a, b in zip(tm.program.leaves() + tm.prng.leaves(),
                        p.leaves() + r.leaves()):
            assert torch.equal(a, b)
