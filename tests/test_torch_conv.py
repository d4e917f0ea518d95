"""The conv kind of the port against the JAX package, exactly (CPU).

Encoding (``to_bool``, ``encode`` with its padded patch slots), conv
inference (single program at B 1, 3 and 32, and a K=2 conv bank), conv
train steps under the counter and lfsr PRNGs (lfsr 4 with its seed
refresh firing, with and without it), ``TM.fit`` and ``partial_fit``,
the forced ``mxu`` clause path, a tie in the patch argmax, and the
``TMServer`` with a flat and a conv tenant resident together.  One JAX
engine (``backend="ref"``) per geometry, module-scoped: each new batch
shape or PRNG configuration retraces the JAX step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.prng import PRNG as JPRNG
from repro.launch.serve_tm import TMServer as JServer
from repro_torch import api as tapi
from repro_torch.core import threefry
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.core.types import TileConfig
from repro_torch.kernels import autotune
from repro_torch.launch.serve_tm import TMServer
from test_torch_train import _assert_same, _bridge


def _planned(eng, rows):
    """The seed plan's clause path for ``rows`` rows a program."""
    return autotune.planned_path("eval", rows, (eng.L, eng.R, eng.H),
                                 device="cpu")


def _conv(backend="counter", lfsr_bits=24, refresh=True, **kw):
    return japi.TMSpec.conv(6, 6, 3, classes=2, clauses=16, T=8,
                            prng_backend=backend, lfsr_bits=lfsr_bits,
                            seed_refresh=refresh, **kw)


# a second conv geometry with more patch slots (P = 4 · 6 = 24), so the
# engine pads the first one's 16 slots
WIDE = japi.TMSpec.conv(5, 7, 2, classes=3, clauses=12, T=6)
FLAT = japi.TMSpec.coalesced(features=10, classes=3, clauses=12, T=6)
TILE = dict(x=32, y=16, m=16, n=4)


def _tspec(jspec):
    return tapi.TMSpec.from_dict(jspec.to_dict())


def _images(spec, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, spec.img_h, spec.img_w)) < 0.5).astype(np.int8)


def _labels(spec, n, seed):
    return np.random.default_rng(seed).integers(0, spec.classes, n).astype(
        np.int32)


def _port_engine(jeng, **kw):
    return tapi.compile(TileConfig(**dataclasses.asdict(jeng.tile)),
                        device="cpu", rand_bits=jeng.rand_bits, **kw)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's default and forced-``mxu`` engines
    of one geometry holding both conv specs and the flat one."""
    jeng = japi.compile(japi.tile_for(_conv(), WIDE, FLAT, **TILE),
                        backend="ref")
    return jeng, _port_engine(jeng), _port_engine(jeng, kernel_path="mxu")


def _start(jeng, spec, seed):
    """A JAX program (TA states at the include threshold's edge, about
    two literals included a clause, so clauses fire) and PRNG, and the
    port's copies of them."""
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    shape = (cfg.total_clauses, cfg.literals)
    ta = cfg.include_threshold - 1 + (rng.random(shape) < 2 / shape[1])
    w = rng.integers(-3, 4, (cfg.classes, cfg.clauses))
    jprog = jeng.lower(spec, jax.random.PRNGKey(seed),
                       ta=jnp.asarray(ta, jnp.int32),
                       weights=jnp.asarray(w, jnp.int32))
    jprng = JPRNG.create(cfg, seed + 1)
    return jprog, jprng, *_bridge(jprog, jprng)


def _u32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_position_code_is_cached_and_read_only():
    a = tapi._position_code(6, 6, 3)
    assert a is tapi._position_code(6, 6, 3)
    assert not a.flags.writeable and a.dtype == np.int8
    np.testing.assert_array_equal(a, japi._position_code(6, 6, 3))


@pytest.mark.parametrize("geometry", [(6, 6, 3), (5, 7, 2), (4, 4, 4)])
def test_to_bool_matches_jax(geometry):
    spec = japi.TMSpec.conv(*geometry, classes=2)
    x = _images(spec, 3, sum(geometry))
    got = _tspec(spec).to_bool(x, device="cpu")
    want = np.asarray(spec.to_bool(jnp.asarray(x)))
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert got.shape == (3, spec.n_patches, spec.bool_features)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", [_conv(), WIDE], ids=["padded", "full"])
def test_encode_matches_jax_and_pads_patch_slots(engines, spec):
    jeng, teng, _ = engines
    x = _images(spec, 5, 1)
    got = teng.encode(_tspec(spec), x)
    assert got.shape == (5, teng.P, teng.W) and teng.P == WIDE.n_patches
    np.testing.assert_array_equal(got.numpy(),
                                  _u32(jeng.encode(spec, jnp.asarray(x))))
    assert not got[:, spec.n_patches:].any()


def test_lower_sets_p_mask_and_refuses_too_many_patches(engines):
    jeng, teng, _ = engines
    prog = teng.lower(_tspec(_conv()), threefry.key(0, "cpu"))
    want = np.asarray(jeng.lower(_conv(), jax.random.PRNGKey(0)).p_mask)
    np.testing.assert_array_equal(prog.p_mask.numpy(), want)
    assert int(prog.p_mask.sum()) == 16
    small = tapi.compile(tapi.tile_for(_tspec(FLAT), **TILE), device="cpu")
    with pytest.raises(ValueError, match="patch slots"):
        small.lower(_tspec(_conv()), threefry.key(0, "cpu"))


@pytest.mark.parametrize("B", [1, 3, 32])
def test_infer_conv_matches_jax(engines, B):
    jeng, teng, _ = engines
    spec = _conv()
    jprog, _, tprog, _ = _start(jeng, spec, seed=B)
    x = _images(spec, B, B + 1)
    jl = jeng.encode(spec, jnp.asarray(x))
    sums, cl = teng.infer_fn(_tspec(spec))(tprog, teng.encode(_tspec(spec),
                                                               x))
    js, jc = jeng.infer_conv(jprog, jl)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jc))
    assert int(cl.sum()) > 0
    # the clause stage runs on the [B·P, W] view: the plan of B·P rows
    assert teng.cache_report()["path_per_stage"]["infer_conv"] == (
        _planned(teng, B * teng.P))


def test_infer_conv_bank_matches_jax(engines):
    jeng, teng, _ = engines
    specs = [_conv(), WIDE]
    starts = [_start(jeng, s, seed=10 + i) for i, s in enumerate(specs)]
    xs = [_images(s, 4, 20 + i) for i, s in enumerate(specs)]
    jbank = japi.stack([s[0] for s in starts], jeng, conv=True)
    tbank = tapi.stack([s[2] for s in starts], teng, conv=True)
    js, jc = jbank.infer([jeng.encode(s, jnp.asarray(x))
                          for s, x in zip(specs, xs)])
    ts, tc = tbank.infer([teng.encode(_tspec(s), x)
                          for s, x in zip(specs, xs)])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert teng.cache_report()["path_per_stage"]["infer_conv_bank"] == (
        _planned(teng, 4 * teng.P))
    # each slot answers as its program does alone
    for k, (s, x) in enumerate(zip(specs, xs)):
        one, _ = teng.infer_conv(starts[k][2], teng.encode(_tspec(s), x))
        assert torch.equal(one, ts[k])
    with pytest.raises(ValueError):
        tbank.predict([teng.encode(_tspec(s), x) for s, x in zip(specs, xs)])
    with pytest.raises(ValueError):
        tbank.train(None, None)


@pytest.mark.parametrize("backend,lfsr_bits,refresh,steps", [
    ("counter", 24, True, 3), ("lfsr", 24, True, 3), ("lfsr", 12, False, 3),
    ("lfsr", 4, True, 5), ("lfsr", 4, False, 5)])
def test_train_conv_matches_jax(engines, backend, lfsr_bits, refresh, steps):
    jeng, teng, _ = engines
    spec = _conv(backend, lfsr_bits, refresh)
    tspec = _tspec(spec)
    jprog, jprng, tprog, tprng = _start(jeng, spec, seed=lfsr_bits)
    B = 8
    x, y = _images(spec, steps * B, 3), _labels(spec, steps * B, 4)
    for s in range(steps):
        xb, yb = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        jprog, jprng, jst = jeng.train_fn(spec)(
            jprog, jprng, jeng.encode(spec, jnp.asarray(xb)), jnp.asarray(yb))
        tprog, tprng, tst = teng.train_fn(tspec)(
            tprog, tprng, teng.encode(tspec, xb), torch.as_tensor(yb))
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(jst[k]) for k in STAT_KEYS}
        _assert_same(tprog, tprng, jprog, jprng, f"step {s}")
    if backend == "lfsr" and lfsr_bits == 4:
        # 4 draws a step of at most 2 cycles each: the refresh (every 15
        # cycles) fired when it is on, and never resets the count if off
        cycles = int(tprng.state.cycles)
        assert cycles < 15 if refresh else cycles >= 15
    assert teng.cache_report()["path_per_stage"]["train_conv"] == (
        _planned(teng, B * teng.P))


def test_train_conv_leaves_its_inputs(engines):
    jeng, teng, _ = engines
    spec = _tspec(_conv("lfsr"))
    _, _, prog, prng = _start(jeng, _conv("lfsr"), seed=3)
    before = [t.clone() for t in prog.leaves() + prng.leaves()]
    teng.train_conv(prog, prng, teng.encode(spec, _images(spec, 4, 0)),
                    torch.zeros(4, dtype=torch.int32))
    for a, b in zip(before, prog.leaves() + prng.leaves()):
        assert torch.equal(a, b)


def test_fit_matches_jax_history_and_program(engines):
    jeng, teng, _ = engines
    spec = _conv("lfsr")
    x, y = _images(spec, 40, 5), _labels(spec, 40, 6)
    xt, yt = _images(spec, 12, 7), _labels(spec, 12, 8)
    jtm = japi.TM(spec, engine=jeng, seed=4)
    ttm = tapi.TM(_tspec(spec), engine=teng, seed=4)
    jtm.program, jtm.prng, ttm.program, ttm.prng = _start(jeng, spec, 4)
    want = jtm.fit(x, y, epochs=1, batch=16, x_test=xt, y_test=yt,
                   rng=np.random.default_rng(2))
    got = ttm.fit(x, y, epochs=1, batch=16, x_test=xt, y_test=yt,
                  rng=np.random.default_rng(2))
    assert got == want and ttm.steps == jtm.steps == 2
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng)
    np.testing.assert_array_equal(ttm.predict(xt).numpy(),
                                  np.asarray(jtm.predict(xt)))
    assert ttm.score(xt, yt) == jtm.score(xt, yt)


def test_partial_fit_matches_jax(engines):
    jeng, teng, _ = engines
    spec = _conv()
    jtm = japi.TM(spec, engine=jeng, seed=6)
    ttm = tapi.TM(_tspec(spec), engine=teng, seed=6)
    jtm.program, jtm.prng, ttm.program, ttm.prng = _start(jeng, spec, 6)
    x, y = _images(spec, 16, 9), _labels(spec, 16, 10)
    for lo, hi in ((0, 8), (8, 16)):
        want, got = jtm.partial_fit(x[lo:hi], y[lo:hi]), \
            ttm.partial_fit(x[lo:hi], y[lo:hi])
        assert {k: int(v) for k, v in got.items()} == \
            {k: int(v) for k, v in want.items()}
    assert ttm.skip_frac == jtm.skip_frac
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng)


def test_forced_mxu_conv_matches_jax(engines):
    jeng, teng, teng_mxu = engines
    spec = _conv("lfsr")
    tspec = _tspec(spec)
    jprog, jprng, tprog, tprng = _start(jeng, spec, seed=8)
    x, y = _images(spec, 8, 11), _labels(spec, 8, 12)
    jl, tl = jeng.encode(spec, jnp.asarray(x)), teng.encode(tspec, x)
    sums, cl = teng_mxu.infer_conv(tprog, tl)
    js, jc = jeng.infer_conv(jprog, jl)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jc))
    jprog, jprng, jst = jeng.train_conv(jprog, jprng, jl, jnp.asarray(y))
    tprog, tprng, tst = teng_mxu.train_conv(tprog, tprng, tl,
                                            torch.as_tensor(y))
    assert {k: int(v) for k, v in tst.items()} == \
        {k: int(jst[k]) for k in STAT_KEYS}
    _assert_same(tprog, tprng, jprog, jprng)
    assert teng_mxu.cache_report()["path_per_stage"] == {
        "infer_conv": "mxu", "train_conv": "mxu", "train_conv_ta": "conv_ta"}


def test_torch_argmax_takes_the_first_maximum():
    v = torch.tensor([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0]])
    assert torch.argmax(v, dim=1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(v.numpy()), axis=1)).tolist() \
        == [1, 0]


def test_patch_argmax_ties_match_jax():
    """rand_bits 2 makes the patch noise 0..3, so among 16 patches whose
    clauses all fire (an empty clause fires in training) the perturbed
    argmax ties; the step must still equal the JAX step."""
    spec = _conv(rand_bits=2)
    tspec = _tspec(spec)
    jeng = japi.compile(japi.tile_for(spec, **TILE), backend="ref",
                        rand_bits=2)
    teng = _port_engine(jeng)
    cfg = spec.tm_config()
    ta = jnp.zeros((cfg.total_clauses, cfg.literals), jnp.int32)   # empty
    jprog = jeng.lower(spec, jax.random.PRNGKey(0), ta=ta)
    jprng = JPRNG.create(cfg, 5)
    tprog, tprng = _bridge(jprog, jprng)
    x, y = _images(spec, 4, 13), _labels(spec, 4, 14)
    tl = teng.encode(tspec, x)
    # the draws the step makes, replayed: ties in cl_p·1000 + noise
    p, _ = tprng.bits((4,))
    _, patch_rand = p.bits((4, teng.P, teng.R))
    cl_p, _ = teng._conv_clauses(tprog.map(lambda t: t[None]), tl[None],
                                 eval_mode=False, stage="probe")
    score = cl_p[0] * 1000 + (patch_rand % 997).to(torch.int32)
    ties = (score == score.amax(dim=1, keepdim=True)).sum(dim=1)
    assert int((ties > 1).sum()) > 0
    jprog, jprng, jst = jeng.train_conv(jprog, jprng,
                                        jeng.encode(spec, jnp.asarray(x)),
                                        jnp.asarray(y))
    tprog, tprng, tst = teng.train_conv(tprog, tprng, tl, torch.as_tensor(y))
    assert {k: int(v) for k, v in tst.items()} == \
        {k: int(jst[k]) for k in STAT_KEYS}
    _assert_same(tprog, tprng, jprog, jprng)


def test_server_with_flat_and_conv_tenants_matches_jax(engines):
    jeng, teng, _ = engines
    roster = {"flat": FLAT, "conv": _conv(), "wide": WIDE}
    slot = 6
    jsrv, tsrv = JServer(jeng, batch_slot=slot), TMServer(teng,
                                                          batch_slot=slot)
    for i, (name, spec) in enumerate(roster.items()):
        jp, jr, tp, tr = _start(jeng, spec, seed=30 + i)
        jsrv.register(name, spec, program=jp, prng=jr)
        tsrv.register(name, _tspec(spec), program=tp, prng=tr)

    def request(name, n, seed):
        spec = roster[name]
        if spec.kind == "conv":
            return _images(spec, n, seed)
        rng = np.random.default_rng(seed)
        return (rng.random((n, spec.features)) < 0.5).astype(np.int8)

    def flush_both(names, seed):
        for i, name in enumerate(names):
            x = request(name, slot - i % 3, seed + i)   # ragged, padded
            jsrv.enqueue(name, x)
            tsrv.enqueue(name, x)
        want, got = jsrv.flush(), tsrv.flush()
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                          err_msg=name)

    flush_both(list(roster), 0)
    flush_both(["conv"], 10)                 # the conv family alone
    flush_both(["wide", "flat"], 20)
    st, sj = tsrv.stats(), jsrv.stats()
    for key in ("requests", "stacked_launches", "coalesced_requests"):
        assert st[key] == sj[key], key
    assert st["cache"]["path_per_stage"]["infer_conv_bank"] == (
        _planned(teng, slot * teng.P))
    for i, name in enumerate(roster):        # edge requests, 1 row padded
        x = request(name, 1, 40 + i)
        np.testing.assert_array_equal(tsrv.predict(name, x),
                                      np.asarray(jsrv.predict(name, x)))
    # packed conv literals [n, P, W] pass through and are padded
    x = request("conv", 2, 50)
    enc = tsrv.engine.encode(_tspec(roster["conv"]), x)
    np.testing.assert_array_equal(tsrv.predict("conv", enc, encoded=True),
                                  tsrv.predict("conv", x))
    # on-line training of a conv and a flat tenant; stale slots rewritten
    for step in range(2):
        for i, name in enumerate(("conv", "flat")):
            x = request(name, slot, 60 + 2 * step + i)
            y = _labels(roster[name], slot, 70 + 2 * step + i)
            assert tsrv.train(name, x, y) == jsrv.train(name, x, y)
    flush_both(list(roster), 80)
    jprogs = {**jsrv.unstack(), **jsrv.unstack(conv=True)}
    tprogs = {**tsrv.unstack(), **tsrv.unstack(conv=True)}
    assert sorted(tprogs) == sorted(roster)
    assert sorted(tsrv.unstack(conv=True)) == ["conv", "wide"]
    for name in roster:
        _assert_same(tprogs[name], tsrv.tenants[name].prng, jprogs[name],
                     jsrv.tenants[name].prng, name)
    assert tsrv.tenants["conv"].steps == 2
