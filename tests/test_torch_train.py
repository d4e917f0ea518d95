"""Engine training of the port against the JAX package (CPU, exact).

A program and a PRNG made by the JAX package cross to the port through
``convert``; both then train on the same data.  After the steps every
program leaf, the PRNG state and every step stat must be equal: the four
flat kinds, edge (B <= 4) and fused fronts, both PRNG families, the
compacted and the dense TA update.  The entry points above the engine
are in ``test_torch_train_api.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.dtm import STAT_KEYS as J_STAT_KEYS
from repro_torch import api as tapi, convert
from repro_torch.core.dtm import FIELDS, STAT_KEYS
from test_torch_prng import jax_prng_numpy

_CALIB = np.random.default_rng(42).standard_normal((64, 5)).astype(np.float32)
KINDS = ("vanilla", "coalesced", "regression", "head")
BATCHES = (1, 3, 5, 32)


def _jspec(kind, backend="counter"):
    kw = dict(prng_backend=backend)
    if kind == "head":
        return japi.TMSpec.head(_CALIB, classes=3, therm_bits=3, clauses=40,
                                T=10, **kw)
    if kind == "regression":
        return japi.TMSpec.regression(features=21, clauses=40, T=12, **kw)
    if kind == "vanilla":
        return japi.TMSpec.vanilla(features=21, classes=3, clauses=14, T=8,
                                   **kw)
    return japi.TMSpec.coalesced(features=21, classes=4, clauses=48, T=16,
                                 **kw)


def _tspec(jspec):
    return tapi.TMSpec.from_dict(jspec.to_dict())


def _data(spec, n, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "head":
        x = rng.standard_normal((n, _CALIB.shape[1])).astype(np.float32)
    else:
        x = (rng.random((n, spec.features)) < 0.5).astype(np.int8)
    if spec.kind == "regression":
        return x, rng.random(n).astype(np.float32)
    return x, rng.integers(0, spec.classes, n).astype(np.int32)


@pytest.fixture(scope="module")
def engines():
    """One JAX engine (ref backend) and two port engines (skip on, off)
    of one geometry that fits every kind; 128-row clause groups so the
    engine's group stats and the compaction groups coincide."""
    tile = japi.tile_for(*(_jspec(k) for k in KINDS), x=32, y=128, m=128,
                         n=4)
    ttile = tapi.tile_for(*(_tspec(_jspec(k)) for k in KINDS), x=32, y=128,
                          m=128, n=4)
    return (japi.compile(tile, backend="ref"),
            {skip: tapi.compile(ttile, device="cpu", skip=skip)
             for skip in (True, False)})


def _bridge(jprog, jprng):
    return (convert.program_from_numpy(
                {f: np.asarray(getattr(jprog, f)) for f in FIELDS},
                device="cpu"),
            convert.prng_from_numpy(jax_prng_numpy(jprng), device="cpu"))


def _assert_same(tprog, tprng, jprog, jprng, what=""):
    got = convert.program_to_numpy(tprog)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jprog, f)),
                                      err_msg=f"{what} {f}")
    want = jax_prng_numpy(jprng)
    for k, v in convert.prng_to_numpy(tprng).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=f"{what} prng {k}")


def _start(jeng, spec, seed):
    jtm = japi.TM(spec, engine=jeng, seed=seed)
    return jtm.program, jtm.prng


def test_stat_keys_match():
    assert STAT_KEYS == J_STAT_KEYS


@pytest.mark.parametrize("backend", ["counter", "lfsr"])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax(engines, kind, B, backend):
    jeng, tengs = engines
    skip = (KINDS.index(kind) + BATCHES.index(B)) % 2 == 0
    teng = tengs[skip]
    jspec = _jspec(kind, backend)
    tspec = _tspec(jspec)
    jprog, jprng = _start(jeng, jspec, seed=B)
    tprog, tprng = _bridge(jprog, jprng)
    x, y = _data(jspec, 3 * B, seed=B + 7)
    for s in range(3):
        xb, yb = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        jprog, jprng, jst = jeng.train_step(
            jprog, jprng, jeng.encode(jspec, jnp.asarray(xb)),
            jspec.encode_labels(jnp.asarray(yb)))
        tprog, tprng, tst = teng.train_step(
            tprog, tprng, teng.encode(tspec, xb), tspec.encode_labels(yb))
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(v) for k, v in jst.items()}, (kind, B, s)
    _assert_same(tprog, tprng, jprog, jprng, f"{kind} B={B} {backend}")
    paths = teng.cache_report()["path_per_stage"]
    assert paths["train"] == ("packed_vpu" if B <= 4 else "fused")
    assert paths["train_ta"] == ("compact" if skip else "dense")
    assert paths["train_prng"] == f"{backend}-inkernel"


def test_training_moves_the_program(engines):
    """The parity cases above are not vacuous: states and weights move
    and clauses get selected."""
    _, tengs = engines
    teng = tengs[True]
    spec = _tspec(_jspec("coalesced"))
    cfg = spec.tm_config()
    ta = np.full((cfg.total_clauses, cfg.literals), cfg.include_threshold - 1)
    ta[::2, :2] = cfg.include_threshold       # some one-literal clauses
    tprog = teng.lower(spec, ta=ta, weights=np.ones((cfg.classes,
                                                     cfg.clauses)))
    tprng = tapi.TM(spec, engine=teng).prng
    x, y = _data(spec, 32, 1)
    new, _, st = teng.train_step(tprog, tprng, teng.encode(spec, x),
                                 torch.from_numpy(y))
    assert int(st["selected"]) > 0 and int(st["active_groups"]) > 0
    assert not torch.equal(new.ta, tprog.ta)
    assert not torch.equal(new.weights, tprog.weights)
    assert not torch.equal(new.inc, tprog.inc)
    assert torch.equal(teng.refresh_include(new).inc, new.inc)


def test_forced_path_trains_the_same(engines):
    _, tengs = engines
    spec = _tspec(_jspec("coalesced"))
    forced = tapi.compile(tengs[True].tile, device="cpu",
                          kernel_path="mxu_popcount")
    tm = tapi.TM(spec, engine=tengs[True], seed=4)
    x, y = _data(spec, 8, 4)
    lits, lab = forced.encode(spec, x), spec.encode_labels(y)
    a = tengs[True].train_step(tm.program, tm.prng, lits, lab)
    b = forced.train_step(tm.program, tm.prng, lits, lab)
    assert forced.cache_report()["path_per_stage"]["train"] == "mxu_popcount"
    for u, v in zip(a[0].leaves(), b[0].leaves()):
        assert torch.equal(u, v)


def test_steps_leave_their_inputs_alone(engines):
    _, tengs = engines
    spec = _tspec(_jspec("coalesced", "lfsr"))
    tm = tapi.TM(spec, engine=tengs[True], seed=1)
    before = [t.clone() for t in tm.program.leaves() + tm.prng.leaves()]
    x, y = _data(spec, 5, 2)
    tengs[True].train_step(tm.program, tm.prng, tengs[True].encode(spec, x),
                           torch.from_numpy(y))
    for a, b in zip(before, tm.program.leaves() + tm.prng.leaves()):
        assert torch.equal(a, b)


def test_fit_epochs_leaves_what_the_caller_holds(engines):
    """The fit updates TA states in place, but only the session's own
    copy: the bound program and a state handed out between fits stay as
    they were, and the fit equals the same steps taken one by one."""
    _, tengs = engines
    teng = tengs[True]
    spec = _tspec(_jspec("coalesced", "lfsr"))
    tm = tapi.TM(spec, engine=teng, seed=2)
    x, y = _data(spec, 24, 3)
    before = [t.clone() for t in tm.program.leaves()]
    session = teng.bind(tm.program, x, y, spec=spec, prng=tm.prng)
    session.fit_epochs(1, batch=8, rng=np.random.default_rng(0))
    held = session.state()[0]
    held_copy = [t.clone() for t in held.leaves()]
    session.fit_epochs(1, batch=8, rng=np.random.default_rng(1))
    for a, b in zip(tm.program.leaves(), before):
        assert torch.equal(a, b)
    for a, b in zip(held.leaves(), held_copy):
        assert torch.equal(a, b)
    prog, prng = tm.program, tm.prng
    lits, lab = teng.encode(spec, x), spec.encode_labels(y)
    for seed in (0, 1):
        plan = np.random.default_rng(seed).permutation(24).reshape(3, 8)
        for ib in plan:
            prog, prng, _ = teng.train_step(prog, prng, lits[ib], lab[ib])
    for a, b in zip(session.state()[0].leaves(), prog.leaves()):
        assert torch.equal(a, b)
    assert not torch.equal(prog.ta, tm.program.ta)
