"""The serving slice as a whole: the port's TMServer against the JAX one.

Both servers host the same tenants (JAX-lowered programs carried across
with ``convert.program_from_numpy``) and take the same requests; stacked
``flush`` answers, per-request ``predict`` answers, bank slots and the
swap round trips must agree exactly (CPU, plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.launch.serve_tm import TMServer as JServer
from repro_torch import api as tapi, convert
from repro_torch.core import threefry
from repro_torch.core.dtm import FIELDS
from repro_torch.core.types import TileConfig
from repro_torch.kernels import autotune
from repro_torch.launch.serve_tm import TMServer as TServer

_CALIB = np.random.default_rng(7).standard_normal((64, 4)).astype(np.float32)
ROSTER = {
    "cotm": japi.TMSpec.coalesced(features=18, classes=4, clauses=20, T=12),
    "vanilla": japi.TMSpec.vanilla(features=13, classes=3, clauses=6, T=8),
    "reg": japi.TMSpec.regression(features=18, clauses=16, T=10),
    "head": japi.TMSpec.head(_CALIB, classes=3, therm_bits=3, clauses=12,
                             T=9),
}


def _program(jeng, spec, seed):
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    j = cfg.include_threshold
    ta = rng.integers(0, j, (cfg.total_clauses, cfg.literals))
    for r in range(cfg.total_clauses):
        k = rng.integers(0, 4)
        ta[r, rng.choice(cfg.literals, k, replace=False)] = rng.integers(
            j, 2 * j, k)
    w = None
    if spec.kind in ("coalesced", "head"):
        w = jnp.asarray(rng.integers(-4, 5, (cfg.classes, cfg.clauses)),
                        jnp.int32)
    return jeng.lower(spec, jax.random.PRNGKey(seed),
                      ta=jnp.asarray(ta, jnp.int32), weights=w)


def _request(spec, n, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "head":
        return rng.standard_normal((n, _CALIB.shape[1])).astype(np.float32)
    return (rng.random((n, spec.features)) < 0.5).astype(np.int8)


def _leaves(jprog):
    return {f: np.asarray(getattr(jprog, f)) for f in FIELDS}


def _servers(batch_slot, seed=0):
    tile = japi.tile_for(*ROSTER.values(), x=32, y=16, m=16, n=4)
    jeng = japi.compile(tile, backend="ref")
    teng = tapi.compile(TileConfig(**dataclasses.asdict(tile)), device="cpu")
    js, ts = JServer(jeng, batch_slot=batch_slot), TServer(
        teng, batch_slot=batch_slot)
    for i, (name, spec) in enumerate(ROSTER.items()):
        jprog = _program(jeng, spec, seed + i)
        js.register(name, spec, program=jprog)
        ts.register(name, tapi.TMSpec.from_dict(spec.to_dict()),
                    program=convert.program_from_numpy(_leaves(jprog),
                                                       device="cpu"))
    return js, ts


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
        assert got[name].dtype.kind == np.asarray(want[name]).dtype.kind


def _assert_programs_equal(tprog, jprog):
    got = convert.program_to_numpy(tprog)
    for f, want in _leaves(jprog).items():
        np.testing.assert_array_equal(got[f], want, err_msg=f)


@pytest.mark.parametrize("batch_slot", [5, 32])
def test_stacked_flush_matches_jax(batch_slot):
    js, ts = _servers(batch_slot)
    rounds = [list(ROSTER), ["cotm", "head"], ["reg", "vanilla", "cotm"]]
    fired = 0
    for r, names in enumerate(rounds):
        for i, name in enumerate(names):
            n = batch_slot - (i % 3)          # ragged requests are padded
            x = _request(ROSTER[name], n, seed=10 * r + i)
            js.enqueue(name, x)
            ts.enqueue(name, x)
        pending = ts.flush_async()
        assert ts.stats()["queue_depth"] == 0
        want = js.flush()
        _assert_same(ts.collect(pending), want)
        fired += sum(int((np.asarray(v) != 0).sum()) for v in want.values())
    assert fired > 0, "answers must not all be class 0 / zero votes"
    st, sj = ts.stats(), js.stats()
    for key in ("requests", "stacked_launches", "coalesced_requests",
                "program_nbytes", "tenants"):
        assert st[key] == sj[key], key
    eng = ts.engine
    assert st["cache"]["path_per_stage"]["infer_bank"] == (
        autotune.planned_path("eval", batch_slot, (eng.L, eng.R, eng.H),
                              device="cpu"))
    assert set(st["last_flush_latency_s"]) == set(ROSTER)
    # bank slots read back to exactly the JAX server's programs
    jprogs, tprogs = js.unstack(), ts.unstack()
    for name in ROSTER:
        _assert_programs_equal(tprogs[name], jprogs[name])


@pytest.mark.parametrize("batch_slot", [1, 3])
def test_edge_predict_matches_jax(batch_slot):
    js, ts = _servers(batch_slot, seed=4)
    order = ["cotm", "cotm", "reg", "head", "vanilla", "cotm"]
    for i, name in enumerate(order):
        x = _request(ROSTER[name], batch_slot, seed=i)
        got, want = ts.predict(name, x), js.predict(name, x)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert ts.stats()["swaps"] == js.stats()["swaps"] == 5
    assert ts.engine.cache_report()["path_per_stage"]["infer"] == "packed_vpu"


def test_swap_round_trips_match_jax_and_copy():
    js, ts = _servers(8)
    for name in ROSTER:
        js.enqueue(name, _request(ROSTER[name], 8, 0))
        ts.enqueue(name, _request(ROSTER[name], 8, 0))
    _assert_same(ts.flush(), js.flush())
    # swap_out returns a copy: a later swap_in must not change it
    out = ts.swap_out("cotm")
    before = convert.program_to_numpy(out)
    new_j = _program(js.engine, ROSTER["cotm"], seed=99)
    js.swap_in("cotm", new_j)
    slot = ts.swap_in("cotm", convert.program_from_numpy(_leaves(new_j),
                                                         device="cpu"))
    assert slot == sorted(ROSTER).index("cotm")
    for f, a in convert.program_to_numpy(out).items():
        np.testing.assert_array_equal(a, before[f], err_msg=f)
    _assert_programs_equal(ts.swap_out("cotm"), js.swap_out("cotm"))
    for name in ROSTER:
        x = _request(ROSTER[name], 8, 1)
        js.enqueue(name, x)
        ts.enqueue(name, x)
    _assert_same(ts.flush(), js.flush())
    # every slot round-trips through swap_out/swap_in unchanged
    for name in ROSTER:
        prog = ts.swap_out(name)
        ts.swap_in(name, prog)
        _assert_programs_equal(ts.swap_out(name), js.swap_out(name))


def test_encoded_requests_and_empty_flush():
    _, ts = _servers(6)
    spec = ts.tenants["cotm"].spec
    x = _request(spec, 4, 3)
    ts.enqueue("cotm", x)
    plain = ts.flush()["cotm"]
    ts.enqueue("cotm", ts.engine.encode(spec, x), encoded=True)
    np.testing.assert_array_equal(ts.flush()["cotm"], plain)
    np.testing.assert_array_equal(
        ts.predict("cotm", ts.engine.encode(spec, x), encoded=True), plain)
    assert ts.flush_async() is None and ts.flush() == {}
    with pytest.raises(ValueError):
        ts.enqueue("cotm", _request(spec, 7, 0))
    # the conv kind registers, in its own bank on an engine with patch
    # slots, beside a flat tenant
    conv = tapi.TMSpec.conv(6, 6, 3, classes=2)
    with pytest.raises(ValueError, match="patch slots"):
        ts.register("conv", conv)       # this engine has one patch slot
    cs = TServer(tapi.compile(tapi.tile_for(spec, conv, x=32, y=16, m=16,
                                            n=4), device="cpu"),
                 batch_slot=6)
    cs.register("conv", conv, seed=1)
    cs.register("cotm", spec, seed=2)
    img = (np.random.default_rng(3).random((2, 6, 6)) < 0.5).astype(np.int8)
    cs.enqueue("conv", img)
    cs.enqueue("cotm", x)
    got = cs.flush()
    assert sorted(got) == ["conv", "cotm"] and got["conv"].shape == (2,)
    np.testing.assert_array_equal(got["conv"], cs.predict("conv", img))
    assert cs.stats()["stacked_launches"] == 2


def test_register_lowers_from_seed():
    _, ts = _servers(4)
    spec = tapi.TMSpec.coalesced(features=10, classes=2, clauses=8)
    ts.register("fresh", spec, seed=5)
    again = ts.engine.lower(spec, threefry.key(5, "cpu"))
    assert torch.equal(ts.tenants["fresh"].program.ta, again.ta)
    ts.enqueue("fresh", _request(spec, 4, 0))
    assert set(ts.flush()) == {"fresh"}
