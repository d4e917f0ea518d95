"""The served stage executables of the port against the JAX package (CPU,
exact).

On the card single-program inference (``DTMEngine.served_infer``:
``TM.predict``, ``TMServer.predict``, the server's cold path), a served
train step (``TMServer.train`` through ``DTMEngine._session_step``) and
a bank train step (``ProgramBank.train``, in place) each replay a CUDA
graph; on the CPU the same bodies run eagerly over the same static
buffers.  So these tests, which hold the bodies against the JAX
package, also hold what the card replays: the inference body against
JAX's ``infer`` / ``infer_conv`` (and that it never reads the TA
states), the whole served sequence of ``chip_smoke.py``'s phase 17
against the JAX servers and bank (answers, steps, programs, PRNGs, and
JAX's ``cache_report`` after it), the bank's in-place training, the
restack at an unchanged K and the JAX keys of list-fed flushes.  One
JAX engine per geometry (``backend="ref"``), module-scoped.
"""
import dataclasses
import importlib.util
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.prng import PRNG as JPRNG
from repro.launch.serve_tm import TMServer as JServer
from repro_torch import api as tapi
from repro_torch.core.dtm import FIELDS, GRAPH_STAGES, INFER_LEAVES
from repro_torch.core.prng import PRNG
from repro_torch.core.types import TileConfig
from repro_torch.launch.serve_tm import TMServer
from test_torch_train import _assert_same, _bridge

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()

B = 8
# the flat roster of the served sequence: one tenant a PRNG family, two
# lfsr ones (phase 17's backends, at small widths)
FLAT = {
    "a": japi.TMSpec.coalesced(features=14, classes=3, clauses=20, T=8,
                               prng_backend="lfsr", lfsr_bits=12),
    "b": japi.TMSpec.vanilla(features=14, classes=3, clauses=8, T=6,
                             prng_backend="counter"),
    "c": japi.TMSpec.coalesced(features=12, classes=4, clauses=16, T=8,
                               prng_backend="threefry"),
    "d": japi.TMSpec.coalesced(features=10, classes=2, clauses=12, T=6,
                               prng_backend="lfsr", lfsr_bits=12),
}
CONV = japi.TMSpec.conv(6, 6, 3, classes=2, clauses=16, T=8,
                        prng_backend="lfsr", lfsr_bits=12)
TILE = dict(x=32, y=16, m=16, n=4)


def _tspec(jspec):
    return tapi.TMSpec.from_dict(jspec.to_dict())


def _x(spec, n, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "conv":
        return (rng.random((n, spec.img_h, spec.img_w)) < 0.5).astype(np.int8)
    return (rng.random((n, spec.features)) < 0.5).astype(np.int8)


def _y(spec, n, seed):
    return np.random.default_rng(seed).integers(
        0, spec.classes, n).astype(np.int32)


def _jax_engines():
    """One JAX engine for the flat roster, one for the conv spec."""
    return (japi.compile(japi.tile_for(*FLAT.values(), **TILE),
                         backend="ref"),
            japi.compile(japi.tile_for(CONV, **TILE), backend="ref"))


@pytest.fixture(scope="module")
def jengs():
    return _jax_engines()


def _port(jeng):
    return tapi.compile(TileConfig(**dataclasses.asdict(jeng.tile)),
                        device="cpu", rand_bits=jeng.rand_bits)


def _jprog(jeng, spec, seed):
    """A JAX program with a few literals included a clause (so clauses
    fire and answers differ)."""
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    shape = (cfg.total_clauses, cfg.literals)
    ta = cfg.include_threshold - 1 + (rng.random(shape) < 3 / shape[1])
    w = None
    if spec.kind in ("coalesced", "conv"):
        w = jnp.asarray(rng.integers(-3, 4, (cfg.classes, cfg.clauses)),
                        jnp.int32)
    return jeng.lower(spec, jax.random.PRNGKey(seed),
                      ta=jnp.asarray(ta, jnp.int32), weights=w)


def _np(v):
    """An answer or stats of either package as numpy (dicts by key)."""
    if isinstance(v, dict):
        return {k: _np(a) for k, a in v.items()}
    if isinstance(v, tuple):
        return tuple(_np(a) for a in v)
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _assert_equal(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_equal(got[k], want[k], f"{what} {k}")
    elif isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{what} {i}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("conv", [False, True], ids=["flat", "conv"])
@pytest.mark.parametrize("b", [1, B])
def test_infer_body_matches_jax_and_ignores_the_ta(jengs, conv, b):
    """``served_infer`` (the body the card replays) equals JAX's
    ``infer`` / ``infer_conv``; the graph holds only the leaves of
    ``INFER_LEAVES``, so a program whose other leaves are garbage gives
    the same answers."""
    jeng = jengs[1] if conv else jengs[0]
    spec = CONV if conv else FLAT["a"]
    teng, tspec = _port(jeng), _tspec(spec)
    jprog = _jprog(jeng, spec, 3)
    tprog, _ = _bridge(jprog, JPRNG.create(spec.tm_config(), 1))
    x = _x(spec, b, 4)
    jfn = jeng.infer_conv if conv else jeng.infer
    jsums, jcl = jfn(jprog, jeng.encode(spec, jnp.asarray(x)))
    lits = teng.encode(tspec, x)
    sums, cl = teng.served_infer(tspec, tprog, lits)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(cl.numpy(), np.asarray(jcl))
    assert cl.sum() > 0
    gen = torch.Generator().manual_seed(5)

    def garbage(t):
        if t.dtype == torch.bool:
            return torch.randint(0, 2, t.shape, generator=gen).bool()
        return torch.randint(0, 100, t.shape, generator=gen).to(t.dtype)
    bad = dataclasses.replace(tprog, **{f: garbage(getattr(tprog, f))
                                        for f in FIELDS
                                        if f not in INFER_LEAVES})
    sums2, cl2 = teng.served_infer(tspec, bad, lits)
    assert torch.equal(sums2, sums) and torch.equal(cl2, cl)
    stage = "infer_conv" if conv else "infer"
    (key, graph), = teng._graphs.items()
    assert key[0] == stage and graph.stage == stage
    assert set(graph.bufs) == set(INFER_LEAVES) | {"lits", "sums", "cl"}
    # the answers handed out are copies: a later request leaves them
    teng.served_infer(tspec, tprog, teng.encode(tspec, _x(spec, b, 9)))
    assert torch.equal(sums2, sums) and torch.equal(cl2, cl)


def _roster(jengs, seed=0):
    """Both packages' servers (flat and conv) over the same programs and
    PRNGs, a K=3 train-capable bank of each, and the calls' data."""
    jflat, jconv = jengs
    tflat, tconv = _port(jflat), _port(jconv)
    js, ts = JServer(jflat, batch_slot=B), TMServer(tflat, batch_slot=B)
    jcs, tcs = JServer(jconv, batch_slot=B), TMServer(tconv, batch_slot=B)
    for i, (n, spec) in enumerate(FLAT.items()):
        jp = _jprog(jflat, spec, seed + i)
        js.register(n, spec, program=jp, seed=seed + i)
        ts.register(n, _tspec(spec), program=_bridge(
            jp, JPRNG.create(spec.tm_config(), 1))[0], seed=seed + i)
    for i, n in enumerate(("p", "q")):
        jp = _jprog(jconv, CONV, seed + 10 + i)
        jcs.register(n, CONV, program=jp, seed=seed + 10 + i)
        tcs.register(n, _tspec(CONV), program=_bridge(
            jp, JPRNG.create(CONV.tm_config(), 1))[0], seed=seed + 10 + i)
    # the bank: three flat programs with counter PRNGs
    bspec = dataclasses.replace(FLAT["a"], prng_backend="counter")
    jp = [_jprog(jflat, FLAT[n], seed + 20 + i)
          for i, n in enumerate("abc")]
    jr = [JPRNG.create(bspec.tm_config(), seed + 30 + i) for i in range(3)]
    tp = [_bridge(p, r) for p, r in zip(jp, jr)]
    jbank = japi.stack(jp, jflat, prngs=jr)
    tbank = tapi.stack([p for p, _ in tp], tflat, prngs=[r for _, r in tp])
    xs = {n: _x(FLAT[n], B, seed + 40 + i) for i, n in enumerate("abc")}
    labels = np.stack([_y(FLAT[n], B, seed + 50 + i)
                       for i, n in enumerate("abc")])
    jl = jnp.stack([jflat.encode(FLAT[n], jnp.asarray(xs[n])) for n in "abc"])
    tl = torch.stack([tflat.encode(_tspec(FLAT[n]), xs[n]) for n in "abc"])
    reqs = {n: _x(spec, B, seed + 60 + i)
            for i, (n, spec) in enumerate(FLAT.items())}
    trains = [(n, _x(FLAT[n], B, seed + 70 + k), _y(FLAT[n], B, seed + 80 + k))
              for k, n in enumerate("abc" * 3 + "a")]
    creqs = {n: _x(CONV, B, seed + 90 + i) for i, n in enumerate("pq")}
    return ((js, jcs, jbank, reqs, trains, creqs, jl, labels),
            (ts, tcs, tbank, reqs, trains, creqs, tl, labels))


def test_served_sequence_matches_jax_and_its_cache_report():
    """Phase 17's sequence through both packages: every ``predict``,
    cold-path and flush answer, every ``TMServer.train`` step (lfsr,
    counter and threefry tenants), the restack at an unchanged K, three
    ``ProgramBank.train`` steps and their flushes, the conv predict and
    flush; then every tenant's program, PRNG and steps and the bank's
    programs and PRNGs.  JAX's ``cache_report`` after the sequence is
    ``SERVED_CACHE``, which phase 17 holds the card's graphs to (0 for
    every other stage); the port's CPU route captures nothing.  Fresh
    JAX engines: their caches count this sequence alone."""
    jengs = _jax_engines()
    jargs, targs = _roster(jengs)
    want = chip_smoke.served_sequence(*jargs)
    got = chip_smoke.served_sequence(*targs)
    assert len(got) == len(want) == 3 + 1 + 10 + 2 + 6 + 2
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal(_np(g), _np(w), f"call {i}")
    js, jcs, jbank = jargs[:3]
    ts, tcs, tbank = targs[:3]
    for jsrv, tsrv in ((js, ts), (jcs, tcs)):
        for n, jt in jsrv.tenants.items():
            tt = tsrv.tenants[n]
            assert tt.steps == jt.steps
            _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)
        assert tsrv.cold_requests == jsrv.cold_requests
    assert ts.skip_frac("a") == js.skip_frac("a")
    assert ts.tenants["a"].steps == 4 and ts.cold_requests == 6
    for k in range(3):
        _assert_same(tbank.swap_out(k), tbank.prngs[k],
                     jax.tree.map(lambda t: t[k], jbank.progs),
                     jax.tree.map(lambda t: t[k], jbank.prngs), f"slot {k}")
    jrep = {s: jengs[0].cache_report()[s] + jengs[1].cache_report()[s]
            for s in GRAPH_STAGES}
    assert jrep == {s: chip_smoke.SERVED_CACHE.get(s, 0)
                    for s in GRAPH_STAGES}
    for eng in (ts.engine, tcs.engine):
        assert all(v == 0 for k, v in eng.cache_report().items()
                   if k != "path_per_stage")


def test_cache_sizes_exists_and_is_zero_on_the_cpu(jengs):
    teng = _port(jengs[0])
    spec = _tspec(FLAT["a"])
    tm = tapi.TM(spec, engine=teng, seed=1)
    tm.predict(_x(spec, 3, 1))
    tm.partial_fit(_x(spec, 3, 2), _y(spec, 3, 3))
    assert teng.cache_sizes() == (0, 0)
    assert len(jengs[0].cache_sizes()) == 2


def test_bank_train_writes_the_bank_in_place(jengs):
    """``ProgramBank.train`` leaves ``progs``/``prngs`` the same objects
    over the same storage (the graph's state is the bank's own tensors),
    equals the eager ``train_bank`` chain for three steps, keeps one
    train and one flush graph entry, and changes nothing read out
    before (``swap_out``, ``unstack``, a held flush answer)."""
    teng = _port(jengs[0])
    _, targs = _roster(jengs)
    bank, lits, labels = targs[2], targs[6], targs[7]
    progs, prngs = bank.progs, bank.prngs
    ptrs = [t.data_ptr() for t in progs.leaves() + prngs.leaves()]
    p, r = (progs.map(torch.clone), prngs.map(torch.clone))
    held = bank.unstack() + [bank.swap_out(1)]
    copies = [[t.clone() for t in h.leaves()] for h in held]
    answer = bank.predict(lits)
    answer_copy = tuple(t.clone() for t in answer)
    for _ in range(3):
        stats = bank.train(lits, labels)
        p, r, want = teng.train_bank(p, r, lits, torch.as_tensor(labels))
        assert all(torch.equal(stats[k], want[k]) for k in want)
        assert all(v.shape == (3,) and v.dtype == torch.int32
                   for v in stats.values())
        got = bank.predict(lits)
        for a, b in zip(got, teng.predict_bank(p, lits)):
            assert torch.equal(a, b)
    assert bank.progs is progs and bank.prngs is prngs
    assert [t.data_ptr() for t in progs.leaves() + prngs.leaves()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(progs.leaves(), p.leaves()))
    assert all(torch.equal(a, b) for a, b in zip(prngs.leaves(), r.leaves()))
    assert not all(torch.equal(bank.swap_out(k).weights, held[k].weights)
                   for k in range(3))
    for h, c in zip(held, copies):
        assert all(torch.equal(a, b) for a, b in zip(h.leaves(), c))
    assert all(torch.equal(a, b) for a, b in zip(answer, answer_copy))
    assert list(bank._flush_graphs) == [("predict_bank_list",
                                         tuple(lits.shape))]
    assert len(bank._train_graphs) == 1


def test_a_rebound_bank_gets_new_graphs(jengs):
    """A caller who rebinds ``bank.progs`` trains and serves the new
    tensors: the bank's graphs are made anew for them."""
    _, targs = _roster(jengs)
    bank, lits, labels = targs[2], targs[6], targs[7]
    bank.train(lits, labels)
    bank.predict(lits)
    graphs = (dict(bank._flush_graphs), dict(bank._train_graphs))
    fresh = bank.progs.map(torch.clone)
    bank.progs = fresh
    bank.train(lits, labels)
    bank.predict(lits)
    assert bank._flush_graphs.keys() == graphs[0].keys()
    assert all(bank._flush_graphs[k] is not g for k, g in graphs[0].items())
    assert all(bank._train_graphs[k] is not g for k, g in graphs[1].items())
    assert bank._train_graphs[next(iter(graphs[1]))].state["ta"] is fresh.ta


def test_restack_at_unchanged_k_keeps_the_bank_and_its_graphs(jengs):
    """A roster change at the same K (``set_resident``, a new tenant
    registered outside it, a re-registered member) keeps the family's
    bank object and its flush graph; the new members are written into
    their slots, and the answers equal a freshly stacked server's.  A
    new K (``add_resident``) stacks a new bank."""
    _, targs = _roster(jengs)
    srv, reqs = targs[0], targs[3]
    names = list(reqs)

    def flush(s):
        for n in names:
            s.enqueue(n, reqs[n])
        return s.flush()

    def fresh():
        s = TMServer(srv.engine, batch_slot=B)
        for n, t in srv.tenants.items():
            s.register(n, t.spec, program=t.program, prng=t.prng)
        s.set_resident(srv.resident_names(False))
        return s

    srv.set_resident(names[:2])
    flush(srv)
    _, bank = srv._bank_for(False)
    graphs = dict(bank._flush_graphs)
    for roster in (names[2:], names[1:3], names[:2]):
        srv.set_resident(roster)
        got = flush(srv)
        _assert_equal(got, flush(fresh()), str(roster))
        assert srv._bank_for(False)[1] is bank
        assert bank._flush_graphs == graphs
    srv.register("e", srv.tenants["d"].spec, program=srv.tenants["d"].program)
    flush(srv)
    assert srv._bank_for(False)[1] is bank
    other = _bridge(_jprog(jengs[0], FLAT["a"], 77),
                    JPRNG.create(FLAT["a"].tm_config(), 1))[0]
    srv.register("a", srv.tenants["a"].spec, program=other)
    _assert_equal(flush(srv), flush(fresh()), "re-registered a")
    assert srv._bank_for(False)[1] is bank
    srv.add_resident("c")
    _assert_equal(flush(srv), flush(fresh()), "K=3")
    names3, bank3 = srv._bank_for(False)
    assert bank3 is not bank and bank3.k == 3 and names3 == ["a", "b", "c"]
    assert srv._spare == {}


def test_list_fed_flushes_carry_jax_keys(jengs):
    """A flush fed a list of per-tenant literals is JAX's
    ``infer_bank_list`` / ``infer_conv_bank_list``; a stacked tensor
    ``infer_bank`` / ``infer_conv_bank``; a flat bank's ``predict``
    ``predict_bank_list`` either way.  After the same calls, the stages
    of the port's graph entries are the JAX stages with a cache entry."""
    for jeng, spec in ((jengs[0], FLAT["a"]), (jengs[1], CONV)):
        teng, tspec = _port(jeng), _tspec(spec)
        conv = spec.kind == "conv"
        jp = [_jprog(jeng, spec, 100 + i) for i in range(2)]
        jbank = japi.stack(jp, jeng, conv=conv)
        tbank = tapi.stack([_bridge(p, JPRNG.create(spec.tm_config(), 1))[0]
                            for p in jp], teng, conv=conv)
        xs = [_x(spec, 3, 110 + i) for i in range(2)]
        jl = [jeng.encode(spec, jnp.asarray(x)) for x in xs]
        tl = [teng.encode(tspec, x) for x in xs]
        before = {s: v for s, v in jeng.cache_report().items()
                  if s != "path_per_stage"}
        for j, t in ((jl, tl), (jnp.stack(jl), torch.stack(tl))):
            _assert_equal(_np(tbank.infer(t)), _np(jbank.infer(j)), "infer")
            if not conv:
                _assert_equal(_np(tbank.predict(t)), _np(jbank.predict(j)),
                              "predict")
        grew = {s for s, v in jeng.cache_report().items()
                if s != "path_per_stage" and v > before[s]}
        stages = {k[0] for k in tbank._flush_graphs}
        want = ({"infer_conv_bank", "infer_conv_bank_list"} if conv else
                {"infer_bank", "infer_bank_list", "predict_bank_list"})
        assert stages == want and grew == want


def test_server_train_replays_the_session_step_graph(jengs):
    """``TMServer.train`` and ``TM.partial_fit`` at the same batch shape
    share one step graph of the engine (one buffer set, copied in when
    another tenant's state arrives); the stale slot and the skip
    accounting are kept; a program or PRNG read before a step (a
    ``snapshot``, the tenant's old program) never changes."""
    _, targs = _roster(jengs)
    srv = targs[0]
    eng = srv.engine
    spec = srv.tenants["a"].spec
    tm = tapi.TM(spec, engine=eng, seed=3)
    x, y = _x(FLAT["a"], B, 1), _y(FLAT["a"], B, 2)
    tm.partial_fit(x, y)
    step, snap = srv.snapshot("a")
    old = srv.tenants["a"].program
    old_copy = [t.clone() for t in old.leaves()]
    host = srv.train("a", x, y)
    assert "a" in srv._dirty and srv.skip_frac("a") is not None
    assert sorted(host) == sorted(("selected", "active_groups",
                                   "total_groups", "correct", "abs_err"))
    tm.partial_fit(x, y)
    srv.train("a", x, y)
    keys = [k for k in eng._graphs if k[0] == "train"]
    assert len(keys) == 1
    assert all(torch.equal(a, b) for a, b in zip(old.leaves(), old_copy))
    now = srv.tenants["a"].program
    assert step == 0 and not (torch.equal(snap["ta"], now.ta)
                              and torch.equal(snap["weights"], now.weights))


def test_score_gets_a_graph_per_batch_shape(jengs):
    """``TM.score`` predicts in batches of 256 and pads the tail batch to
    256 rows, as JAX's ``batched_predict`` does (one executable), so the
    300 rows take one inference graph; ``predict`` at another batch size
    is another graph entry; ``predict`` / ``class_sums`` equal JAX's."""
    jeng = jengs[0]
    teng = _port(jeng)
    spec = FLAT["d"]
    jtm = japi.TM(spec, engine=jeng, seed=4)
    ttm = tapi.TM(_tspec(spec), engine=teng, seed=4)
    x, y = _x(spec, 300, 5), _y(spec, 300, 6)
    assert ttm.score(x, y) == jtm.score(x, y)
    def shapes():
        return sorted(k[2][0][0][0] for k in teng._graphs if k[0] == "infer")
    assert shapes() == [256]
    np.testing.assert_array_equal(ttm.predict(x[:5]).numpy(),
                                  np.asarray(jtm.predict(x[:5])))
    np.testing.assert_array_equal(ttm.class_sums(x[:5]).numpy(),
                                  np.asarray(jtm.class_sums(x[:5])))
    assert shapes() == [5, 256]


def test_served_inference_from_threads(jengs):
    """Eight threads serve four tenants through one inference graph (one
    buffer set) at once, with a short switch interval: every answer is
    its tenant's eager ``infer``."""
    import sys
    _, targs = _roster(jengs)
    srv, reqs = targs[0], targs[3]
    eng = srv.engine
    want = {}
    for n, x in reqs.items():
        t = srv.tenants[n]
        sums, _ = eng.infer(t.program, eng.encode(t.spec, x))
        want[n] = torch.argmax(sums, dim=-1).numpy()
    errors = []

    def work(i):
        try:
            for k in range(6):
                n = "abcd"[(i + k) % 4]
                got = srv.predict(n, reqs[n])
                np.testing.assert_array_equal(got, want[n])
        except Exception as e:            # reported by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)


def test_a_pending_flush_keeps_its_cold_answers(jengs):
    """At ``pipeline_depth`` 2 a launched flush waits while the next one
    runs: the cold answers it holds are copies the next flush's
    inference does not overwrite."""
    _, targs = _roster(jengs)
    srv, reqs = targs[0], targs[3]
    srv.set_resident(["a", "b"])
    srv.enqueue("c", reqs["c"])
    srv.enqueue("d", reqs["d"])
    first = srv.flush_async()
    held = [(n, s.clone(), c.clone()) for n, s, c in first.cold]
    srv.enqueue("c", _x(FLAT["c"], B, 120))
    srv.enqueue("d", _x(FLAT["d"], B, 121))
    second = srv.flush_async()
    for (n, s, c), (_, s0, c0) in zip(first.cold, held):
        assert torch.equal(s, s0) and torch.equal(c, c0), n
    assert srv.collect(second) and srv.collect(first)


def test_prng_stack_copies_its_members():
    """``api.stack`` copies the PRNGs (and programs) it stacks, so a
    bank's in-place train step leaves the callers' PRNGs as they were."""
    cfg = FLAT["a"].tm_config()
    r = [PRNG.create(cfg, s, device="cpu") for s in (1, 2)]
    stacked = PRNG.stack(r)
    assert all(a.data_ptr() != b.data_ptr() for m in r
               for a in m.leaves() for b in stacked.leaves())
