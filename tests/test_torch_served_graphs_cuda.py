"""CUDA-graph replay of the served stages, on the card: single-program
inference, ``TMServer.train``, ``ProgramBank.train`` in place, the
restack at an unchanged K, and ``chip_smoke.py``'s served sequence.

Every test needs an NVIDIA card and nvcc; without a card each one skips
(decided inside the fixture, never at import).  Run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_served_graphs_cuda.py

Replay must equal the eager building blocks (``engine.infer``,
``infer_conv``, ``train_step``, ``train_bank``) or an eager twin of the
engine (its graphs off) bit for bit; ``cache_report`` stays at one graph
a stage and shape across programs and equals the JAX engine's after the
served sequence; no bank leaf is rebound by ``train``; launch counts
grow by each replay's captured counts.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.core.prng import PRNG
from repro_torch.kernels import ops
from repro_torch.launch.serve_tm import TMServer

pytestmark = pytest.mark.cuda

_ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _flat(backend, features=40, classes=4, clauses=60):
    return api.TMSpec.coalesced(features=features, classes=classes,
                                clauses=clauses, T=10, prng_backend=backend,
                                lfsr_bits=12)


CONV = api.TMSpec.conv(8, 8, 3, classes=3, clauses=40, T=8,
                       prng_backend="lfsr", lfsr_bits=12)


def _x(spec, n, seed):
    rng = np.random.default_rng(seed)
    shape = ((n, spec.img_h, spec.img_w) if spec.kind == "conv"
             else (n, spec.features))
    return (rng.random(shape) < 0.4).astype(np.int8)


def _y(spec, n, seed):
    return np.random.default_rng(seed).integers(
        0, spec.classes, n).astype(np.int32)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


@pytest.mark.parametrize("kind", ["flat", "conv"])
def test_served_infer_replays_equal_eager(dev, kind):
    """Answers at B = 1, 3, 4 (edge) and 32 (slot) for three programs
    equal the eager ``infer`` / ``infer_conv``; one graph a shape."""
    spec = CONV if kind == "conv" else _flat("lfsr")
    engine = api.compile(api.tile_for(spec))
    progs = [api.TM(spec, engine=engine, seed=s).program for s in (1, 2, 3)]
    eager = engine.infer_conv if kind == "conv" else engine.infer
    batches = (1, 3, 4, 32)
    for b in batches:
        lits = engine.encode(spec, _x(spec, b, b))
        for p in progs:
            sums, cl = engine.served_infer(spec, p, lits)
            want = eager(p, lits)
            assert torch.equal(sums, want[0]) and torch.equal(cl, want[1])
    stage = "infer_conv" if kind == "conv" else "infer"
    assert engine.cache_report()[stage] == len(batches)
    assert engine.cache_sizes()[0] == (0 if kind == "conv" else 4)


@pytest.mark.parametrize("backend", ["lfsr", "counter", "threefry"])
def test_server_train_replays_equal_the_eager_steps(dev, backend):
    """Ten ``TMServer.train`` steps over two tenants of one PRNG backend
    equal the eager ``train_step`` chain (program, PRNG, stats); one
    train graph serves both; the program a tenant held before a step
    never changes."""
    spec = _flat(backend)
    engine = api.compile(api.tile_for(spec))
    srv = TMServer(engine, batch_slot=B)
    for i, n in enumerate("ab"):
        srv.register(n, spec, seed=10 + i)
    state = {n: (srv.tenants[n].program, srv.tenants[n].prng) for n in "ab"}
    for k in range(10):
        n = "ab"[k % 2]
        x, y = _x(spec, B, 20 + k), _y(spec, B, 30 + k)
        before = srv.tenants[n].program
        copy = [t.clone() for t in before.leaves()]
        host = srv.train(n, x, y)
        p, r, st = engine.train_step(*state[n], engine.encode(spec, x),
                                     spec.encode_labels(y).to(dev))
        state[n] = (p, r)
        assert _same(srv.tenants[n].program, p)
        assert _same(srv.tenants[n].prng, r)
        assert host == {k_: int(st[k_]) for k_ in STAT_KEYS}
        assert all(torch.equal(a, b) for a, b in zip(before.leaves(), copy))
    assert engine.cache_report()["train"] == 1 == engine.cache_sizes()[1]


def test_bank_train_in_place_equals_eager_and_keeps_its_flush_graph(dev):
    spec = _flat("counter")
    engine = api.compile(api.tile_for(spec))
    progs = [api.TM(spec, engine=engine, seed=s).program for s in (4, 5)]
    prngs = [PRNG.create(spec.tm_config(), s, device=dev) for s in (6, 7)]
    bank = api.stack(progs, engine, prngs=prngs)
    p, r = bank.progs.map(torch.clone), bank.prngs.map(torch.clone)
    ptrs = [t.data_ptr() for t in bank.progs.leaves() + bank.prngs.leaves()]
    lits = torch.stack([engine.encode(spec, _x(spec, B, s)) for s in (8, 9)])
    labels = np.stack([_y(spec, B, s) for s in (10, 11)])
    lab = torch.as_tensor(labels, device=dev)
    bank.predict(lits)
    flush = next(iter(bank._flush_graphs.values()))
    out = None
    for step in range(3):
        stats = bank.train(lits, labels)
        p, r, want = engine.train_bank(p, r, lits, lab)
        assert all(torch.equal(stats[k], want[k]) for k in STAT_KEYS)
        assert _same(bank.progs, p) and _same(bank.prngs, r)
        held = out
        out = bank.predict(lits)
        for a, b in zip(out, engine.predict_bank(p, lits)):
            assert torch.equal(a, b)
        if held is not None:         # an earlier answer is a copy
            assert held[0].data_ptr() != out[0].data_ptr()
    assert [t.data_ptr() for t in bank.progs.leaves()
            + bank.prngs.leaves()] == ptrs
    assert next(iter(bank._flush_graphs.values())) is flush
    assert flush.replays == 4
    rep = engine.cache_report()
    assert rep["train_bank"] == 1 and rep["predict_bank_list"] == 1


def test_restack_at_unchanged_k_replays_without_capture(dev):
    spec = _flat("lfsr")
    engine = api.compile(api.tile_for(spec))
    srv = TMServer(engine, batch_slot=B)
    names = [f"t{i}" for i in range(4)]
    for i, n in enumerate(names):
        srv.register(n, spec, seed=40 + i)
    reqs = {n: _x(spec, B, 50 + i) for i, n in enumerate(names)}

    def flush():
        for n in names:
            srv.enqueue(n, reqs[n])
        return srv.flush()

    srv.set_resident(names[:2])
    flush()
    _, bank = srv._bank_for(False)
    graph = next(iter(bank._flush_graphs.values()))
    for roster in (names[2:], names[1:3], names[:2]):
        srv.set_resident(roster)
        got = flush()
        for n in names:
            t = srv.tenants[n]
            sums, _ = engine.infer(t.program, engine.encode(spec, reqs[n]))
            np.testing.assert_array_equal(
                got[n], torch.argmax(sums, dim=-1).cpu().numpy())
        assert srv._bank_for(False)[1] is bank
    assert next(iter(bank._flush_graphs.values())) is graph
    assert graph.replays == 4
    assert engine.cache_report()["predict_bank_list"] == 1


def test_served_sequence_matches_the_eager_twin_and_jax_counts(dev):
    """``chip_smoke.served_sequence`` at small widths on fresh engines and
    on their eager twins: every answer and step equal; ``cache_report``
    equals the JAX engine's after the same calls (``SERVED_CACHE``), each
    graph's replays are ``SERVED_REPLAYS``, and the launch counts are the
    replays times each graph's captured counts."""
    cs = _chip_smoke()
    flat = {"a": _flat("lfsr"), "b": _flat("counter", classes=3),
            "c": _flat("threefry", features=30), "d": _flat("lfsr", 20)}
    tile, ctile = api.tile_for(*flat.values()), api.tile_for(CONV)

    def build(eng, ceng):
        srv, csrv = TMServer(eng, batch_slot=B), TMServer(ceng, batch_slot=B)
        for i, (n, s) in enumerate(flat.items()):
            srv.register(n, s, seed=60 + i)
        for i, n in enumerate("pq"):
            csrv.register(n, CONV, seed=70 + i)
        cspec = _flat("counter")
        bank = api.stack([api.TM(flat[n], engine=eng, seed=80 + i).program
                          for i, n in enumerate("abc")], eng, prngs=[
            PRNG.create(cspec.tm_config(), 90 + i, device=dev)
            for i in range(3)])
        lits = torch.stack([eng.encode(flat[n], _x(flat[n], B, 100 + i))
                            for i, n in enumerate("abc")])
        return srv, csrv, bank, lits

    eng, ceng = api.compile(tile), api.compile(ctile)
    live = build(eng, ceng)
    twin = build(cs.eager_engine(api.compile(tile)),
                 cs.eager_engine(api.compile(ctile)))
    labels = np.stack([_y(flat[n], B, 110 + i) for i, n in enumerate("abc")])
    reqs = {n: _x(s, B, 120 + i) for i, (n, s) in enumerate(flat.items())}
    trains = [(n, _x(flat[n], B, 130 + k), _y(flat[n], B, 140 + k))
              for k, n in enumerate("abc" * 3 + "a")]
    creqs = {n: _x(CONV, B, 150 + i) for i, n in enumerate("pq")}
    ops.reset_launch_counts()
    got = cs.served_sequence(*live[:3], reqs, trains, creqs, live[3], labels)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = cs.served_sequence(*twin[:3], reqs, trains, creqs, twin[3],
                              labels)
    for i, (g, w) in enumerate(zip(got, want)):
        assert cs.same_answer(torch, np, g, w), i
    for a, b in ((live[0], twin[0]), (live[1], twin[1])):
        for n, t in a.tenants.items():
            assert _same(t.program, b.tenants[n].program), n
            assert _same(t.prng, b.tenants[n].prng), n
    assert _same(live[2].progs, twin[2].progs)
    graphs = [g for e in (eng, ceng) for s in e._captured.values()
              for g in s]
    cache = {s: eng.cache_report()[s] + ceng.cache_report()[s]
             for s in cs.SERVED_CACHE}
    assert cache == cs.SERVED_CACHE
    replays = {}
    for g in graphs:
        replays.setdefault(g.stage, []).append(g.replays)
    assert {k: sorted(v) for k, v in replays.items()} == cs.SERVED_REPLAYS
    expect = {}
    for g in graphs:
        for k, v in g.launches.items():
            expect[k] = expect.get(k, 0) + v * g.replays
    assert {k: v for k, v in counts.items() if v} == expect
