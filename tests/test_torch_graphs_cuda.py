"""CUDA-graph replay of the port's sessions and banks, on the card.

Every test needs an NVIDIA card and nvcc; without a card each one skips
(decided inside the fixture, never at import).  Run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py

Replay must equal the eager chain of the engine's steps bit for bit
(program, PRNG, stats, histories, answers); a program swap reuses the
bank's graph; launch counts add a graph's captured launches per replay;
a capture that fails raises.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import threefry
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.core.graph import StepGraph
from repro_torch.kernels import ops
from repro_torch.launch.serve_tm import TMServer

pytestmark = pytest.mark.cuda

FLAT = dict(features=40, classes=4, clauses=60, T=10, prng_backend="lfsr",
            lfsr_bits=12)
FITS = {"compact": ({}, "lfsr"), "dense": ({"skip": False}, "lfsr"),
        "mxu": ({"kernel_path": "mxu"}, "lfsr"),
        "stream": ({"ta_prng": "stream"}, "lfsr"),
        "conv": ({}, "conv"), "threefry": ({}, "threefry")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _spec(kind):
    if kind == "conv":
        return api.TMSpec.conv(8, 8, 3, classes=3, clauses=40, T=8,
                               prng_backend="lfsr", lfsr_bits=12)
    if kind == "threefry":
        return api.TMSpec.coalesced(**{**FLAT, "prng_backend": "threefry"})
    return api.TMSpec.coalesced(**FLAT)


def _data(spec, n, seed):
    rng = np.random.default_rng(seed)
    shape = ((n, spec.img_h, spec.img_w) if spec.kind == "conv"
             else (n, spec.features))
    return ((rng.random(shape) < 0.4).astype(np.int8),
            rng.integers(0, spec.classes, n).astype(np.int32))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def _eager_fit(engine, spec, p, r, x, y, epochs, batch, seed):
    """The eager chain: the engine's step in a loop, the session's
    shuffle; returns (program, PRNG, per-step stats of every epoch)."""
    step = engine.train_conv if spec.kind == "conv" else engine.train_step
    lits = engine.encode(spec, x)
    lab = spec.encode_labels(y).to(engine.device)
    n = len(x) - len(x) % batch
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(epochs):
        idx = torch.from_numpy(rng.permutation(len(x))[:n].reshape(
            -1, batch)).to(engine.device)
        for ib in idx:
            p, r, st = step(p, r, lits.index_select(0, ib),
                            lab.index_select(0, ib))
            rows.append(torch.stack([st[k] for k in STAT_KEYS]))
    return p, r, torch.stack(rows)


@pytest.mark.parametrize("name", list(FITS))
def test_replayed_fit_equals_the_eager_chain(dev, name):
    kw, kind = FITS[name]
    spec = _spec(kind)
    engine = api.compile(api.tile_for(spec), **kw)
    x, y = _data(spec, 80, 1)
    tm = api.TM(spec, engine=engine, seed=3)
    p0, r0 = tm.program, tm.prng
    held = [t.clone() for t in p0.leaves() + r0.leaves()]
    session = engine.bind(p0, x, y, spec=spec, prng=r0)
    session.fit_epochs(2, batch=16, rng=np.random.default_rng(4),
                       sync_guard=True)
    p, r, _ = _eager_fit(engine, spec, p0, r0, x, y, 2, 16, 4)
    assert _same(session.program, p) and _same(session.prng, r)
    assert all(torch.equal(a, b)
               for a, b in zip(held, p0.leaves() + r0.leaves()))
    assert session.replays == 10 and session.dispatches == 2
    stage = "fit_epoch_conv" if kind == "conv" else "fit_epoch"
    assert engine.cache_report()[stage] == 1
    # the per-step stats of one epoch through _fit_epoch_impl
    impl = (engine._fit_epoch_conv_impl if kind == "conv"
            else engine._fit_epoch_impl)
    idx = np.random.default_rng(4).permutation(80).reshape(5, 16)
    _, _, st = impl(p0, r0, engine.encode(spec, x),
                    spec.encode_labels(y).cuda(), idx)
    _, _, want = _eager_fit(engine, spec, p0, r0, x, y, 1, 16, 4)
    assert torch.equal(st, want)
    assert engine.cache_report()[stage] == 1


@pytest.mark.parametrize("kind", ["lfsr", "conv"])
def test_partial_fit_replays_equal_eager_steps(dev, kind):
    spec = _spec(kind)
    engine = api.compile(api.tile_for(spec))
    x, y = _data(spec, 6, 2)
    tm = api.TM(spec, engine=engine, seed=5)
    p, r = tm.program, tm.prng
    step = engine.train_conv if kind == "conv" else engine.train_step
    for i in range(len(x)):
        got = tm.partial_fit(x[i:i + 1], y[i:i + 1])
        p, r, want = step(p, r, engine.encode(spec, x[i:i + 1]),
                          spec.encode_labels(y[i:i + 1]).cuda())
        assert _same(tm.program, p) and _same(tm.prng, r)
        assert all(int(got[k]) == int(want[k]) for k in STAT_KEYS)
    stage = "train_conv" if kind == "conv" else "train"
    assert engine.cache_report()[stage] == 1


def test_flush_replays_equal_eager_and_one_graph_across_swaps(dev):
    spec = _spec("lfsr")
    engine = api.compile(api.tile_for(spec))
    srv = TMServer(engine, batch_slot=8)
    names = [f"t{i}" for i in range(4)]
    progs = {}
    for i, n in enumerate(names):
        srv.register(n, spec, seed=10 + i)
        progs[n] = srv.tenants[n].program
    x, _ = _data(spec, 8, 3)
    lits = engine.encode(spec, x)

    def flush_and_check():
        for n in srv.resident_names(False):
            srv.enqueue(n, lits, encoded=True)
        got = srv.flush()
        bn, bank = srv._bank_for(False)
        preds, votes = engine.predict_bank(bank.progs, [lits] * len(bn))
        for k, n in enumerate(bn):
            np.testing.assert_array_equal(got[n], preds[k].cpu().numpy())
        assert engine.cache_report()["predict_bank_list"] == 1

    flush_and_check()
    for n, src in ((names[0], names[1]), (names[1], names[2]),
                   (names[0], names[0])):
        srv.swap_in(n, progs[src])
        flush_and_check()
    srv.set_resident(names[:2])
    flush_and_check()
    srv.swap_resident(names[1], names[3])
    flush_and_check()


def test_conv_flush_replays_equal_eager(dev):
    spec = _spec("conv")
    engine = api.compile(api.tile_for(spec))
    progs = [engine.lower(spec, threefry.key(seed, "cuda"))
             for seed in (1, 2)]
    bank = api.stack(progs, engine, conv=True)
    x, _ = _data(spec, 6, 4)
    lits = [engine.encode(spec, x[:3]), engine.encode(spec, x[3:])]
    for k, prog in ((None, None), (0, progs[1]), (1, progs[0])):
        if k is not None:
            bank.swap_in(k, prog)
        got = bank.infer(lits)
        want = engine.infer_conv_bank(bank.progs, lits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a flush fed a list of literals is JAX's infer_conv_bank_list
    assert engine.cache_report()["infer_conv_bank_list"] == 1


def test_replayed_epoch_adds_its_captured_launches(dev):
    spec = _spec("lfsr")
    engine = api.compile(api.tile_for(spec))
    x, y = _data(spec, 64, 6)
    tm = api.TM(spec, engine=engine, seed=7)
    tm.fit(x, y, epochs=1, batch=16)       # captures
    graph = next(iter(engine._captured["fit_epoch"]))
    assert graph.launches == {"fused_step": 1, "ta_update_sparse": 1,
                              "lfsr_bits": 3, "step_prologue": 1,
                              "step_epilogue": 1}
    ops.reset_launch_counts()
    tm.fit(x, y, epochs=2, batch=16)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        k: 8 * v for k, v in graph.launches.items()}


def test_a_failed_capture_raises(dev):
    """A body that reads the device from the host cannot be captured:
    the capture raises (nothing runs it eagerly instead), and the card
    works afterwards."""
    buf = {"x": torch.ones(4, device=dev)}

    def body(b):
        b["x"].mul_(float(b["x"].sum().item()))

    g = StepGraph("train", body, buf, capture=True, registry={})
    with pytest.raises(RuntimeError):
        g.run()
    assert g.graph is None
    torch.cuda.synchronize()
    assert float((torch.arange(4, device=dev) + 1).sum()) == 10.0


def test_no_collection_runs_during_a_capture(dev):
    """A captured graph left in a reference cycle (a dead engine's) is
    freed by the cyclic collector, and a collection during another
    capture would free it there and invalidate that capture.  With the
    collector set to run at nearly every allocation, none runs while a
    capture is underway; the garbage graph goes afterwards."""
    import gc
    import weakref

    during = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    def garbage():
        g = StepGraph("train", lambda b: b["x"].mul_(2),
                      {"x": torch.ones(4, device=dev)}, capture=True,
                      registry={})
        g.run()
        g.cycle = g                  # only the cyclic collector frees it
        return weakref.ref(g)

    buf = {"y": torch.zeros(4, device=dev)}
    threshold = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1)
    try:
        dead = garbage()
        graph = StepGraph("train", lambda b: [b["y"].add_(1)
                                               for _ in range(3)],
                          buf, capture=True, registry={})
        graph.run(2)
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(watch)
    assert during == [] and gc.isenabled()
    gc.collect()
    assert dead() is None
    graph.run()
    assert torch.equal(buf["y"], torch.full((4,), 9.0, device=dev))


def test_the_ref_path_runs_its_bodies_eagerly(dev):
    spec = _spec("lfsr")
    engine = api.compile(api.tile_for(spec), kernel_path="ref")
    assert not engine.graphed
    x, y = _data(spec, 32, 8)
    tm = api.TM(spec, engine=engine, seed=9)
    session = engine.bind(tm.program, x, y, spec=spec, prng=tm.prng)
    session.fit_epochs(1, batch=16)
    assert session.replays == 0 and session.dispatches == 1
    assert all(v == 0 for k, v in engine.cache_report().items()
               if k != "path_per_stage")
