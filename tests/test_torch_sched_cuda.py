"""The scheduler and the durable writer on the card (one stream).

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (decided inside the fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sched_cuda.py

Pipelined flushes, slot rewrites, membership swaps and the writer's
copies are ordered only by the device's one stream; these tests hold
their results exactly against synchronous twins on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import tm_paper
from repro_torch.data import datasets
from repro_torch.kernels import ops
from repro_torch.launch.scheduler import GOLD, SchedulerConfig, TMScheduler
from repro_torch.launch.serve_tm import TMServer, demo_batch, demo_specs
from repro_torch.runtime.durable import DurableStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _program(engine, spec, seed):
    """A program whose clause rows include a few literals (TA states on
    both sides of J) and whose CoTM weights vary, so answers differ."""
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    j = cfg.include_threshold
    ta = rng.integers(0, j, (cfg.total_clauses, cfg.literals))
    for r in range(cfg.total_clauses):
        k = rng.integers(1, 4)
        ta[r, rng.choice(cfg.literals // 2, k, replace=False)] = \
            rng.integers(j, 2 * j, k)
    w = None
    if spec.kind in ("coalesced", "head", "conv"):
        w = rng.integers(-4, 5, (cfg.classes, cfg.clauses))
    return engine.lower(spec, ta=ta, weights=w)


def _labels(spec, n, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "regression":
        return rng.random(n).astype(np.float32)
    return rng.integers(0, spec.classes, n).astype(np.int32)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def _servers(engine, specs, slot, n=2):
    progs = {name: _program(engine, s, 10 + i)
             for i, (name, s) in enumerate(specs.items())}
    out = []
    for _ in range(n):
        srv = TMServer(engine, batch_slot=slot)
        for name, s in specs.items():
            srv.register(name, s, program=progs[name], seed=3)
        out.append(srv)
    return out


def test_pipelined_flushes_with_swaps_and_training_equal_sync(dev):
    """pipeline_depth=4 with ``swap_resident`` and training steps between
    the launches: every answer equals a synchronous flush per request."""
    specs = demo_specs(small=False)
    engine = api.compile(api.tile_for(*specs.values()))
    srv, ref = _servers(engine, specs, 32)
    sched = TMScheduler(srv, SchedulerConfig(
        pipeline_depth=4, resident_slots=2, membership_every=10 ** 6))
    flat = [n for n in specs if specs[n].kind != "conv"]
    assert srv.resident_names(False) == flat[:2]
    futs, want, fired = [], [], 0
    for r in range(8):
        for i, name in enumerate(specs):
            x = demo_batch(specs[name], 32 - 8 * ((r + i) % 3),
                           seed=100 * r + i)
            futs.append((name, sched.submit(name, x)))
            ref.enqueue(name, x)
            want.append(ref.flush()[name])
        sched.step(force=True)             # launched, not collected
        resident = srv.resident_names(False)
        cold = [n for n in flat if n not in resident]
        srv.swap_resident(resident[r % 2], cold[0])
        if r % 3 == 1:                     # a stale slot between launches
            name = srv.resident_names(False)[0]
            x = demo_batch(specs[name], 32, seed=900 + r)
            y = _labels(specs[name], 32, 900 + r)
            assert srv.train(name, x, y) == ref.train(name, x, y)
        assert len(sched._in_flight) <= 4
    sched.drain()
    assert srv.membership_swaps == 8 and srv.cold_requests > 0
    for (name, fut), w in zip(futs, want):
        got = fut.result(timeout=60)
        np.testing.assert_array_equal(got, w, err_msg=name)
        fired += int((np.asarray(w) != 0).sum())
    assert fired > 0
    for name in specs:
        assert _same(srv.tenants[name].program, ref.tenants[name].program)


def test_thread_mode_with_the_writer_running(dev, tmp_path):
    """Open-loop submits from the caller's thread, the driver and the
    checkpoint writer each on their own thread: answers and training
    stats equal the synchronous twin's, and the files written while the
    driver ran cold-start to the live state."""
    specs = demo_specs(small=False)
    d = str(tmp_path / "durable")
    sched = api.serve(dict(specs), batch_slot=32, durable_dir=d,
                      slas={"cotm": GOLD},
                      config=SchedulerConfig(ckpt_interval_s=0.005,
                                             max_wait_s=0.0005,
                                             pipeline_depth=2))
    ref = TMServer(sched.server.engine, batch_slot=32)
    for name, s in specs.items():
        prog = _program(sched.server.engine, s, 20)
        sched.register(name, s, program=prog, seed=1,
                       sla=sched.sla_of(name))
        ref.register(name, s, program=prog, seed=1)
    trace = []
    for r in range(6):
        for i, name in enumerate(specs):
            trace.append(("train", name,
                          demo_batch(specs[name], 32, seed=7 * r + i),
                          _labels(specs[name], 32, 7 * r + i)))
            for j in range(3):
                trace.append(("infer", name,
                              demo_batch(specs[name], 16 + 8 * j,
                                         seed=1000 + 31 * r + 7 * j + i),
                              None))
    want = []
    for kind, name, x, y in trace:
        if kind == "train":
            want.append(ref.train(name, x, y))
        else:
            ref.enqueue(name, x)
            want.append(ref.flush()[name])
    sched.start()
    try:
        assert sched.stats()["checkpoint"]["running"]
        futs = [sched.submit_train(n, x, y) if kind == "train"
                else sched.submit(n, x) for kind, n, x, y in trace]
        got = [f.result(timeout=120) for f in futs]
    finally:
        sched.stop()
    for (kind, name, _, _), g, w in zip(trace, got, want):
        if kind == "train":
            assert {k: g[k] for k in w} == w, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    ck = sched.stats()["checkpoint"]
    assert ck["failures"] == 0 and ck["dirty"] == 0 and ck["saves"] >= 5
    store = DurableStore(d)
    cold = api.serve(None, durable_dir=d)
    for name in specs:
        live = sched.server.tenants[name]
        assert store.latest_tenant_step(name) == live.steps == 6
        back = cold.server.tenants[name]
        assert back.steps == 6
        assert _same(back.program, live.program), name
        assert _same(back.prng, live.prng), name
        assert _same(live.program, ref.tenants[name].program), name


def test_train_while_serve_at_the_roster_tile(dev):
    """The four paper models as one roster (L=3200, R=4224, W=100):
    training MNIST CoTM on the serving engine's tile runs fused_step
    and the compacted TA update at that width, and the scheduled stream
    equals sequential ``train`` + ``flush`` on a twin."""
    cfgs = {"mnist_cotm": tm_paper.TM_MNIST_COTM,
            "mnist_vanilla": tm_paper.TM_MNIST_VANILLA,
            "kws6_cotm": tm_paper.TM_KWS6_COTM,
            "kws6_vanilla": tm_paper.TM_KWS6_VANILLA}
    specs = {n: api.TMSpec(kind=c.tm_type, features=c.features,
                           clauses=c.clauses, classes=c.classes, T=c.T,
                           s=c.s, ta_bits=c.ta_bits,
                           weight_bits=c.weight_bits, prng_backend="lfsr",
                           lfsr_bits=c.lfsr_bits)
             for n, c in cfgs.items()}
    engine = api.compile(api.tile_for(*specs.values()))
    assert (engine.L, engine.R, engine.W) == (3200, 4224, 100)
    srv, ref = _servers(engine, specs, 32)
    sched = TMScheduler(srv, SchedulerConfig(pipeline_depth=2))
    x, y = datasets.make_bool_dataset(datasets.MNIST_LIKE, 32 * 6, seed=5)
    xk, _ = datasets.make_bool_dataset(datasets.KWS6_LIKE, 32, seed=6)
    reqs = {n: (xk if n.startswith("kws6") else x)[:32] for n in specs}
    trace = []
    for s in range(4):
        trace.append(("train", "mnist_cotm", x[32 * s:32 * (s + 1)],
                      y[32 * s:32 * (s + 1)]))
        trace += [("infer", n, reqs[n][8 * s:8 * s + 24], None)
                  for n in specs]
    want = []
    for kind, n, xs, ys in trace:
        if kind == "train":
            want.append(ref.train(n, xs, ys))
        else:
            ref.enqueue(n, xs)
            want.append(ref.flush()[n])
    ops.reset_launch_counts()
    futs = [sched.submit_train(n, xs, ys) if kind == "train"
            else sched.submit(n, xs) for kind, n, xs, ys in trace]
    sched.drain()
    counts = ops.launch_counts()
    for k in ("fused_step", "ta_update_sparse", "lfsr_bits",
              "packed_clause_tile", "class_sum"):
        assert counts[k] > 0, (k, counts)
    assert counts["fused_step"] == counts["ta_update_sparse"] == 4
    for (kind, n, _, _), f, w in zip(trace, futs, want):
        g = f.result(timeout=60)
        if kind == "train":
            assert {k: g[k] for k in w} == w
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)
    a, b = srv.tenants["mnist_cotm"], ref.tenants["mnist_cotm"]
    assert a.steps == b.steps == 4
    assert _same(a.program, b.program) and _same(a.prng, b.prng)
    assert srv.engine.cache_report()["path_per_stage"]["train_ta"] \
        == "compact"
