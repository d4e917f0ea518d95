"""The port's continuous-batching scheduler (launch/scheduler.py), CPU.

Whatever the batching, pipelining or bank membership, scheduled answers
equal the synchronous per-tenant ``enqueue`` + ``flush`` path exactly:
the single-device tests of the JAX package's ``tests/test_scheduler.py``
on the port, and the port's scheduler against the JAX scheduler on one
trace (programs and PRNGs carried across with ``repro_torch.convert``).
"""
import dataclasses
import time

import numpy as np
import pytest

from repro import api as japi
from repro.launch.scheduler import (SchedulerConfig as JConfig,
                                    TMScheduler as JScheduler)
from repro.launch.serve_tm import (TMServer as JServer,
                                   demo_specs as jdemo_specs)
from repro_torch import api
from repro_torch.core.types import TileConfig
from repro_torch.launch.scheduler import (BATCH, GOLD, STANDARD, Backpressure,
                                          SchedulerConfig, SLAClass,
                                          TMScheduler)
from repro_torch.launch.serve_tm import TMServer, demo_batch, demo_specs
from test_torch_train import _assert_same, _bridge

BATCH_SLOT = 16


@pytest.fixture(scope="module")
def roster():
    specs = demo_specs(small=True)
    engine = api.compile(api.tile_for(*specs.values()), device="cpu")
    return specs, engine


def _mk_server(engine, specs, names=None, seed=2):
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    for name in (names or specs):
        srv.register(name, specs[name], seed=seed)
    return srv


def _trace(specs, names, rounds=2):
    """A fixed request trace: (tenant, batch) pairs with varying content
    and ragged sizes."""
    out = []
    for r in range(rounds):
        for i, name in enumerate(names):
            n = BATCH_SLOT if (r + i) % 2 == 0 else BATCH_SLOT // 2
            out.append((name, demo_batch(specs[name], n,
                                         seed=17 + 7 * r + i)))
    return out


def _sync_results(srv, trace):
    """The synchronous baseline: one enqueue + flush per request."""
    out = []
    for name, x in trace:
        srv.enqueue(name, x)
        out.append(srv.flush()[name])
    return out


# ---------------------------------------------------------------------------
# determinism: scheduled == synchronous flush
# ---------------------------------------------------------------------------

def test_scheduled_bit_identical_to_sync_flush(roster):
    """Fixed trace, all five kinds, a training step mid-trace: the
    coalesced, pipelined answers equal the per-request flush."""
    specs, engine = roster
    names = sorted(specs)
    srv_ref = _mk_server(engine, specs)
    srv_sch = _mk_server(engine, specs)
    sched = TMScheduler(srv_sch, SchedulerConfig(pipeline_depth=2))

    trace = _trace(specs, names, rounds=2)
    ref = _sync_results(srv_ref, trace)
    futs = [sched.submit(name, x) for name, x in trace]
    sched.drain()
    for (name, _), fut, want in zip(trace, futs, ref):
        assert np.array_equal(fut.result(timeout=1), want), name

    # a training step makes a bank slot stale; the next scheduled flush
    # must rewrite it as the synchronous path does
    xt = demo_batch(specs["cotm"], BATCH_SLOT, seed=99)
    yt = np.zeros(BATCH_SLOT, np.int32)
    assert srv_ref.train("cotm", xt, yt) == srv_sch.train("cotm", xt, yt)
    trace2 = _trace(specs, names, rounds=1)
    ref2 = _sync_results(srv_ref, trace2)
    futs2 = [sched.submit(name, x) for name, x in trace2]
    sched.drain()
    for (name, _), fut, want in zip(trace2, futs2, ref2):
        assert np.array_equal(fut.result(timeout=1), want), name
    assert sched.completed == len(trace) + len(trace2)
    assert srv_sch.stacked_launches < srv_ref.stacked_launches


def test_flush_async_collect_equals_flush(roster):
    specs, engine = roster
    srv_a = _mk_server(engine, specs)
    srv_b = _mk_server(engine, specs)
    for name in sorted(specs):
        x = demo_batch(specs[name], BATCH_SLOT, seed=5)
        srv_a.enqueue(name, x)
        srv_b.enqueue(name, x)
    out_a = srv_a.flush()
    out_b = srv_b.collect(srv_b.flush_async())
    assert set(out_a) == set(out_b) == set(specs)
    for name in out_a:
        assert np.array_equal(out_a[name], out_b[name]), name


def test_empty_flush_is_cheap_noop(roster):
    """Nothing pending: no bank build, no launch, and an idle scheduler
    step is free."""
    specs, engine = roster
    srv = _mk_server(engine, specs)
    assert srv.flush() == {}
    assert srv.flush_async() is None
    assert srv.collect(None) == {}
    assert srv.stacked_launches == 0 and srv.requests == 0
    assert not srv._banks
    sched = TMScheduler(srv)
    assert sched.step() == 0
    assert sched.launches == 0
    t0 = time.perf_counter()
    for _ in range(100):
        srv.flush()
    assert (time.perf_counter() - t0) < 0.5


# ---------------------------------------------------------------------------
# SLA queues: deadline-aware dequeue + admission control
# ---------------------------------------------------------------------------

def test_deadline_aware_dequeue_order(roster):
    specs, engine = roster
    names = ["t_batch", "t_std", "t_gold"]
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    for n in names:
        srv.register(n, specs["cotm"], seed=3)
    sched = TMScheduler(srv, SchedulerConfig(max_batch_tenants=1))
    for n, sla in zip(names, (BATCH, STANDARD, GOLD)):
        sched.set_sla(n, sla)
    order = []
    x = demo_batch(specs["cotm"], BATCH_SLOT, seed=4)
    for n in names:                       # batch-class submitted first
        sched.submit(n, x).add_done_callback(
            lambda _f, n=n: order.append(n))
    sched.drain()
    assert order == ["t_gold", "t_std", "t_batch"]
    assert sched.launches == 3


def test_admission_control_backpressure(roster):
    specs, engine = roster
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    srv.register("t0", specs["cotm"], seed=3)
    sched = TMScheduler(srv, default_sla=SLAClass(max_queue_depth=2))
    x = demo_batch(specs["cotm"], BATCH_SLOT, seed=4)
    f1, f2 = sched.submit("t0", x), sched.submit("t0", x)
    with pytest.raises(Backpressure, match="depth cap"):
        sched.submit("t0", x)
    assert sched.rejected == 1
    assert sched.stats()["tenants"]["t0"]["rejected"] == 1
    sched.drain()
    assert f1.result(timeout=1) is not None
    assert f2.result(timeout=1) is not None
    sched.submit("t0", x)
    sched.drain()


def test_per_tenant_fifo_within_batching(roster):
    specs, engine = roster
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    srv.register("t0", specs["cotm"], seed=3)
    sched = TMScheduler(srv)
    xs = [demo_batch(specs["cotm"], BATCH_SLOT, seed=s) for s in range(3)]
    futs = [sched.submit("t0", x) for x in xs]
    sched.drain()
    ref_srv = TMServer(engine, batch_slot=BATCH_SLOT)
    ref_srv.register("t0", specs["cotm"], seed=3)
    ref = _sync_results(ref_srv, [("t0", x) for x in xs])
    for fut, want in zip(futs, ref):
        assert np.array_equal(fut.result(timeout=1), want)
    assert sched.launches == 3


# ---------------------------------------------------------------------------
# pipelining
# ---------------------------------------------------------------------------

def test_pipeline_keeps_launches_in_flight(roster):
    specs, engine = roster
    srv = _mk_server(engine, specs, names=["cotm", "vanilla"])
    sched = TMScheduler(srv, SchedulerConfig(pipeline_depth=2))
    x = demo_batch(specs["cotm"], BATCH_SLOT, seed=4)
    depth_seen = 0
    for _ in range(4):
        sched.submit("cotm", x)
        sched.submit("vanilla", demo_batch(specs["vanilla"], BATCH_SLOT,
                                           seed=5))
        sched.step(force=True)
        depth_seen = max(depth_seen, len(sched._in_flight))
        assert len(sched._in_flight) <= 2
    assert depth_seen == 2
    sched.drain()
    assert not sched._in_flight
    assert sched.completed == sched.submitted == 8


# ---------------------------------------------------------------------------
# dynamic bank membership
# ---------------------------------------------------------------------------

def test_server_swap_resident_routed(roster):
    """A swapped tenant takes the demoted tenant's slot through two slot
    operations; answers equal the unrestricted server's, and the
    demoted tenant is served cold."""
    specs, engine = roster
    flat = [n for n in sorted(specs) if specs[n].kind != "conv"]
    srv = _mk_server(engine, specs, names=flat)
    srv.set_resident(flat[:2])
    assert srv.resident_names(False) == flat[:2]
    ref = _mk_server(engine, specs, names=flat)

    def serve_one(s, name):
        x = demo_batch(specs[name], BATCH_SLOT, seed=8)
        s.enqueue(name, x)
        return s.flush()[name]

    assert np.array_equal(serve_one(srv, flat[0]), serve_one(ref, flat[0]))
    assert np.array_equal(serve_one(srv, flat[2]), serve_one(ref, flat[2]))
    assert srv.cold_requests == 1
    route = srv.swap_resident(flat[0], flat[2])
    assert route is not None and route.index == 0
    assert (route.device, route.slot, route.conv) == (0, 0, False)
    assert srv.resident_names(False) == [flat[2], flat[1]]
    assert srv.membership_swaps == 1
    before = srv.cold_requests
    assert np.array_equal(serve_one(srv, flat[2]), serve_one(ref, flat[2]))
    assert srv.cold_requests == before
    assert np.array_equal(serve_one(srv, flat[0]), serve_one(ref, flat[0]))
    assert srv.cold_requests == before + 1
    st = srv.stats()
    assert st["resident_tenants"] == 2 and st["swapped_tenants"] == 2
    assert st["pod_devices"] == 1
    # growing the roster restacks at the next flush
    assert srv.add_resident(flat[3]) is None
    assert srv.resident_names(False) == [flat[2], flat[1], flat[3]]
    assert np.array_equal(serve_one(srv, flat[3]), serve_one(ref, flat[3]))
    assert srv.cold_requests == before + 1 and srv.membership_swaps == 2


def test_scheduler_promotes_hot_tenant(roster):
    """EWMA membership: sustained traffic to a swapped tenant promotes it
    (demoting the coldest) and answers stay exact."""
    specs, engine = roster
    flat = [n for n in sorted(specs) if specs[n].kind != "conv"]
    srv = _mk_server(engine, specs, names=flat)
    sched = TMScheduler(srv, SchedulerConfig(
        resident_slots=2, membership_every=1, min_dwell_ticks=0,
        promote_min_qps=1e-6, promote_margin=1.01))
    assert srv.resident_names(False) == flat[:2]
    hot = flat[2]
    x = demo_batch(specs[hot], BATCH_SLOT, seed=9)
    ref = _mk_server(engine, specs, names=flat)
    ref.enqueue(hot, x)
    want = ref.flush()[hot]
    results = []
    for _ in range(6):
        f = sched.submit(hot, x)
        sched.drain()
        results.append(f.result(timeout=1))
    assert sched.promotions >= 1 and sched.demotions >= 1
    assert hot in srv.resident_names(False)
    assert len(srv.resident_names(False)) == 2
    for r in results:
        assert np.array_equal(r, want)
    assert srv.cold_requests >= 1
    assert sched.stats()["tenants"][hot]["resident"] is True


# ---------------------------------------------------------------------------
# stats surfaces + thread mode
# ---------------------------------------------------------------------------

def test_server_stats_surface(roster):
    specs, engine = roster
    srv = _mk_server(engine, specs, names=["cotm", "vanilla"])
    srv.set_resident(["cotm"])
    st = srv.stats()
    assert st["queue_depth"] == 0
    assert st["resident_tenants"] == 1 and st["swapped_tenants"] == 1
    assert st["last_flush_latency_s"] == {}
    srv.enqueue("cotm", demo_batch(specs["cotm"], BATCH_SLOT, seed=4))
    assert srv.stats()["queue_depth"] == 1
    srv.flush()
    st = srv.stats()
    assert st["queue_depth"] == 0
    assert st["last_flush_latency_s"]["cotm"] > 0
    assert st["cold_requests"] == 0


def test_thread_mode_end_to_end(roster):
    specs, engine = roster
    srv = _mk_server(engine, specs, names=["cotm", "vanilla"])
    ref = _mk_server(engine, specs, names=["cotm", "vanilla"])
    sched = TMScheduler(srv, SchedulerConfig(max_wait_s=0.001))
    trace = _trace(specs, ["cotm", "vanilla"], rounds=3)
    want = _sync_results(ref, trace)
    sched.start()
    try:
        futs = [sched.submit(name, x) for name, x in trace]
        for (name, _), fut, w in zip(trace, futs, want):
            assert np.array_equal(fut.result(timeout=60), w), name
    finally:
        sched.stop()
    assert sched.completed == len(trace)
    assert sched.stats()["running"] is False


# ---------------------------------------------------------------------------
# the port's scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

def test_scheduled_results_match_the_jax_scheduler():
    """Both packages' schedulers over the same tenants (the JAX programs
    and PRNGs carried across), two resident slots per family, the same
    trace of ragged inference and training requests: the same answers,
    training stats, final programs and PRNGs, and the same cold-path
    and launch counts."""
    jspecs = jdemo_specs(small=True)
    jeng = japi.compile(japi.tile_for(*jspecs.values()), backend="ref")
    teng = api.compile(TileConfig(**dataclasses.asdict(jeng.tile)),
                       device="cpu")
    tspecs = {n: api.TMSpec.from_dict(s.to_dict()) for n, s in jspecs.items()}
    jsrv = JServer(jeng, batch_slot=BATCH_SLOT)
    tsrv = TMServer(teng, batch_slot=BATCH_SLOT)
    for i, name in enumerate(jspecs):
        jsrv.register(name, jspecs[name], seed=10 + i)
        t = jsrv.tenants[name]
        prog, prng = _bridge(t.program, t.prng)
        tsrv.register(name, tspecs[name], program=prog, prng=prng)
    cfg = dict(pipeline_depth=2, resident_slots=2, membership_every=10 ** 6)
    jsch = JScheduler(jsrv, JConfig(**cfg))
    tsch = TMScheduler(tsrv, SchedulerConfig(**cfg))
    assert tsrv.resident_names() == jsrv.resident_names()

    names = sorted(jspecs)
    rng = np.random.default_rng(3)
    trace = []
    for r in range(3):
        for i, name in enumerate(names):
            n = BATCH_SLOT if (r + i) % 2 == 0 else BATCH_SLOT // 2
            trace.append(("infer", name,
                          demo_batch(tspecs[name], n, seed=40 + 7 * r + i),
                          None))
            if (r + i) % 3 == 1:
                s = tspecs[name]
                y = (rng.random(BATCH_SLOT).astype(np.float32)
                     if s.kind == "regression"
                     else rng.integers(0, s.classes, BATCH_SLOT)
                     .astype(np.int32))
                trace.append(("train", name,
                              demo_batch(s, BATCH_SLOT, seed=90 + r + i), y))
    outs = []
    for sch in (jsch, tsch):
        futs = [sch.submit_train(n, x, y) if kind == "train"
                else sch.submit(n, x) for kind, n, x, y in trace]
        sch.drain()
        outs.append([f.result(timeout=5) for f in futs])
    for (kind, name, _, _), j, t in zip(trace, *outs):
        if kind == "train":
            assert t == j, name
        else:
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=name)
    assert tsch.trains == jsch.trains > 0
    for key in ("launches", "completed", "trains"):
        assert tsch.stats()[key] == jsch.stats()[key], key
    for key in ("cold_requests", "stacked_launches", "coalesced_requests",
                "resident", "requests"):
        assert tsrv.stats()[key] == jsrv.stats()[key], key
    assert tsrv.stats()["cold_requests"] > 0
    for name in names:
        jt, tt = jsrv.tenants[name], tsrv.tenants[name]
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, name)
        assert tt.steps == jt.steps
