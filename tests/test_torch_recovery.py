"""Durable streaming learning on the port: faults, checkpoints, restarts.

The single-device tests of the JAX package's ``tests/test_recovery.py``
on the port (CPU, exact):

* kill-and-restart: a roster checkpointed mid-stream and cold-started
  with ``api.serve(None, durable_dir=...)`` continues exactly as the
  uninterrupted one;
* train-while-serve: ``submit_train`` on the inference cycles gives the
  trajectory of sequential ``TMServer.train`` + ``flush``;
* faults: transient launch faults are retried with no gold request
  dropped; exhaustion fails only the affected futures;
* auto-pause on clause-skip convergence and resume on drift.

And what only the port needs: a durable directory written by the JAX
package's ``api.serve`` cold-starts in the port and both continue
identically; a writer's snapshot is a copy that no later in-place write
reaches; a tenant's PRNG is made at registration, as in the JAX server.
"""
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.launch.scheduler import GOLD as JGOLD
from repro.launch.serve_tm import TMServer as JServer
from repro.launch.serve_tm import demo_specs as jdemo_specs
from repro_torch import api, checkpoint, convert
from repro_torch.core.prng import PRNG
from repro_torch.launch.scheduler import (BATCH, GOLD, Backpressure,
                                          SchedulerConfig, TMScheduler)
from repro_torch.launch.serve_tm import TMServer, demo_batch, demo_specs
from repro_torch.runtime.durable import CheckpointWriter, DurableStore
from repro_torch.runtime.fault import (FaultInjector, FaultPlan,
                                       InjectedFault, RetryPolicy,
                                       StepMonitor, with_retry)
from test_torch_prng import jax_prng_numpy
from test_torch_train import _assert_same

BATCH_SLOT = 16


@pytest.fixture(scope="module")
def roster():
    specs = demo_specs(small=True)
    engine = api.compile(api.tile_for(*specs.values()), device="cpu")
    return specs, engine


def _labels(spec, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if spec.kind == "regression":
        return rng.random(n).astype(np.float32)
    return rng.integers(0, spec.classes, n).astype(np.int32)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


# ---------------------------------------------------------------------------
# fault primitives (runtime/fault.py)
# ---------------------------------------------------------------------------

def test_fault_plan_rejects_unknown_boundary():
    with pytest.raises(ValueError, match="teleport"):
        FaultPlan(fail={"teleport": (0,)})


def test_fault_injector_fires_on_scheduled_indices():
    inj = FaultInjector(FaultPlan(fail={"launch": (1, 3)}))
    fired = []
    for _ in range(5):
        try:
            inj.check("launch")
        except InjectedFault as e:
            fired.append(e.index)
    assert fired == [1, 3]
    inj.check("encode")
    s = inj.stats()
    assert s["calls"]["launch"] == 5 and s["injected"]["launch"] == 2
    assert s["calls"]["encode"] == 1 and s["injected"]["encode"] == 0


def test_with_retry_absorbs_transient_within_budget():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise InjectedFault("launch", calls["n"] - 1)
        return "ok"

    seen = []
    out = with_retry(flaky, RetryPolicy(retries=3),
                     on_retry=lambda a, e: seen.append(a))
    assert out == "ok" and calls["n"] == 3 and seen == [0, 1]


def test_with_retry_exhaustion_and_hard_fault():
    def always():
        raise InjectedFault("launch", 0)

    with pytest.raises(InjectedFault):
        with_retry(always, RetryPolicy(retries=2))

    calls = {"n": 0}

    def hard():
        calls["n"] += 1
        raise InjectedFault("collect", 0, transient=False)

    with pytest.raises(InjectedFault):
        with_retry(hard, RetryPolicy(retries=5))
    assert calls["n"] == 1


def test_step_monitor_flags_stragglers_and_clamps_fold_in():
    m = StepMonitor(factor=4.0, alpha=0.5, warmup=3)
    assert not any(m.record(0.01) for _ in range(4))
    assert m.record(1.0)
    assert m.ewma < 0.05
    assert m.record(1.0)
    s = m.stats()
    assert s["stragglers"] == 2 and s["samples"] == 6
    assert m.mean == pytest.approx(m.ewma)


# ---------------------------------------------------------------------------
# durable substrate (runtime/durable.py)
# ---------------------------------------------------------------------------

def test_durable_store_manifest_roundtrip(tmp_path):
    store = DurableStore(str(tmp_path / "dur"))
    assert store.read_manifest() is None
    m = {"version": 1, "batch_slot": 8, "tenants": {"t0": {"seed": 3}}}
    store.write_manifest(m)
    store.write_manifest(m)
    assert store.read_manifest() == m
    assert not [f for f in os.listdir(store.root) if ".tmp" in f]


def test_checkpoint_writer_retries_failed_save(tmp_path):
    store = DurableStore(str(tmp_path / "dur"))
    inj = FaultInjector(FaultPlan(fail={"checkpoint": (0,)}))
    w = CheckpointWriter(
        store, lambda name: (4, {"w": np.arange(4, dtype=np.int32)}),
        injector=inj)
    w.mark_dirty("t0")
    w.flush()
    assert w.failures == 1 and w.saves == 0
    assert w.stats()["dirty"] == 1
    assert w.last_error is not None
    assert store.latest_tenant_step("t0") is None
    w.flush()
    assert w.saves == 1 and w.stats()["dirty"] == 0
    assert store.latest_tenant_step("t0") == 4
    assert w.last_saved["t0"] == 4


# ---------------------------------------------------------------------------
# train-while-serve: scheduled streams == sequential train
# ---------------------------------------------------------------------------

def test_train_while_serve_bit_identical_to_sequential(roster):
    specs, engine = roster
    names = sorted(specs)

    def mk_server():
        srv = TMServer(engine, batch_slot=BATCH_SLOT)
        for n in names:
            srv.register(n, specs[n], seed=2)
        return srv

    trace = []
    for r in range(2):
        for i, n in enumerate(names):
            s = 31 + 5 * r + i
            trace.append(("train", n, demo_batch(specs[n], BATCH_SLOT,
                                                 seed=s),
                          _labels(specs[n], BATCH_SLOT, seed=s + 1)))
            trace.append(("infer", n, demo_batch(specs[n], BATCH_SLOT,
                                                 seed=s + 2), None))

    srv_ref = mk_server()
    ref = []
    for kind, n, x, y in trace:
        if kind == "train":
            ref.append(srv_ref.train(n, x, y))
        else:
            srv_ref.enqueue(n, x)
            ref.append(srv_ref.flush()[n])

    srv_sch = mk_server()
    sched = TMScheduler(srv_sch, SchedulerConfig(pipeline_depth=2))
    futs = [sched.submit_train(n, x, y) if kind == "train"
            else sched.submit(n, x)
            for kind, n, x, y in trace]
    sched.drain()
    assert sched.trains == 2 * len(names)
    for (kind, n, _, _), fut, want in zip(trace, futs, ref):
        got = fut.result(timeout=5)
        if kind == "train":
            assert got["applied"] and not got["paused"]
            assert {k: got[k] for k in want} == want, n
        else:
            assert np.array_equal(got, want), n
    for n in names:
        a, b = srv_ref.tenants[n], srv_sch.tenants[n]
        assert _same(a.program, b.program) and _same(a.prng, b.prng), n


# ---------------------------------------------------------------------------
# fault injection + recovery at the driver boundaries
# ---------------------------------------------------------------------------

def test_transient_launch_faults_recovered_zero_gold_drops(roster):
    specs, engine = roster
    names = ["cotm", "regression"]
    srv_ref = TMServer(engine, batch_slot=BATCH_SLOT)
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    for n in names:
        srv_ref.register(n, specs[n], seed=2)
        srv.register(n, specs[n], seed=2)

    inj = FaultInjector(FaultPlan(fail={"launch": (0, 2)}))
    sched = TMScheduler(srv, SchedulerConfig(retries=3), injector=inj)
    for n in names:
        sched.set_sla(n, GOLD)

    trace = [(n, demo_batch(specs[n], BATCH_SLOT, seed=50 + r))
             for r in range(2) for n in names]
    ref = []
    for n, x in trace:
        srv_ref.enqueue(n, x)
        ref.append(srv_ref.flush()[n])

    futs = [sched.submit(n, x) for n, x in trace]
    sched.drain()
    for (n, _), fut, want in zip(trace, futs, ref):
        assert np.array_equal(fut.result(timeout=5), want), n
    assert sched.completed == sched.submitted == len(trace)
    assert sched.faults == 0 and sched.failed == 0
    assert sched.retries == 2
    assert inj.stats()["injected"]["launch"] == 2


def test_retry_exhaustion_fails_batch_then_recovers(roster):
    specs, engine = roster
    srv_ref = TMServer(engine, batch_slot=BATCH_SLOT)
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    for s in (srv_ref, srv):
        s.register("cotm", specs["cotm"], seed=2)
        s.register("regression", specs["regression"], seed=2)

    inj = FaultInjector(FaultPlan(fail={"launch": (0, 1, 2)}))
    sched = TMScheduler(srv, SchedulerConfig(retries=2,
                                             degrade_cooldown_s=30.0),
                        injector=inj)
    sched.set_sla("cotm", GOLD)
    sched.set_sla("regression", BATCH)

    x = demo_batch(specs["cotm"], BATCH_SLOT, seed=60)
    fut = sched.submit("cotm", x)
    sched.drain()
    exc = fut.exception(timeout=5)
    assert isinstance(exc, InjectedFault) and exc.transient
    assert sched.faults == 1 and sched.failed == 1
    assert not srv._pending
    assert inj.stats()["injected"]["launch"] == 3

    assert sched.stats()["recovering"]
    with pytest.raises(Backpressure):
        sched.submit("regression",
                     demo_batch(specs["regression"], BATCH_SLOT, seed=61))
    assert sched.degraded_rejections == 1
    x2 = demo_batch(specs["cotm"], BATCH_SLOT, seed=62)
    srv_ref.enqueue("cotm", x2)
    want = srv_ref.flush()["cotm"]
    fut2 = sched.submit("cotm", x2)
    sched.drain()
    assert np.array_equal(fut2.result(timeout=5), want)


def test_hard_encode_fault_fails_only_that_request(roster):
    specs, engine = roster
    srv_ref = TMServer(engine, batch_slot=BATCH_SLOT)
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    for s in (srv_ref, srv):
        s.register("cotm", specs["cotm"], seed=2)
        s.register("regression", specs["regression"], seed=2)

    inj = FaultInjector(FaultPlan(fail={"encode": (0,)}, transient=False))
    sched = TMScheduler(srv, injector=inj)
    xa = demo_batch(specs["cotm"], BATCH_SLOT, seed=70)
    xb = demo_batch(specs["regression"], BATCH_SLOT, seed=71)
    srv_ref.enqueue("regression", xb)
    want = srv_ref.flush()["regression"]

    fa = sched.submit("cotm", xa)
    fb = sched.submit("regression", xb)
    sched.drain()
    exc = fa.exception(timeout=5)
    assert isinstance(exc, InjectedFault) and not exc.transient
    assert sched.retries == 0
    assert np.array_equal(fb.result(timeout=5), want)
    assert sched.faults == 1 and sched.completed == 1


# ---------------------------------------------------------------------------
# drift/skip auto-pause of converged training streams
# ---------------------------------------------------------------------------

def test_auto_pause_probe_and_drift_resume(roster):
    specs, engine = roster
    spec = specs["cotm"]
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    srv.register("t", spec, seed=2)
    sched = TMScheduler(srv, SchedulerConfig(
        pause_skip_threshold=0.0, pause_min_steps=4,
        resume_acc_drop=0.05, drift_alpha=1.0))
    x = demo_batch(spec, BATCH_SLOT, seed=80)
    y = x[:, 0].astype(np.int32)
    for _ in range(4):
        sched.submit_train("t", x, y)
    sched.drain()
    assert sched.trains == 4 and sched.pauses == 1
    assert sched.stats()["tenants"]["t"]["paused"]

    # a paused stream serves eval probes: no step, no TA change (the
    # pause-time baseline pinned below any probe accuracy)
    sched._tenants["t"].paused_at_acc = 0.0
    ta0 = srv.tenants["t"].program.ta.clone()
    f1 = sched.submit_train("t", x, y)
    sched.drain()
    out = f1.result(timeout=5)
    assert out["paused"] and not out["applied"]
    assert torch.equal(srv.tenants["t"].program.ta, ta0)
    assert sched.stats()["tenants"]["t"]["probes"] == 1
    assert sched.trains == 4

    # drift: the baseline above any probe accuracy resumes training and
    # applies the triggering step
    sched._tenants["t"].paused_at_acc = 2.0
    f2 = sched.submit_train("t", x, 1 - y)
    sched.drain()
    out = f2.result(timeout=5)
    assert out.get("resumed") and out["applied"]
    assert sched.resumes == 1 and sched.trains == 5
    assert not torch.equal(srv.tenants["t"].program.ta, ta0)
    assert sched.pauses == 2 and sched.stats()["tenants"]["t"]["paused"]


# ---------------------------------------------------------------------------
# kill-and-restart bit-identity through the durable store
# ---------------------------------------------------------------------------

_DUR_NAMES = ("cotm", "regression")


def _durable_roster():
    specs = demo_specs(small=True)
    return {n: specs[n] for n in _DUR_NAMES}


def _run_stream(sched, specs, rounds: int, seed0: int):
    """A deterministic interleaved train + infer continuation; returns
    the per-request results (train stats dicts, prediction arrays)."""
    futs = []
    for r in range(rounds):
        for n in sorted(specs):
            s = seed0 + 3 * r
            xt = demo_batch(specs[n], BATCH_SLOT, seed=s)
            yt = _labels(specs[n], BATCH_SLOT, seed=s + 1)
            futs.append(("train", n, sched.submit_train(n, xt, yt)))
            xi = demo_batch(specs[n], BATCH_SLOT, seed=s + 2)
            futs.append(("infer", n, sched.submit(n, xi)))
    sched.drain()
    return [(kind, n, fut.result(timeout=5)) for kind, n, fut in futs]


def _assert_streams_equal(out_a, out_b):
    assert len(out_a) == len(out_b)
    for (ka, na, ra), (kb, nb, rb) in zip(out_a, out_b):
        assert (ka, na) == (kb, nb)
        if ka == "train":
            assert ra == rb, na
        else:
            np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb),
                                          err_msg=na)


def test_kill_and_restart_bit_identical(tmp_path):
    d = str(tmp_path / "durable")
    specs = _durable_roster()
    a = api.serve(dict(specs), batch_slot=BATCH_SLOT, device="cpu",
                  durable_dir=d, slas={"cotm": GOLD})
    _run_stream(a, specs, rounds=2, seed0=100)
    a.checkpoint_now()

    probe = {n: demo_batch(specs[n], BATCH_SLOT, seed=7) for n in specs}
    steps_a = {n: a.server.tenants[n].steps for n in specs}
    ta_a = {n: a.server.tenants[n].program.ta.clone() for n in specs}
    preds_a = {n: a.server.predict(n, probe[n]) for n in specs}
    assert all(steps_a[n] == 2 for n in specs)

    # the "crash": b rebuilds the roster, the SLAs and every tenant's
    # program, PRNG and step count from the directory alone
    b = api.serve(None, durable_dir=d, device="cpu")
    assert sorted(b.server.tenants) == sorted(specs)
    assert b.server.batch_slot == BATCH_SLOT
    assert b.sla_of("cotm").name == "gold" and b.sla_of("cotm").priority == 4
    for n in specs:
        ta_, tb_ = a.server.tenants[n], b.server.tenants[n]
        assert tb_.steps == steps_a[n], n
        assert _same(ta_.program, tb_.program), n      # inc rebuilt equal
        assert _same(ta_.prng, tb_.prng), n
        np.testing.assert_array_equal(b.server.predict(n, probe[n]),
                                      preds_a[n])

    out_a = _run_stream(a, specs, rounds=2, seed0=200)
    out_b = _run_stream(b, specs, rounds=2, seed0=200)
    _assert_streams_equal(out_a, out_b)
    for n in specs:
        ta_, tb_ = a.server.tenants[n], b.server.tenants[n]
        assert _same(ta_.program, tb_.program) and _same(ta_.prng, tb_.prng)
        assert not torch.equal(ta_.program.ta, ta_a[n]), (
            "the continuation must actually train")


def test_background_writer_persists_without_explicit_barrier(tmp_path):
    d = str(tmp_path / "durable")
    specs = _durable_roster()
    sched = api.serve(dict(specs), batch_slot=BATCH_SLOT, device="cpu",
                      durable_dir=d,
                      config=SchedulerConfig(ckpt_interval_s=0.01))
    sched.start()
    try:
        futs = [sched.submit_train(
                    "cotm", demo_batch(specs["cotm"], BATCH_SLOT, seed=s),
                    _labels(specs["cotm"], BATCH_SLOT, seed=s + 1))
                for s in (300, 301, 302)]
        for f in futs:
            assert f.result(timeout=60)["applied"]
    finally:
        sched.stop()
    store = DurableStore(d)
    assert store.latest_tenant_step("cotm") == 3
    assert store.latest_tenant_step("regression") is None
    ck = sched.stats()["checkpoint"]
    assert ck["saves"] >= 1 and ck["dirty"] == 0 and not ck["running"]


# ---------------------------------------------------------------------------
# what only the port needs
# ---------------------------------------------------------------------------

def test_jax_durable_dir_cold_starts_in_the_port(tmp_path):
    """A manifest and tenant checkpoints written by the JAX package's
    ``api.serve`` (every tenant trained, so none relies on its seed's
    program draw) cold-start in the port; both stacks then continue one
    train + infer stream identically."""
    d = str(tmp_path / "durable")
    jspecs = jdemo_specs(small=True)
    tspecs = {n: api.TMSpec.from_dict(s.to_dict()) for n, s in jspecs.items()}
    a = japi.serve(dict(jspecs), batch_slot=BATCH_SLOT, backend="ref",
                   durable_dir=d, slas={"cotm": JGOLD}, seed=4)
    _run_stream(a, tspecs, rounds=1, seed0=500)
    a.checkpoint_now()
    assert all(a.server.tenants[n].steps == 1 for n in jspecs)

    b = api.serve(None, durable_dir=d, device="cpu")
    assert sorted(b.server.tenants) == sorted(jspecs)
    assert b.server.batch_slot == BATCH_SLOT
    assert b.sla_of("cotm").name == "gold"
    for n in jspecs:
        jt, tt = a.server.tenants[n], b.server.tenants[n]
        assert tt.steps == jt.steps == 1
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)

    out_a = _run_stream(a, tspecs, rounds=2, seed0=600)
    out_b = _run_stream(b, tspecs, rounds=2, seed0=600)
    _assert_streams_equal(out_a, out_b)
    for n in jspecs:
        jt, tt = a.server.tenants[n], b.server.tenants[n]
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)
        assert tt.steps == jt.steps == 3
    # and the port's own checkpoints of the continuation load in JAX
    b.checkpoint_now()
    c = japi.serve(None, durable_dir=d, backend="ref")
    for n in jspecs:
        jt, tt = c.server.tenants[n], b.server.tenants[n]
        _assert_same(tt.program, tt.prng, jt.program, jt.prng, n)


def test_snapshot_is_a_copy_no_later_write_reaches(tmp_path):
    """The writer's snapshot, then a donated (in-place) TA update of the
    live program, two more training steps and a ``swap_resident``
    before the save: the file holds the program as it was at the
    snapshot."""
    specs = demo_specs(small=True)
    flat = {n: specs[n] for n in ("cotm", "vanilla", "regression")}
    d = str(tmp_path / "durable")
    sched = api.serve(flat, batch_slot=BATCH_SLOT, device="cpu",
                      durable_dir=d, config=SchedulerConfig(resident_slots=2))
    srv = sched.server
    assert srv.resident_names(False) == ["cotm", "vanilla"]
    x = demo_batch(flat["cotm"], BATCH_SLOT, seed=1)
    y = _labels(flat["cotm"], BATCH_SLOT, seed=2)
    sched.submit_train("cotm", x, y)
    for n in flat:                                     # builds the bank
        sched.submit(n, demo_batch(flat[n], BATCH_SLOT, seed=3))
    sched.drain()

    step, tree = sched._snapshot("cotm")
    t = srv.tenants["cotm"]
    want = {"ta": t.program.ta.clone(), "weights": t.program.weights.clone(),
            "prng": t.prng.map(torch.clone)}
    assert step == 1
    # a donated step writes the live TA states in place
    live_ta = t.program.ta
    prog, prng, _ = srv.engine.train_step(
        t.program, t.prng, srv.engine.encode(flat["cotm"], x),
        flat["cotm"].encode_labels((y + 1) % 4), donate=True)
    assert prog.ta.data_ptr() == live_ta.data_ptr()
    assert not torch.equal(live_ta, want["ta"])        # written in place
    for s in (4, 5):
        sched.submit_train("cotm", demo_batch(flat["cotm"], BATCH_SLOT,
                                              seed=s),
                           _labels(flat["cotm"], BATCH_SLOT, seed=s))
    sched.drain()
    assert srv.swap_resident("cotm", "regression") is not None
    DurableStore(d).save_tenant("cotm", step, tree)

    got = DurableStore(d).load_tenant("cotm", like=want)
    assert got[0] == 1
    for k in ("ta", "weights"):
        assert torch.equal(got[1][k], want[k]), k
    assert _same(got[1]["prng"], want["prng"])
    assert not torch.equal(srv.tenants["cotm"].program.weights,
                           want["weights"])


def test_concurrent_submitters_and_writer_stress(roster, tmp_path):
    """More submitter threads than cores, a stats reader, the driver and
    the writer on their own threads, a short switch interval: no request
    is lost or answered twice, the answers are the synchronous twin's,
    and every step the writer published holds the program of exactly
    that many training steps."""
    specs, engine = roster
    names = ("regression", "head", "vanilla")
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    twin = TMServer(engine, batch_slot=BATCH_SLOT)
    for n in ("cotm",) + names:
        srv.register(n, specs[n], seed=4)
        twin.register(n, specs[n], seed=4)
    store = DurableStore(str(tmp_path / "durable"), keep=0)
    sched = TMScheduler(srv, SchedulerConfig(ckpt_interval_s=0.0005,
                                             max_wait_s=0.0002),
                        durable=store)
    trains = [(demo_batch(specs["cotm"], BATCH_SLOT, seed=700 + i),
               _labels(specs["cotm"], BATCH_SLOT, seed=800 + i))
              for i in range(8)]
    states = [twin.snapshot("cotm")[1]]
    for x, y in trains:
        twin.train("cotm", x, y)
        states.append(twin.snapshot("cotm")[1])
    n_threads = (os.cpu_count() or 4) + 2
    reqs = [[(names[(t + j) % 3],
              demo_batch(specs[names[(t + j) % 3]], BATCH_SLOT // 2,
                         seed=50 * t + j)) for j in range(6)]
            for t in range(n_threads)]
    futs, lock, done = [], threading.Lock(), threading.Event()

    def submitter(t):
        mine = [(n, x, sched.submit(n, x)) for n, x in reqs[t]]
        with lock:
            futs.extend(mine)

    def reader():
        while not done.is_set():
            st = sched.stats()
            assert st["completed"] <= st["submitted"]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    watcher = threading.Thread(target=reader)
    try:
        sched.start()
        watcher.start()
        for th in threads:
            th.start()
        tfuts = [sched.submit_train("cotm", x, y) for x, y in trains]
        for th in threads:
            th.join(timeout=60)
        got = [(n, x, f.result(timeout=60)) for n, x, f in futs]
        tgot = [f.result(timeout=60) for f in tfuts]
    finally:
        done.set()
        watcher.join(timeout=60)
        sched.stop()
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads + [watcher])
    assert len(got) == n_threads * 6 and all(r["applied"] for r in tgot)
    st = sched.stats()
    assert st["submitted"] == st["completed"] == len(got) + len(trains)
    assert st["failed"] == 0 and st["rejected"] == 0
    assert sum(t["completed"] for t in st["tenants"].values()) == \
        st["completed"]
    for n, x, answer in got:
        twin.enqueue(n, x)
        np.testing.assert_array_equal(answer, twin.flush()[n], err_msg=n)
    steps = sorted(int(e.split("_")[1]) for e in os.listdir(
        store.tenant_dir("cotm")) if ".tmp" not in e)
    assert steps and steps[-1] == len(trains)
    for step in steps:
        tree, _ = checkpoint.restore(store.tenant_dir("cotm"), step,
                                     states[0])
        for k in ("ta", "weights"):
            assert torch.equal(tree[k], states[step][k]), (step, k)
        assert _same(tree["prng"], states[step]["prng"]), step


def test_register_makes_the_prng_eagerly(roster):
    """A tenant that never trained has the ``PRNG.create(cfg, seed + 1)``
    state in its snapshot, the JAX server's registration PRNG."""
    specs, engine = roster
    spec = api.TMSpec.coalesced(features=32, classes=4, clauses=24, T=16,
                                prng_backend="lfsr", lfsr_bits=12)
    srv = TMServer(engine, batch_slot=BATCH_SLOT)
    srv.register("t", spec, seed=5)
    step, tree = srv.snapshot("t")
    assert step == 0
    assert _same(tree["prng"], PRNG.create(spec.tm_config(), 6,
                                           device="cpu"))
    jeng = japi.compile(japi.tile_for(*jdemo_specs(small=True).values()),
                        backend="ref")
    jsrv = JServer(jeng, batch_slot=BATCH_SLOT)
    jsrv.register("t", japi.TMSpec.from_dict(spec.to_dict()), seed=5)
    want = jax_prng_numpy(jsrv.tenants["t"].prng)
    for k, v in convert.prng_to_numpy(tree["prng"]).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)


def test_serve_takes_no_mesh_and_no_cpu_fallback():
    """``mesh`` must be a device mesh with a ``tenants`` axis (a
    one-device one serves as no mesh does); no CPU fallback."""
    spec = demo_specs(small=True)["cotm"]
    with pytest.raises(TypeError):
        api.serve({"t": spec}, device="cpu", mesh=object())
    one = types.SimpleNamespace(mesh_dim_names=("tenants",), shape=(1,))
    sched = api.serve({"t": spec}, device="cpu", mesh=one)
    assert sched.server.stats()["pod_devices"] == 1
    with pytest.raises(ValueError, match="tenants"):
        api.serve({"t": spec}, device="cpu", mesh=types.SimpleNamespace(
            mesh_dim_names=("clauses",), shape=(1,)))
    with pytest.raises(ValueError):
        api.serve({}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.serve({"t": spec})
