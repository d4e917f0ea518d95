"""The port's spans (``repro_torch.runtime.spans``) on the CPU: nothing is
recorded without a torch profiler; under one, ``TM.partial_fit`` and
``TM.fit`` record every span of the training path with its calls, the
records nest as the code does and sit on the profiler's own clock, no
profiler range is opened, and training is bit for bit the same with the
profiler on.  (``graph.capture`` runs only on the card.)"""
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import api
from repro_torch.runtime import spans

SPEC = api.TMSpec.coalesced(features=12, classes=3, clauses=20, T=8,
                            prng_backend="lfsr", lfsr_bits=12)
EPOCHS = 2
# calls of each span: two partial_fit steps, then a fit of EPOCHS epochs
CALLS = {"tm.partial_fit": 2, "tm.fit": 1, "session.encode": 3,
         "session.epoch": EPOCHS, "epoch.plan": 2 * EPOCHS,
         "epoch.fetch": EPOCHS, "step.load": 2 + EPOCHS,
         "step.unload": 2 + EPOCHS, "graph.run": 2 + EPOCHS,
         "engine.graph_build": 2}
# the spans that may open directly around each span
PARENTS = {"tm.partial_fit": {None}, "tm.fit": {None},
           "session.encode": {"tm.partial_fit", "tm.fit"},
           "session.epoch": {"tm.fit"},
           "epoch.plan": {"session.epoch"},
           "epoch.fetch": {"session.epoch"},
           "step.load": {"tm.partial_fit", "session.epoch"},
           "step.unload": {"tm.partial_fit", "session.epoch"},
           "graph.run": {"tm.partial_fit", "session.epoch"},
           "engine.graph_build": {"tm.partial_fit", "session.epoch"}}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, SPEC.features)) < 0.5).astype(np.int8)
    return x, rng.integers(0, SPEC.classes, n).astype(np.int32)


def _train(tm):
    """Two identical partial_fit steps, then a fit: (stats, history)."""
    x, y = _data(64, 3)
    stats = [tm.partial_fit(x[:4], y[:4]) for _ in range(2)]
    hist = tm.fit(x, y, epochs=EPOCHS, batch=16,
                  rng=np.random.default_rng(5))
    return stats, hist


def _tm():
    return api.TM(SPEC, device="cpu", seed=7)


@pytest.fixture(scope="module")
def traced():
    """One profiled run of :func:`_train` on a fresh TM: the totals, the
    records, the profiler's events and what was trained."""
    tm = _tm()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _train(tm)
    res = dict(totals=spans.totals(), records=spans.records(), prof=prof,
               tm=tm, out=out)
    spans.reset()
    return res


def test_off_nothing_is_recorded_and_span_is_the_shared_noop():
    spans.reset()
    _train(_tm())
    assert spans.totals() == {} and spans.records() == []
    assert spans.span("tm.fit") is spans.OFF
    with spans.span("x") as s:
        assert s is spans.OFF
    assert spans.totals() == {}


def test_the_profiler_flag_flips_under_the_profiler():
    """Recording keys on this flag: a torch that drops it fails here
    rather than silently recording nothing."""
    assert autograd_profiler._is_profiler_enabled is False
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        seen.append(autograd_profiler._is_profiler_enabled)
        t = threading.Thread(target=lambda: seen.append(
            autograd_profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert not isinstance(spans.span("x"), type(spans.OFF))
    assert seen == [True, True]
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("name", sorted(CALLS))
def test_profiled_training_records_each_span_with_its_calls(traced, name):
    assert traced["totals"][name]["calls"] == CALLS[name]
    assert traced["totals"][name]["total_s"] > 0
    assert sum(r.name == name for r in traced["records"]) == CALLS[name]


def test_no_capture_on_the_cpu(traced):
    assert set(traced["totals"]) == set(CALLS)
    assert "graph.capture" not in traced["totals"]


def test_self_time_is_the_span_less_its_children(traced):
    recs = traced["records"]
    child_ns = [0] * len(recs)
    for r in recs:
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        if r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    by_name = {}
    for r, c in zip(recs, child_ns):
        assert c <= r.end_ns - r.start_ns        # children fit inside
        tot = by_name.setdefault(r.name, [0, 0])
        tot[0] += r.end_ns - r.start_ns
        tot[1] += r.end_ns - r.start_ns - c
    for name, t in traced["totals"].items():
        assert 0 <= t["self_s"] <= t["total_s"]
        assert t["total_s"] == pytest.approx(by_name[name][0] * 1e-9,
                                             abs=1e-9)
        assert t["self_s"] == pytest.approx(by_name[name][1] * 1e-9,
                                            abs=1e-9)
    fit = traced["totals"]["tm.fit"]
    assert fit["self_s"] < fit["total_s"]


def test_records_nest_as_the_code_does(traced):
    recs = traced["records"]
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        assert (None if parent is None else parent.name) in PARENTS[r.name]
        if parent is not None:
            assert parent.thread == r.thread
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns


def test_a_second_identical_step_builds_no_graph(traced):
    recs = traced["records"]
    steps = [i for i, r in enumerate(recs) if r.name == "tm.partial_fit"]
    builds = [r.parent for r in recs if r.name == "engine.graph_build"]
    assert steps[0] in builds and steps[1] not in builds


def test_the_port_opens_no_profiler_range(traced):
    names = {e.name for e in traced["prof"].events()}
    assert not names & set(CALLS)


def test_records_sit_on_the_profilers_raw_clock():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("beside"):
            with record_function("calibration_range"):
                pass
    rec, = spans.records()
    start, = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "calibration_range"]
    assert abs(start - rec.start_ns) < 1_000_000
    spans.reset()


def test_a_span_on_another_thread_keeps_its_own_parents():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("main.outer"):
            def work():
                with spans.span("thread.outer"):
                    with spans.span("thread.inner"):
                        pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    recs = {r.name: r for r in spans.records()}
    assert recs["thread.outer"].parent is None
    assert spans.records()[recs["thread.inner"].parent].name == \
        "thread.outer"
    assert recs["thread.inner"].thread != recs["main.outer"].thread
    assert spans.totals()["main.outer"]["self_s"] == pytest.approx(
        spans.totals()["main.outer"]["total_s"])
    spans.reset()


def test_past_the_cap_records_stop_and_the_sums_go_on(monkeypatch):
    spans.reset()
    monkeypatch.setattr(spans.RECORDER, "cap", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with spans.span("capped"):
                pass
    assert len(spans.records()) == 3 and spans.RECORDER.dropped == 2
    assert spans.totals()["capped"]["calls"] == 5
    spans.reset()
    assert spans.RECORDER.dropped == 0 and spans.totals() == {}


def test_training_is_the_same_with_the_profiler_on(traced):
    spans.reset()
    tm = _tm()
    stats, hist = _train(tm)
    (t_stats, t_hist), t_tm = traced["out"], traced["tm"]
    assert hist == t_hist
    for a, b in zip(stats, t_stats):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(tm.program.leaves() + tm.prng.leaves(),
                    t_tm.program.leaves() + t_tm.prng.leaves()):
        assert torch.equal(a, b)
