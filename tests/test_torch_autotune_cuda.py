"""The dispatcher's plan cache and the analysis layer on the card.

Every test needs an NVIDIA card and nvcc; without a card each one skips
(decided inside the fixture, never at import).  Run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_autotune_cuda.py

``measure`` times every candidate on the card, persists and reloads its
plans and refuses to time inside a graph capture; engines under ``off``,
``seed`` and ``measure`` answer and train the same, graphs included; the
launch checker's restated shared memory equals the library's; the trace
audit's card legs match the port's golden.
"""
import ctypes
import json

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.analysis import kernel_check, trace_audit
from repro_torch.kernels import _build, autotune, ops
from repro_torch.launch.mesh import HardwareModel

SHAPE = (256, 256, 8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    autotune.clear_cache()
    yield
    autotune.clear_cache()


pytestmark = pytest.mark.cuda


def _spec():
    return api.TMSpec.coalesced(features=100, classes=4, clauses=120, T=16,
                                prng_backend="lfsr")


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 100)) < 0.5).astype(np.int8),
            rng.integers(0, 4, n).astype(np.int32))


@pytest.mark.parametrize("stage", ["eval", "train", "ta"])
def test_measure_times_every_candidate_and_reloads(card, tmp_path, stage):
    cache = tmp_path / "plans.json"
    b = None if stage == "ta" else 16
    ops.reset_launch_counts()
    plan = autotune.lookup(stage, b, SHAPE, mode="measure", cache=cache,
                           device="cuda")
    assert set(ops.launch_counts().values()) == {0}
    assert plan["source"] == "measure" and plan["us"] > 0
    assert all(us > 0 for by_geom in plan["candidates_us"].values()
               for us in by_geom.values())
    # the path fastest at its own geometry, the one the engine launches
    assert plan["us"] == min(
        by_geom[autotune.geometry_key(autotune.geometries(
            stage, path, b, SHAPE)[0])]
        for path, by_geom in plan["candidates_us"].items())
    assert json.loads(cache.read_text())[autotune.plan_key(
        stage, b, SHAPE)] == plan
    autotune.clear_cache()
    assert autotune.lookup(stage, b, SHAPE, mode="seed", cache=cache,
                           device="cuda") == plan


def test_measure_refuses_to_time_inside_a_capture(card, tmp_path):
    cache = tmp_path / "plans.json"
    plan = autotune.lookup("eval", 8, SHAPE, mode="measure", cache=cache,
                           device="cuda")
    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device="cuda")
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        x.add_(1)
        # planned: a lookup, no timing
        assert autotune.lookup("eval", 8, SHAPE, mode="measure",
                               cache=cache, device="cuda") == plan
        with pytest.raises(RuntimeError, match="capture"):
            autotune.lookup("eval", 64, SHAPE, mode="measure", cache=cache,
                            device="cuda")


def test_modes_answer_and_fit_the_same_on_the_card(card, tmp_path):
    spec = _spec()
    tile = api.tile_for(spec)
    cache = tmp_path / "plans.json"
    x, y = _data(256, 1)
    fits = {}
    for mode in autotune.MODES:
        eng = api.compile(tile, autotune=mode, autotune_cache=cache)
        tm = api.TM(spec, engine=eng, seed=3)
        tm.fit(x, y, epochs=1, batch=32)          # a captured epoch
        preds = {B: tm.predict(x[:B]) for B in (1, 8, 32)}
        fits[mode] = (tm.program, tm.prng, preds)
    ref = fits["off"]
    for mode in ("seed", "measure"):
        prog, prng, preds = fits[mode]
        assert all(torch.equal(a, b) for a, b in zip(prog.leaves(),
                                                     ref[0].leaves()))
        assert all(torch.equal(a, b) for a, b in zip(prng.leaves(),
                                                     ref[1].leaves()))
        for B in preds:
            assert torch.equal(preds[B], ref[2][B])
    keys = {k.split("/")[0] for k in json.loads(cache.read_text())}
    assert keys == {"eval", "train", "ta"}


def test_launch_checker_on_this_card(card):
    hw = HardwareModel.from_device(0)
    assert hw.sms == torch.cuda.get_device_properties(0).multi_processor_count
    n, violations, _ = kernel_check.check_all(hw)
    assert n > 0 and not violations, [v.render() for v in violations]
    _, fn = _build.entry("fused_step", "dtm_fused_step_smem",
                         [ctypes.c_int] * 3, ctypes.c_size_t)
    for H, W in ((16, 100), (16, 52), (10, 12), (3, 5)):
        for bulk in (0, 1):
            assert fn(H, W, bulk) == kernel_check.fused_smem(H, W,
                                                             bool(bulk))


@pytest.mark.parametrize("force", [None, "packed_vpu"])
def test_trace_audit_card_legs_match_the_golden(card, tmp_path, force):
    report = trace_audit.run_audit(device="cuda", kernel_path=force,
                                   autotune_cache=tmp_path / "none.json")
    assert report.leg.startswith("cuda|")
    assert all(v <= 1 for v in report.session_caches.values())
    assert report.session_caches["fit_epoch"] == 1
