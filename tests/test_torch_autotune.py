"""The port's dispatcher plan cache against the JAX package's (CPU).

``kernels/autotune.py`` keeps the JAX package's modes, stages, buckets
and plan keys; under ``autotune="off"`` the port's ``select_path`` and
the engine's ``path_per_stage`` equal the JAX package's under
``REPRO_AUTOTUNE=off`` (set on the JAX side only: the port takes
arguments); ``seed`` plans are the H100 cost model's; ``measure`` plans
persist to their file, reload, outrank the seed and never hide a failing
candidate; engines under the three modes answer the same.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.launch import tm_perf as jperf
from repro_torch import api as tapi
from repro_torch.core.types import TileConfig
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops as tops
from repro_torch.launch import tm_perf
from test_torch_train import _assert_same, _bridge, _data, _jspec, _tspec

BATCHES = (None, 1, 4, 5, 8, 16, 17, 32, 256)
SHAPES = ((256, 128, 4), (1664, 2048, 16), (3200, 4224, 16))   # L, R, H
TINY = (64, 32, 4)


# the override keys of each path's geometry (``tat.geometries``); the
# dense clause and TA wrappers take none
GEOM_KEYS = {"packed_vpu": ("lanes", "warps"), "mxu_popcount": ("warps",),
             "mxu": (), "fused": ("cluster",), "dense": (), "compact": ()}
# seed plans as recorded before the launch-geometry sweep: it leaves them
SEED_BEFORE_SWEEP = {
    ("eval", 1, SHAPES[2]): ("packed_vpu", {"lanes": 8, "rows_per_warp": 4,
                                            "warps": 4, "grid": [264, 1]}),
    ("eval", 8, SHAPES[2]): ("packed_vpu", {"lanes": 8, "rows_per_warp": 4,
                                            "warps": 4, "grid": [264, 2]}),
    ("eval", 32, SHAPES[2]): ("mxu_popcount", {"warps": 1}),
    ("eval", 256, SHAPES[2]): ("mxu_popcount", {"warps": 4}),
    ("train", 8, SHAPES[2]): ("fused", {"cluster": 16}),
    ("eval", 1, SHAPES[1]): ("packed_vpu", {"lanes": 4, "rows_per_warp": 8,
                                            "warps": 1, "grid": [256, 1]}),
    ("eval", 32, SHAPES[1]): ("packed_vpu", {"lanes": 4, "rows_per_warp": 8,
                                             "warps": 4, "grid": [64, 8]}),
    ("eval", 256, SHAPES[1]): ("mxu_popcount", {"warps": 2}),
    ("train", 1, SHAPES[1]): ("packed_vpu", {"lanes": 4, "rows_per_warp": 8,
                                             "warps": 1, "grid": [256, 1]}),
    ("train", 32, SHAPES[1]): ("fused", {"cluster": 8}),
}


def _override(tiles, path):
    """A plan's ``tiles`` as the geometry override that launches them."""
    return {k: tiles[k] for k in GEOM_KEYS[path]}


@pytest.fixture(autouse=True)
def _fresh_plans():
    tat.clear_cache()
    yield
    tat.clear_cache()


@pytest.fixture
def jax_off(monkeypatch):
    for k in ("REPRO_KERNEL_PATH", "REPRO_SKIP", "REPRO_TA_PRNG",
              "REPRO_AUTOTUNE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")


@pytest.mark.parametrize("batch", BATCHES + (3, 64, 1000))
def test_bucket_and_plan_key_match_jax(batch):
    assert tat._bucket(batch) == jat._bucket(batch)
    for stage in tat.STAGES:
        for shape in SHAPES:
            assert tat.plan_key(stage, batch, shape) == jat.plan_key(
                stage, batch, shape)
    assert tat.MODES == jat.MODES and tat.STAGES == jat.STAGES


@pytest.mark.parametrize("batch", BATCHES)
def test_off_select_path_matches_jax(jax_off, batch):
    for training in (False, True):
        for lanes in (1, 4):
            for shape in SHAPES:
                want = jops.select_path(None, batch=batch, training=training,
                                        lanes=lanes, shape=shape)
                got = tops.select_path(batch, training=training, lanes=lanes,
                                       shape=shape, autotune="off",
                                       device="cpu")
                assert got == want, (batch, training, lanes, shape)


def test_off_select_ta_path_matches_jax(jax_off):
    for lanes in (1, 2):
        for shape in (None,) + SHAPES:
            assert tops.select_ta_path(lanes, shape=shape, autotune="off",
                                       device="cpu") == \
                jops.select_ta_path(lanes, shape=shape)


@pytest.mark.parametrize("shape", SHAPES + (TINY,))
def test_seed_plan_is_the_h100_models_winner(shape):
    L, R, _ = shape
    for batch in BATCHES:
        edge = batch is not None and batch <= tops.PACKED_MAX_BATCH
        b = tat._bucket(batch) or 256
        want = ("packed_vpu" if edge
                else tm_perf.packed_eval_costs(b, L, R)["winner"])
        plan = tat.lookup("eval", batch, shape, device="cpu")
        assert plan["path"] == want and plan["source"] == "seed"
        assert plan["tiles"] == tat.tiles(want, batch, shape)
        assert tat.planned_path("train", batch, shape, device="cpu") == (
            "packed_vpu" if edge else "fused")
        assert tat.lookup("ta", batch, shape, device="cpu") is None
    assert tat.lookup("eval", 8, shape, mode="off", device="cpu") is None


def test_seed_agrees_with_jax_where_the_two_models_agree(monkeypatch):
    """Where the H100 and v5e models pick differently, the divergence is
    the models' (each package follows its own ``winner``); ROADMAP Queue 3
    lists those buckets with both models' seconds."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "seed")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setattr(jat, "_disk_plans", lambda: {})
    diverge = []
    for L, R, H in SHAPES:
        for batch in BATCHES:
            for stage in ("eval", "train"):
                want = jat._seed_plan(stage, batch, (L, R, H))["path"]
                got = tat.planned_path(stage, batch, (L, R, H),
                                       device="cpu")
                if got != want:
                    b = tat._bucket(batch) or 256
                    assert stage == "eval"
                    assert jperf.packed_eval_costs(b, L, R)["winner"] == want
                    assert tm_perf.packed_eval_costs(b, L, R)[
                        "winner"] == got
                    diverge.append((L, R, b))
    # the buckets ROADMAP lists: the H100 model keeps the edge kernel
    # longer where the tile kernel's chains cannot fill the card
    assert sorted(set(diverge)) == [(256, 128, 32), (256, 128, 256),
                                    (1664, 2048, 32)], diverge


@pytest.mark.parametrize("stage", ["eval", "train", "ta"])
def test_measure_persists_reloads_and_outranks_seed(tmp_path, stage):
    cache = tmp_path / "plans" / "autotune_cpu.json"
    # the TA stage is planned without a batch (key b0), as in JAX
    b3, b4 = (None, None) if stage == "ta" else (3, 4)
    tops.reset_launch_counts()
    plan = tat.lookup(stage, b3, TINY, mode="measure", cache=cache,
                      device="cpu")
    assert plan["source"] == "measure"
    want = {"eval": {"packed_vpu", "mxu_popcount", "mxu"},
            "train": {"packed_vpu", "fused", "mxu"},
            "ta": {"compact", "dense"}}[stage]
    assert set(plan["candidates_us"]) == want
    # the path by its own geometry's time (the one the engine launches),
    # ``tiles`` the path's fastest timed geometry
    own = {path: by_geom[tat.geometry_key(tat.geometries(
        stage, path, b3, TINY)[0])]
        for path, by_geom in plan["candidates_us"].items()}
    path = min(own, key=own.get)
    assert plan["path"] == path and plan["us"] == own[path]
    by_geom = plan["candidates_us"][path]
    assert tat.geometry_key(_override(plan["tiles"], path)) == min(
        by_geom, key=by_geom.get)
    assert set(tops.launch_counts().values()) == {0}
    on_disk = json.loads(cache.read_text())
    assert on_disk[tat.plan_key(stage, b3, TINY)] == plan
    assert not list(cache.parent.glob("*.tmp*"))
    tat.clear_cache()                       # a new process: the file only
    for mode in ("seed", "measure"):
        again = tat.lookup(stage, b4, TINY, mode=mode, cache=cache,
                           device="cpu")     # bucket 4 = bucket of 3
        assert again == plan and again["source"] == "measure"
    assert tat.lookup(stage, b3, TINY, mode="off", cache=cache,
                      device="cpu") is None
    # the path the dispatcher takes is the measured one
    if stage == "ta":
        assert tops.select_ta_path(1, shape=TINY, cache=cache,
                                   device="cpu") == plan["path"]
    else:
        assert tops.select_path(3, training=stage == "train", shape=TINY,
                                cache=cache, device="cpu") == plan["path"]


def test_measure_on_a_read_only_cache_keeps_the_plan_in_memory(tmp_path):
    blocker = tmp_path / "home"
    blocker.write_text("a file where the cache directory would go")
    cache = blocker / "autotune_cpu.json"
    plan = tat.lookup("eval", 2, TINY, mode="measure", cache=cache,
                      device="cpu")
    assert plan["source"] == "measure" and not cache.exists()
    assert tat.lookup("eval", 2, TINY, mode="measure", cache=cache,
                      device="cpu") is plan


def test_a_failing_candidate_raises(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("tile kernel failed")
    monkeypatch.setattr(tops, "packed_clause_tile", broken)
    with pytest.raises(RuntimeError, match="tile kernel failed"):
        tat.lookup("eval", 8, TINY, mode="measure",
                   cache=tmp_path / "c.json", device="cpu")
    assert not (tmp_path / "c.json").exists()


def test_measure_refuses_to_time_during_a_capture(tmp_path, monkeypatch):
    cache = tmp_path / "c.json"
    plan = tat.lookup("eval", 8, TINY, mode="measure", cache=cache,
                      device="cpu")
    monkeypatch.setattr(tat, "_capturing", lambda dev: True)
    # a resolved plan is a lookup, not a timing
    assert tat.lookup("eval", 8, TINY, mode="measure", cache=cache,
                      device="cpu") is plan
    with pytest.raises(RuntimeError, match="capture"):
        tat.lookup("eval", 64, TINY, mode="measure", cache=cache,
                   device="cpu")


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(ValueError, match="autotune"):
        tapi.compile(TileConfig(), device="cpu", autotune="fast")
    with pytest.raises(ValueError, match="autotune"):
        tops.select_path(8, shape=TINY, autotune="on", device="cpu")
    with pytest.raises(ValueError, match="autotune"):
        tops.select_ta_path(1, autotune="auto")
    with pytest.raises(ValueError, match="stage"):
        tat.lookup("flush", 8, TINY, device="cpu")


def test_default_cache_path_is_per_device_kind():
    path = tat.cache_path("cpu")
    assert path.name == "autotune_cpu.json"
    assert path.parent.name == "repro_torch"
    assert tat.cache_path("cpu", "/x/y.json").as_posix() == "/x/y.json"


# ---------------------------------------------------------------------------
# engines: the JAX engine's dispatch under REPRO_AUTOTUNE=off, and the
# three modes answering the same
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_kernel_engine():
    """The JAX engine on its Pallas kernels (interpret mode on the CPU)."""
    if "eng" not in _JAX:
        spec = _jspec("coalesced")
        _JAX["eng"] = japi.compile(japi.tile_for(spec, x=32, y=128, m=128,
                                                 n=4), backend="kernel")
    return _JAX["eng"]


@pytest.mark.parametrize("B", [1, 4, 8, 16, 32])
def test_off_dispatch_matches_jax(jax_off, B):
    """The fault this module pins: the port's ``path_per_stage`` differed
    from JAX's above the edge regime."""
    jeng = _jax_kernel_engine()
    teng = tapi.compile(TileConfig(**dataclasses.asdict(jeng.tile)),
                        device="cpu", autotune="off")
    jspec = _jspec("coalesced")
    tspec = _tspec(jspec)
    jtm = japi.TM(jspec, engine=jeng, seed=B)
    tprog, tprng = _bridge(jtm.program, jtm.prng)
    x, y = _data(jspec, B, seed=B + 1)
    jl = jeng.encode(jspec, jnp.asarray(x))
    tl = teng.encode(tspec, x)
    js, _ = jeng.infer(jtm.program, jl)
    ts, _ = teng.infer(tprog, tl)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jb = japi.stack([jtm.program, jtm.program], jeng)
    tb = tapi.stack([tprog, tprog], teng)
    np.testing.assert_array_equal(tb.infer(torch.stack([tl, tl]))[0].numpy(),
                                  np.asarray(jb.infer(jnp.stack([jl, jl]))[0]))
    jp, jr, jst = jeng.train_step(jtm.program, jtm.prng, jl,
                                  jspec.encode_labels(jnp.asarray(y)))
    tp, tr, tst = teng.train_step(tprog, tprng, tl, tspec.encode_labels(y))
    _assert_same(tp, tr, jp, jr, f"B={B}")
    want = jeng.cache_report()["path_per_stage"]
    got = teng.cache_report()["path_per_stage"]
    for stage in ("infer", "infer_bank", "train", "train_ta"):
        assert got[stage] == want[stage], (stage, got, want)
    assert got["infer"] == ("packed_vpu" if B <= 4 else "mxu")


def _engines(tmp_path):
    spec = _jspec("coalesced")
    tile = tapi.tile_for(_tspec(spec), x=32, y=128, m=128, n=4)
    return {mode: tapi.compile(tile, device="cpu", autotune=mode,
                               autotune_cache=tmp_path / "plans.json")
            for mode in tat.MODES}


def test_engines_under_off_seed_and_measure_answer_the_same(tmp_path):
    engines = _engines(tmp_path)
    spec = _tspec(_jspec("coalesced"))
    tm = tapi.TM(spec, engine=engines["off"], seed=3)
    x, y = _data(_jspec("coalesced"), 32, seed=4)
    lab = spec.encode_labels(y)
    paths = {}
    for B in (1, 8, 32):
        outs = {}
        for mode, eng in engines.items():
            lits = eng.encode(spec, x[:B])
            sums, cl = eng.infer(tm.program, lits)
            prog, prng, st = eng.train_step(tm.program, tm.prng, lits,
                                            lab[:B])
            outs[mode] = (sums, cl, prog, prng, st)
            paths[mode, B] = eng.cache_report()["path_per_stage"]["infer"]
        ref = outs["off"]
        for mode in ("seed", "measure"):
            got = outs[mode]
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                               ref[1])
            for a, b in zip(got[2].leaves(), ref[2].leaves()):
                assert torch.equal(a, b), mode
            for a, b in zip(got[3].leaves(), ref[3].leaves()):
                assert torch.equal(a, b), mode
            assert {k: int(v) for k, v in got[4].items()} == \
                {k: int(v) for k, v in ref[4].items()}
    assert paths["off", 8] == "mxu" and paths["seed", 1] == "packed_vpu"
    plans = json.loads((tmp_path / "plans.json").read_text())
    assert {k.split("/")[0] for k in plans} == {"eval", "train", "ta"}


def test_engine_resolves_plans_ahead_of_its_graphs(tmp_path):
    eng = _engines(tmp_path)["measure"]
    eng.resolve_plans(16, training=True)
    eng.resolve_plans(8, lanes=4)
    shape = (eng.L, eng.R, eng.H)
    plans = json.loads((tmp_path / "plans.json").read_text())
    assert set(plans) == {tat.plan_key("eval", 16, shape),
                          tat.plan_key("train", 16, shape),
                          tat.plan_key("ta", None, shape),
                          tat.plan_key("eval", 8, shape)}
    assert all(p["source"] == "measure" for p in plans.values())


# ---------------------------------------------------------------------------
# measure's launch-geometry sweep and planned_tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", (1, 8, 32, 256))
def test_sweep_gives_three_checked_geometries_a_packed_eval_leg(shape,
                                                                batch):
    """As JAX's ``EVAL_TILES``: three geometries for each packed eval leg
    (the wrapper's own first), one for the dense leg; every candidate's
    launches pass the launch checker."""
    from repro_torch.analysis.kernel_check import check_plan
    for path in ("packed_vpu", "mxu_popcount", "mxu"):
        geoms = tat.geometries("eval", path, batch, shape)
        assert len(geoms) == (1 if path == "mxu" else 3)
        assert len({tat.geometry_key(g) for g in geoms}) == len(geoms)
        own = tat.tiles(path, batch, shape)
        assert geoms[0] == _override(own, path)
        assert tat.tiles(path, batch, shape, geometry=geoms[0]) == own
        for g in geoms:
            assert set(g) == set(GEOM_KEYS[path])
            for lp in tat.launch_plans("eval", path, batch, shape, g):
                assert check_plan(lp) == [], (path, g, lp.desc)


def test_sweep_evens_out_fused_tiles_at_r4224_only():
    """The fused leg adds cluster sizes where the wrapper's leaves a block
    two of its 17 clause tiles (R = 4224); at R = 2048 (8 tiles, 8
    blocks) it keeps its own.  The other train and TA legs keep theirs."""
    from repro_torch.analysis.kernel_check import balance, check_plan
    roster, train = SHAPES[2], SHAPES[1]
    assert tat.geometries("train", "fused", 32, roster) == [
        {"cluster": 16}, {"cluster": 9}, {"cluster": 6}]
    assert tat.geometries("train", "fused", 32, train) == [{"cluster": 8}]
    for g in tat.geometries("train", "fused", 32, roster):
        (lp,) = tat.launch_plans("train", "fused", 32, roster, g)
        assert check_plan(lp) == []
        # each block's share of the 17 tiles: max 2, 2, 3
        assert max(lp.work) == {16: 2, 9: 2, 6: 3}[g["cluster"]]
    (own,) = tat.launch_plans("train", "fused", 32, roster, {"cluster": 16})
    (nine,) = tat.launch_plans("train", "fused", 32, roster, {"cluster": 9})
    assert balance(own) is not None and balance(nine) is None
    for path in ("packed_vpu", "mxu"):
        assert len(tat.geometries("train", path, 32, roster)) == 1
    for path in ("dense", "compact"):
        assert len(tat.geometries("ta", path, None, roster)) == 1


def test_candidates_carry_path_and_geometry():
    cands = tat.candidates("eval", 8, TINY, "cpu")
    assert [(p, tat.geometry_key(g)) for p, g, _ in cands] == [
        (p, tat.geometry_key(g)) for p in ("packed_vpu", "mxu_popcount",
                                           "mxu")
        for g in tat.geometries("eval", p, 8, TINY)]
    outs = [fn() for _, _, fn in cands]
    for o in outs[1:]:                        # every geometry, one answer
        assert torch.equal(o.reshape(outs[0].shape), outs[0])


def test_a_refused_geometry_is_not_timed_and_the_plan_says_why(
        tmp_path, monkeypatch):
    real = tat.geometries

    def with_bad(stage, path, batch, shape, sms=0):
        out = real(stage, path, batch, shape, sms)
        if path == "mxu_popcount":
            out = out + [{"warps": 64}]       # 2048 threads a block
        return out
    monkeypatch.setattr(tat, "geometries", with_bad)
    plan = tat.lookup("eval", 8, TINY, mode="measure",
                      cache=tmp_path / "c.json", device="cpu")
    assert "warps=64" in plan["rejected"]["mxu_popcount"]
    assert "threads" in plan["rejected"]["mxu_popcount"]["warps=64"]
    assert "warps=64" not in plan["candidates_us"]["mxu_popcount"]
    assert len(plan["candidates_us"]["mxu_popcount"]) == 3


def test_a_swept_geometry_sets_tiles_but_not_the_path(tmp_path,
                                                      monkeypatch):
    """The engine launches each wrapper's own geometry, so the path is
    the one fastest there: a tile geometry faster than every edge one
    does not flip the plan to the tile kernel; the edge kernel's fastest
    geometry becomes ``tiles`` and its own geometry's time ``us``."""
    pv = tat.geometries("eval", "packed_vpu", 8, TINY)
    mp = tat.geometries("eval", "mxu_popcount", 8, TINY)
    us = {("packed_vpu", 0): 10.0, ("packed_vpu", 1): 8.0,
          ("packed_vpu", 2): 12.0, ("mxu_popcount", 0): 20.0,
          ("mxu_popcount", 1): 5.0, ("mxu_popcount", 2): 25.0,
          ("mxu", 0): 30.0}
    geoms = {"packed_vpu": pv, "mxu_popcount": mp, "mxu": [{}]}
    monkeypatch.setattr(tat, "candidates", lambda *a, **k: [
        (p, g, (lambda p=p, i=i: (p, i)))
        for p in geoms for i, g in enumerate(geoms[p])])
    monkeypatch.setattr(tat, "_time_us", lambda fn, dev: us[fn()])
    plan = tat.lookup("eval", 8, TINY, mode="measure",
                      cache=tmp_path / "c.json", device="cpu")
    assert plan["path"] == "packed_vpu" and plan["us"] == 10.0
    assert plan["tiles"] == tat.tiles("packed_vpu", 8, TINY, geometry=pv[1])
    assert plan["tiles"] != tat.tiles("packed_vpu", 8, TINY)
    assert plan["candidates_us"]["mxu_popcount"][
        tat.geometry_key(mp[1])] == 5.0
    assert plan["candidates_us"]["mxu"] == {"own": 30.0}


@pytest.mark.parametrize("key", sorted(SEED_BEFORE_SWEEP, key=str))
def test_seed_plans_and_tiles_are_unchanged(key):
    stage, batch, shape = key
    path, tiles = SEED_BEFORE_SWEEP[key]
    plan = tat.seed_plan(stage, batch, shape)
    assert plan == {"path": path, "tiles": tiles, "source": "seed"}
    assert tat.planned_tiles(stage, batch, shape, device="cpu") == tiles
    assert tat.lookup(stage, batch, shape, mode="off", device="cpu") is None


def test_planned_tiles_returns_the_plans_and_none_where_jax_does(
        tmp_path, jax_off, monkeypatch):
    # off: no plan in either package
    for stage in tat.STAGES:
        assert jat.planned_tiles(stage, 8, TINY) is None
        assert tat.planned_tiles(stage, 8, TINY, mode="off",
                                 device="cpu") is None
    # seed: the TA stage has no plan in either package
    monkeypatch.setenv("REPRO_AUTOTUNE", "seed")
    monkeypatch.setattr(jat, "_disk_plans", lambda: {})
    assert jat.planned_tiles("ta", None, TINY) is None
    assert tat.planned_tiles("ta", None, TINY, device="cpu") is None
    assert jat.planned_tiles("eval", 8, TINY) is not None
    assert tat.planned_tiles("eval", 8, TINY, device="cpu") == \
        tat.seed_plan("eval", 8, TINY)["tiles"]
    # measure: the fastest candidate's geometry
    cache = tmp_path / "c.json"
    for stage, b in (("eval", 8), ("train", 8), ("ta", None)):
        plan = tat.lookup(stage, b, TINY, mode="measure", cache=cache,
                          device="cpu")
        got = tat.planned_tiles(stage, b, TINY, mode="measure", cache=cache,
                                device="cpu")
        assert got == plan["tiles"] == tat.tiles(
            plan["path"], b, TINY, geometry=_override(plan["tiles"],
                                                      plan["path"]))
