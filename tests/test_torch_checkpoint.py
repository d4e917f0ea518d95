"""Checkpoints and ``TM.save``/``TM.load`` of the port (CPU, exact).

The port's checkpoint files are the JAX package's: the same leaf order
as ``jax.tree.flatten``, the same dtypes and ``meta.json`` keys.  A TM
saved by either package loads in the other, and both then train on
identically.  The publish is atomic, the retention sweep spares pinned
and freshly resolved steps, and ``latest_step`` never picks a
half-written one.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import checkpoint as jckpt
from repro_torch import api as tapi, checkpoint as tckpt
from repro_torch.checkpoint import checkpoint as tck
from repro_torch.core.types import TileConfig
from test_torch_train import _assert_same, _bridge, _data, _jspec, _tspec


@pytest.fixture(scope="module")
def jeng():
    """One JAX engine (ref backend) that fits every kind used here."""
    specs = [_jspec(k) for k in ("coalesced", "regression", "head")]
    specs.append(japi.TMSpec.coalesced(features=21, classes=4, clauses=48,
                                       T=16, ta_bits=10))
    return japi.compile(japi.tile_for(*specs, x=32, y=128, m=128, n=4),
                        backend="ref")


def _tree_pair(jeng, backend):
    jtm = japi.TM(_jspec("coalesced", backend), engine=jeng, seed=3)
    tprog, tprng = _bridge(jtm.program, jtm.prng)
    jtree = {"ta": jtm.program.ta, "weights": jtm.program.weights,
             "prng": jtm.prng}
    ttree = {"ta": tprog.ta, "weights": tprog.weights, "prng": tprng}
    return jtree, ttree


# ---------------------------------------------------------------------------
# the file format: leaf order and dtypes of jax.tree.flatten
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lfsr", "counter"])
def test_flatten_order_and_dtypes_match_jax(jeng, backend):
    jtree, ttree = _tree_pair(jeng, backend)
    jleaves, _ = jax.tree.flatten(jtree)
    tleaves, treedef = tck._flatten(ttree)
    assert len(tleaves) == len(jleaves) == (5 if backend == "lfsr" else 3)
    for (t, u32), j in zip(tleaves, jleaves):
        got, want = tck._to_numpy(t, u32), np.asarray(j)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert treedef.startswith("{'prng': PRNG[")


@pytest.mark.parametrize("backend", ["lfsr", "counter"])
def test_files_cross_both_ways(jeng, tmp_path, backend):
    """A tree saved by either package restores in the other with the same
    values, and the meta files carry the same keys and dtypes."""
    jtree, ttree = _tree_pair(jeng, backend)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jdir, 4, jtree, extra={"k": 1})
    tckpt.save(tdir, 4, ttree, extra={"k": 1})
    metas = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "step_00000004", "meta.json")) as f:
            metas.append(json.load(f))
        assert sorted(os.listdir(os.path.join(d, "step_00000004"))) == [
            "meta.json", "shard-0-of-1.npz"]
    assert set(metas[0]) == set(metas[1])
    for k in ("step", "n_leaves", "process_count", "dtypes", "extra"):
        assert metas[0][k] == metas[1][k], k
    got, extra = tckpt.restore(jdir, 4, ttree)
    assert extra == {"k": 1}
    back, _ = jckpt.restore(tdir, 4, jtree)
    for (t, u32), (g, _), j in zip(tck._flatten(ttree)[0],
                                   tck._flatten(got)[0],
                                   jax.tree.flatten(back)[0]):
        assert g.dtype == t.dtype and g.device == t.device
        assert torch.equal(g, t)
        np.testing.assert_array_equal(tck._to_numpy(t, u32), np.asarray(j))


# ---------------------------------------------------------------------------
# atomic publish, retention, latest_step
# ---------------------------------------------------------------------------

def _tree(v):
    return {"w": torch.full((3,), v, dtype=torch.int32)}


def test_publish_is_atomic_and_latest_skips_tmp_dirs(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    final = tckpt.save(d, 3, _tree(3))
    assert os.path.basename(final) == "step_00000003"
    assert not [e for e in os.listdir(d) if ".tmp." in e]
    # a writer of step 9 still busy (this pid) and one that died mid-save
    # before its meta.json: neither is a step to resume from
    live = os.path.join(d, f"step_00000009.tmp.{os.getpid()}")
    os.makedirs(live)
    with open(os.path.join(live, "meta.json"), "w") as f:
        f.write("{}")
    os.makedirs(os.path.join(d, "step_00000011"))       # no meta.json
    assert tckpt.latest_step(d) == 3
    step, tree, _ = tckpt.restore_latest(d, _tree(0))
    assert step == 3 and torch.equal(tree["w"], _tree(3)["w"])
    # the first writer of a step wins; the second's tmp dir is dropped
    tckpt.save(d, 3, _tree(7))
    assert torch.equal(tckpt.restore(d, 3, _tree(0))[0]["w"], _tree(3)["w"])
    assert os.path.isdir(live)                          # a live writer's


def test_gc_spares_pinned_and_recently_resolved_steps(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2):
        tckpt.save(d, s, _tree(s), keep=0)
    assert tckpt.latest_step(d) == 2                    # resolved just now
    tck._pin(d, 1, +1)                                  # a restore in flight
    dead = os.path.join(d, "step_00000004.tmp.999999999")
    os.makedirs(dead)                                   # a writer that died
    try:
        for s in (3, 4, 5):
            tckpt.save(d, s, _tree(s), keep=1)
    finally:
        tck._pin(d, 1, -1)
    left = sorted(e for e in os.listdir(d))
    assert left == ["step_00000001", "step_00000002", "step_00000005"]
    tckpt.save(d, 6, _tree(6), keep=1)                  # unpinned: goes
    assert "step_00000001" not in os.listdir(d)
    assert "step_00000002" in os.listdir(d)             # in its grace window


def test_restore_checks_structure(tmp_path):
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, _tree(1))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, 1, {"w": torch.zeros(3), "v": torch.zeros(1)})
    with pytest.raises(ValueError, match="saved"):
        tckpt.restore(d, 1, {"w": torch.zeros(4, dtype=torch.int32)})


# ---------------------------------------------------------------------------
# TM.save / TM.load across the packages
# ---------------------------------------------------------------------------

CASES = [("coalesced", "lfsr", 8), ("regression", "counter", 8),
         ("head", "lfsr", 8), ("coalesced", "counter", 10)]


def _case_spec(kind, backend, ta_bits):
    if ta_bits != 8:
        return japi.TMSpec.coalesced(features=21, classes=4, clauses=48,
                                     T=16, ta_bits=ta_bits,
                                     prng_backend=backend)
    return _jspec(kind, backend)


def _steps(tm, x, y, lo, hi, b=8):
    return [{k: int(v) for k, v in tm.partial_fit(x[s:s + b],
                                                   y[s:s + b]).items()}
            for s in range(lo, hi, b)]


@pytest.mark.parametrize("kind,backend,ta_bits", CASES)
def test_jax_saved_tm_loads_in_the_port(jeng, tmp_path, kind, backend,
                                        ta_bits):
    jspec = _case_spec(kind, backend, ta_bits)
    x, y = _data(jspec, 32, 11)
    jtm = japi.TM(jspec, engine=jeng, seed=6)
    _steps(jtm, x, y, 0, 16)
    d = str(tmp_path / "tm")
    jtm.save(d)
    with open(os.path.join(d, "step_00000002", "meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    ta_dtype = "uint8" if ta_bits <= 8 else "int32"
    assert dtypes[-2:] == [ta_dtype, "int32"]
    assert set(dtypes[:-2]) == {"uint32"}
    ttm = tapi.TM.load(d, device="cpu")
    assert ttm.steps == 2 and ttm.engine.device.type == "cpu"
    assert ttm.program.ta.dtype == (torch.uint8 if ta_bits <= 8
                                    else torch.int32)
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    assert _steps(ttm, x, y, 16, 32) == _steps(jtm, x, y, 16, 32)
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    np.testing.assert_array_equal(ttm.predict(x).numpy(),
                                  np.asarray(jtm.predict(x)))


@pytest.mark.parametrize("kind,backend,ta_bits", CASES)
def test_port_saved_tm_loads_in_jax(jeng, tmp_path, kind, backend, ta_bits):
    jspec = _case_spec(kind, backend, ta_bits)
    x, y = _data(jspec, 32, 12)
    start = japi.TM(jspec, engine=jeng, seed=7)
    ttm = tapi.TM(_tspec(jspec), device="cpu",
                  tile=TileConfig(**dataclasses.asdict(jeng.tile)))
    ttm.program, ttm.prng = _bridge(start.program, start.prng)
    _steps(ttm, x, y, 0, 16)
    d = str(tmp_path / "tm")
    path = ttm.save(d)
    assert path.endswith("step_00000002")
    with open(os.path.join(path, "meta.json")) as f:
        extra = json.load(f)["extra"]
    assert extra["backend"] == "auto" and extra["steps"] == 2
    jtm = japi.TM.load(d)                       # its own engine
    assert jtm.steps == 2
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)
    jtm = japi.TM.load(d, engine=jeng)          # the test's, to train on
    assert _steps(ttm, x, y, 16, 32) == _steps(jtm, x, y, 16, 32)
    _assert_same(ttm.program, ttm.prng, jtm.program, jtm.prng, kind)


def test_load_runs_on_the_card_unless_asked(jeng, tmp_path):
    jtm = japi.TM(_jspec("coalesced"), engine=jeng, seed=1)
    d = str(tmp_path / "tm")
    jtm.save(d)
    if torch.cuda.is_available():
        assert tapi.TM.load(d).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.TM.load(d)
    with pytest.raises(FileNotFoundError):
        tapi.TM.load(str(tmp_path / "none"), device="cpu")
