"""The port's substrate against the JAX package, on the CPU: the datasets,
the data pipeline (``Source``, ``HostShardIterator``, ``Prefetcher``),
AdamW in its three moment dtypes, ``quantize_tree``/``dequantize_tree``,
the ZeRO-1 spec helpers on a 2-axis mesh description, the tree helper's
leaf order, and the package surfaces (every public name of each JAX
package in its ``repro_torch`` counterpart; each package imports alone
in a fresh interpreter without JAX).

Integer outputs are held for exact equality, float outputs at
``rtol=1e-6``.  ``compressed_psum``/``exact_int8_psum`` run on the 4
gloo ranks of ``tests/test_torch_distributed.py``.
"""
import collections
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import tree as tree_lib
from repro_torch.data import (FMNIST_LIKE, KMNIST_LIKE, HostShardIterator,
                              Prefetcher, Source, make_bool_dataset,
                              make_lm_tokens)
from repro_torch.optim import adam
from repro_torch.runtime import dequantize_tree, quantize_tree

PACKAGES = ("core", "kernels", "launch", "data", "runtime", "optim")
# documented divergences: JAX's three environment readers have no port
# counterpart; the launch layer's card model is H100 where JAX's is V5E
ABSENT = {"kernels": {"resolve_interpret", "resolve_skip",
                      "resolve_ta_prng"}}
RENAMED = {"launch": {"V5E": "H100"}}
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


# ---------------------------------------------------------------------------
# package surfaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_public_name_has_a_port_counterpart(pkg):
    import importlib
    jmod = importlib.import_module(f"repro.{pkg}")
    tmod = importlib.import_module(f"repro_torch.{pkg}")
    want = set(jmod.__all__) - ABSENT.get(pkg, set())
    want = {RENAMED.get(pkg, {}).get(n, n) for n in want}
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert not missing, missing
    assert want <= set(tmod.__all__), sorted(want - set(tmod.__all__))
    for n in ABSENT.get(pkg, ()):
        assert not hasattr(tmod, n), n


def test_each_package_imports_alone_without_jax():
    """``import repro_torch.<pkg>`` in a fresh interpreter each (run side
    by side): no import cycle, and neither ``jax`` nor ``repro`` loads."""
    code = ("import sys, importlib; importlib.import_module(sys.argv[1]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = {m: subprocess.Popen([sys.executable, "-c", code, m], env=env,
                                 stderr=subprocess.PIPE, text=True)
             for m in ["repro_torch"] + [f"repro_torch.{p}" for p in
                                          PACKAGES]}
    for p, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (p, err)


def test_tree_leaf_order_equals_jax():
    import jax
    Pair = collections.namedtuple("Pair", "first second")
    t = {"z": [1, None, (2, 3)], "a": Pair(4, {"y": 5, "x": 6}), "m": 7,
         "e": {}}
    leaves, td = tree_lib.flatten(t)
    assert leaves == jax.tree.leaves(t)
    assert td.num_leaves == len(leaves)
    back = tree_lib.unflatten(td, leaves)
    assert back == t and type(back["a"]) is Pair
    doubled = tree_lib.map(lambda a, b: a + b, t, t)
    assert doubled == jax.tree.map(lambda a, b: a + b, t, t)
    with pytest.raises(ValueError):
        tree_lib.flatten_up_to(td, {"z": 1})


# ---------------------------------------------------------------------------
# datasets and pipeline
# ---------------------------------------------------------------------------

def test_datasets_equal_jax():
    import dataclasses
    from repro.data import datasets as jd
    for t, j in ((FMNIST_LIKE, jd.FMNIST_LIKE), (KMNIST_LIKE, jd.KMNIST_LIKE)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for seed in (0, 3):
            tx, ty = make_bool_dataset(t, 24, seed=seed)
            jx, jy = jd.make_bool_dataset(j, 24, seed=seed)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    for args in ((1000, 3, 17, 0), (40, 2, 9, 5)):
        got, want = make_lm_tokens(*args), jd.make_lm_tokens(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _make(rng, size):
    x = rng.integers(0, 2, (size, 5)).astype(np.int8)
    return x, rng.integers(0, 3, size).astype(np.int32)


def test_host_shard_iterator_equals_jax():
    from repro.data import HostShardIterator as JIt, Source as JSource
    for pc in (1, 2, 4):
        for pi in range(pc):
            t = HostShardIterator(Source(20, _make, seed=3), 8, pi, pc)
            j = JIt(JSource(20, _make, seed=3), 8, pi, pc)
            for k in range(6):             # crosses two epoch boundaries
                (tx, ty), (jx, jy) = next(t), next(j)
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)
                assert t.state() == j.state()
    # the state resumes on the exact next batch
    t = HostShardIterator(Source(20, _make, seed=3), 8, 1, 2)
    for _ in range(3):
        next(t)
    st, want = t.state(), next(t)
    r = HostShardIterator(Source(20, _make, seed=3), 8, 1, 2)
    r.restore(st)
    np.testing.assert_array_equal(next(r)[0], want[0])


def test_host_shard_iterator_defaults_and_errors():
    """Without a process group the defaults are rank 0 of 1 (JAX's
    ``process_index``/``process_count`` on one host)."""
    import jax
    t = HostShardIterator(Source(20, _make), 8)
    assert (t.pi, t.pc, t.local) == (jax.process_index(),
                                     jax.process_count(), 8)
    with pytest.raises(ValueError):
        HostShardIterator(Source(20, _make), 9, 0, 2)


def test_prefetcher_equals_jax():
    from repro.data import Prefetcher as JPre
    items = [np.arange(i, i + 3) for i in range(7)]
    t = Prefetcher(iter(items), depth=2, transform=lambda a: a * 2)
    j = JPre(iter(items), depth=2, transform=lambda a: a * 2)
    for _ in items:
        np.testing.assert_array_equal(next(t), next(j))
    t.close()
    j.close()

    def boom():
        yield np.zeros(1)
        raise RuntimeError("source failed")
    p = Prefetcher(boom())
    np.testing.assert_array_equal(next(p), np.zeros(1))
    with pytest.raises(RuntimeError, match="source failed"):
        next(p)


# ---------------------------------------------------------------------------
# AdamW, quantised trees and specs
# ---------------------------------------------------------------------------

def _params(rng):
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32),
            "layers": [{"k": rng.standard_normal((3, 4)).astype(np.float32)},
                       {"k": rng.standard_normal((2, 5)).astype(np.float32)}],
            "t": (rng.standard_normal(3).astype(np.float32),)}


def _to_jax(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_lib.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, what):
    import jax
    gl = [x.to(torch.float32).numpy() for x in tree_lib.leaves(got)]
    wl = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=what)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_equals_jax(state_dtype):
    """5 steps from warmup into the decay (warmup 2, total 6), clipping
    active, on a dict/list/tuple tree: params, moments, scales, step and
    metrics."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adam as jadam
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
              state_dtype=state_dtype)
    jcfg, tcfg = jadam.AdamWConfig(**kw), adam.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    params = _params(rng)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jadam.init(jcfg, jp), adam.init(tcfg, tp)
    for k in range(5):
        g = tree_lib.map(lambda a: (rng.standard_normal(a.shape) * 0.7
                                    ).astype(np.float32), params)
        jp, js, jm = jadam.apply(jcfg, jp, _to_jax(g), js)
        tp, ts, tm = adam.apply(tcfg, tp, _to_torch(g), ts)
        _close(tp, jp, f"params step {k}")
        for f in ("m", "v"):
            tl = tree_lib.leaves(getattr(ts, f))
            jl = jax.tree.leaves(getattr(js, f))
            for a, b in zip(tl, jl):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), f
                a = a.to(torch.float32).numpy()
                b = np.asarray(b, np.float32)
                if state_dtype == "int8":
                    np.testing.assert_array_equal(a, b, err_msg=f)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
        for f in ("m_scale", "v_scale"):
            _close(getattr(ts, f), getattr(js, f), f)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
    # the numpy form round-trips, and JAX's state crosses in
    back = convert.adam_state_from_numpy(convert.adam_state_to_numpy(ts),
                                         state_dtype, device="cpu")
    for a, b in zip(tree_lib.leaves(back), tree_lib.leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    crossed = convert.adam_state_from_numpy(
        jax.tree.map(np.asarray, js), state_dtype, device="cpu")
    _close(crossed.m, js.m, "crossed m")
    np.testing.assert_allclose(
        float(jadam.global_norm(_to_jax(params))),
        float(adam.global_norm(_to_torch(params))), rtol=1e-6)
    for s in (0, 1, 2, 4, 6, 9):
        np.testing.assert_allclose(
            float(adam.schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(jadam.schedule(jcfg, jnp.int32(s))), rtol=1e-6)


def test_adamw_keeps_bfloat16_params():
    p = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    cfg = adam.AdamWConfig(state_dtype="bfloat16")
    new, st, _ = adam.apply(cfg, p, p, adam.init(cfg, p))
    assert new["w"].dtype == torch.bfloat16 and st.m["w"].dtype == \
        torch.bfloat16


def test_quantize_tree_equals_jax():
    """Per-leaf int8 codes exact, scales and dequantised values within
    1e-6; a bfloat16 leaf is divided in float32 as JAX promotes it."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import (dequantize_tree as jdeq,
                               quantize_tree as jq)
    rng = np.random.default_rng(1)
    params = _params(rng)
    # a tuple container would read as a (codes, scale) leaf in both
    # packages' dequantize_tree: only dicts and lists here
    del params["t"]
    params["z"] = np.zeros(4, np.float32)            # the scale floor
    bf = rng.standard_normal(7).astype(np.float32)
    for bits in (8, 4):
        jt, tt = jq(_to_jax(params), bits), quantize_tree(_to_torch(params),
                                                          bits)
        tl = tree_lib.leaves(tt, is_leaf=lambda t: isinstance(t, tuple))
        jl = jax.tree.leaves(jt, is_leaf=lambda t: isinstance(t, tuple))
        for (tq, ts), (jqv, jsv) in zip(tl, jl):
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
            np.testing.assert_allclose(float(ts), float(jsv), rtol=1e-6)
        _close(dequantize_tree(tt), jdeq(jt), "dequantised")
    (tq, ts), = tree_lib.leaves(quantize_tree(
        [torch.from_numpy(bf).to(torch.bfloat16)]),
        is_leaf=lambda t: isinstance(t, tuple))
    (jqv, jsv), = jax.tree.leaves(jq([jnp.asarray(bf, jnp.bfloat16)]),
                                  is_leaf=lambda t: isinstance(t, tuple))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
    assert ts.dtype == torch.float32 and np.asarray(jsv).dtype == np.float32


def test_zero_and_state_pspecs_equal_jax():
    """On a (data=4, model=2) mesh description: each moment spec equals
    ``tuple(PartitionSpec)`` of JAX's, the step and scales ``()``."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.optim import adam as jadam
    shapes = {"emb": (1024, 64), "w": (64, 128), "b": (128,), "s": (),
              "odd": (6, 3), "used": (8, 8),
              "layers": [{"q": (64, 64)}, {"q": (2, 6)}]}
    jspecs = {"emb": P(None, "model"), "w": P("model"), "b": P(), "s": P(),
              "odd": P(), "used": P("data"),
              "layers": [{"q": P(None, ("model",))}, {"q": P()}]}
    tspecs = jax.tree.map(tuple, jspecs,
                          is_leaf=lambda x: isinstance(x, P))
    jshapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                           shapes, is_leaf=lambda x: isinstance(x, tuple))
    tshapes = tree_lib.map(lambda s: torch.empty(s, device="meta"), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.empty((4, 2)))
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(4, 2))
    want = jax.tree.leaves(jadam.zero_pspecs(jspecs, jmesh, jshapes),
                           is_leaf=lambda x: isinstance(x, P))
    _, td = tree_lib.flatten(tshapes)
    got = tree_lib.flatten_up_to(td, adam.zero_pspecs(tspecs, tmesh,
                                                      tshapes))
    assert got == [tuple(w) for w in want]
    assert "data" in got[0] + got[1]
    cfg = adam.AdamWConfig()
    jst = jadam.state_pspecs(jadam.AdamWConfig(), jspecs, jmesh, jshapes)
    tst = adam.state_pspecs(cfg, tspecs, tmesh, tshapes)
    assert tst.step == tuple(jst.step) == ()
    for f in ("m", "v", "m_scale", "v_scale"):
        assert tree_lib.flatten_up_to(td, getattr(tst, f)) == [
            tuple(w) for w in jax.tree.leaves(
                getattr(jst, f), is_leaf=lambda x: isinstance(x, P))], f
    # a mesh without a data axis counts it as size 1, as JAX's does
    jone = types.SimpleNamespace(axis_names=("model",), devices=np.empty(2))
    tone = types.SimpleNamespace(mesh_dim_names=("model",), shape=(2,))
    assert tree_lib.flatten_up_to(td, adam.zero_pspecs(
        tspecs, tone, tshapes)) == [tuple(w) for w in jax.tree.leaves(
            jadam.zero_pspecs(jspecs, jone, jshapes),
            is_leaf=lambda x: isinstance(x, P))]
