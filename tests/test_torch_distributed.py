"""The port's legacy training core and distributed training
(core/types TMState, core/clause, core/feedback, core/distributed) against
the JAX package, on the CPU.

Unit parity runs in the test process.  ``dp_train_step`` and
``pod_train_step`` run on 4 gloo ranks of one ``torch.multiprocessing``
spawn (``file://`` init under a temporary directory); ``dp_train_step``
is held against the JAX single-device replay of ``tests/
test_distributed.py`` (each shard's stream and deltas, summed, applied),
``pod_train_step`` on a (data=2, model=2) mesh against the JAX
``pod_train_step`` on the same mesh of 4 host devices in one subprocess.
The same ranks run ``runtime.compression``'s ``compressed_psum`` and
``exact_int8_psum``, held against JAX's under ``jax.vmap`` over 4 shards.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (TMConfig, clause, feedback, init_state,
                              threefry, to_literals)
from repro_torch.core.distributed import dp_train_step, pod_train_step
from repro_torch.core.prng import indexed_bits
from repro_torch.launch.mesh import make_host_mesh
from test_torch_pod import init_gloo, spawn_ranks

WORLD = 4
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BACKENDS = ("lfsr", "counter", "threefry")
# (int8_wire, compact_frac): dense, int8 wire, roomy and overflowing
# wire compaction
DP_VARIANTS = {"dense": (False, 0.0), "int8": (True, 0.0),
               "compact": (True, 0.5), "overflow": (False, 0.02)}
DP_CFG = dict(features=24, clauses=64, classes=3, T=8, s=3.0)
POD_CFG = dict(features=24, clauses=32, classes=4, T=8, s=3.0)
# (compact_k, compact_frac): a rank holds 16 clause rows, so K = 16 holds
# every selection (the compaction is exact)
POD_VARIANTS = {"dense": (0, 0.0), "compact_k": (16, 0.0),
                "compact_frac": (0, 0.5)}


def _batch(n, f, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) < 0.4).astype(np.int8)
    return x, rng.integers(0, classes, n).astype(np.int32)


def _state_np(state):
    return convert.state_to_numpy(state)


# ---------------------------------------------------------------------------
# the ranks (no JAX: the spawned processes import this module)
# ---------------------------------------------------------------------------

def _dp_cases(out):
    mesh = make_host_mesh(1, device_type="cpu")          # (4, 1)
    for tm_type, backend in [("coalesced", b) for b in BACKENDS] + [
            ("vanilla", "counter")]:
        cfg = TMConfig(tm_type=tm_type, prng_backend=backend, **DP_CFG)
        state = init_state(cfg, threefry.key(0, "cpu"), device="cpu")
        x, y = _batch(8, cfg.features, cfg.classes)
        for name, (int8, frac) in DP_VARIANTS.items():
            new, st = dp_train_step(cfg, state, to_literals(x),
                                    torch.from_numpy(y), mesh, seed=5,
                                    chunk=2, int8_wire=int8,
                                    compact_frac=frac)
            out["dp"][(tm_type, backend, name)] = (
                _state_np(new), [int(v) for v in (
                    st.selected_clauses, st.active_groups, st.total_groups,
                    st.correct)])


def _pod_cases(out):
    mesh = make_host_mesh(2, device_type="cpu")          # (2, 2)
    for backend in ("counter", "lfsr"):
        cfg = TMConfig(prng_backend=backend, **POD_CFG)
        state = init_state(cfg, threefry.key(0, "cpu"), device="cpu")
        x, y = _batch(16, cfg.features, cfg.classes)
        for name, (k, frac) in POD_VARIANTS.items():
            if backend != "counter" and name != "dense":
                continue
            new, st = pod_train_step(cfg, state, to_literals(x),
                                     torch.from_numpy(y), mesh, seed=3,
                                     compact_k=k, compact_frac=frac)
            out["pod"][(backend, name)] = (
                _state_np(new), {k_: int(v) for k_, v in st.items()})


def _compression_inputs(rank):
    """Rank ``rank``'s inputs of the compressed reductions: a float
    tensor, an error-feedback residual and int deltas in [-30, 30]."""
    rng = np.random.default_rng(100 + rank)
    x = (rng.standard_normal((5, 3)) * (rank + 1)).astype(np.float32)
    err = (rng.standard_normal((5, 3)) * 0.01).astype(np.float32)
    return x, err, rng.integers(-30, 31, (4, 6)).astype(np.int32)


def _compression_cases(out):
    """compressed_psum with and without error feedback, over the data
    axis and over (data, model) in turn, and exact_int8_psum."""
    from repro_torch.runtime import compressed_psum, exact_int8_psum
    mesh = make_host_mesh(1, device_type="cpu")          # (4, 1)
    data, model = mesh.get_group("data"), mesh.get_group("model")
    x, err, d = (torch.from_numpy(a) for a in _compression_inputs(
        torch.distributed.get_rank()))
    for name, groups, e in (("plain", data, None), ("error", data, err),
                            ("axes", (data, model), err)):
        total, resid = compressed_psum(x, groups, e)
        out["compress"][name] = (total.numpy(), resid.numpy(),
                                 str(total.dtype))
    got = exact_int8_psum(d, data)
    out["compress"]["int8"] = (got.numpy(), str(got.dtype))


def _rank_main(rank, world, init_file, out_dir):
    import torch.distributed as dist
    init_gloo(rank, world, init_file)
    out = {"dp": {}, "pod": {}, "compress": {}}
    _dp_cases(out)
    _pod_cases(out)
    _compression_cases(out)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(_rank_main, tmp_path_factory.mktemp("dist"))


def _jcfg(**kw):
    from repro.core import TMConfig as JConfig
    return JConfig(**kw)


def _assert_state(got, ta, w, what):
    np.testing.assert_array_equal(got["ta"], np.asarray(ta),
                                  err_msg=f"{what} ta")
    if w is None:
        assert got["weights"] is None, what
    else:
        np.testing.assert_array_equal(got["weights"], np.asarray(w),
                                      err_msg=f"{what} weights")


# ---------------------------------------------------------------------------
# (f) dp_train_step equals the JAX single-device replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [("coalesced", b) for b in BACKENDS]
                         + [("vanilla", "counter")])
def test_dp_train_step_equals_jax_replay(ranks, case):
    """Dense, int8 wire and wire-compacted (fitting and overflowing)
    steps on 4 ranks equal the JAX replay: ``_shard_prng(cfg, 5, i)`` per
    shard, ``batched_deltas`` of its datapoints, summed, applied."""
    import jax
    import jax.numpy as jnp
    from repro.core import init_state as jinit, to_literals as jlits
    from repro.core import feedback as jfb
    from repro.core.distributed import _shard_prng
    tm_type, backend = case
    cfg = _jcfg(tm_type=tm_type, prng_backend=backend, **DP_CFG)
    state = jinit(cfg, jax.random.PRNGKey(0))
    x, y = _batch(8, cfg.features, cfg.classes)
    lits, y = jlits(jnp.asarray(x)), jnp.asarray(y)
    acc = None
    for i in range(WORLD):
        prng = _shard_prng(cfg, 5, jnp.uint32(i))
        _, d_ta, d_w, d_sel, corr = jfb.batched_deltas(
            cfg, state, prng, lits[i * 2:(i + 1) * 2], y[i * 2:(i + 1) * 2],
            2)
        parts = (d_ta, d_w, d_sel, corr)
        acc = parts if acc is None else tuple(
            None if a is None else a + b for a, b in zip(acc, parts))
    want, st = jfb.apply_deltas(cfg, state, *acc)
    stats = [int(v) for v in (st.selected_clauses, st.active_groups,
                              st.total_groups, st.correct)]
    for r, out in enumerate(ranks):
        for name in DP_VARIANTS:
            got, got_stats = out["dp"][(tm_type, backend, name)]
            _assert_state(got, want.ta, want.weights, f"rank {r} {name}")
            assert got_stats == stats, (r, name)


# ---------------------------------------------------------------------------
# (g) pod_train_step equals JAX's on the same (data=2, model=2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pod(tmp_path_factory):
    """JAX's pod_train_step on 4 forced host devices, in a subprocess."""
    out = tmp_path_factory.mktemp("jpod") / "jpod.pkl"
    code = textwrap.dedent(f"""
        import pickle
        import jax, jax.numpy as jnp, numpy as np
        from repro.core import TMConfig, init_state, to_literals
        from repro.core.distributed import pod_train_step
        res = {{}}
        mesh = jax.make_mesh((2, 2), ("data", "model"))
        for backend in ("counter", "lfsr"):
            cfg = TMConfig(prng_backend=backend, **{POD_CFG!r})
            state = init_state(cfg, jax.random.PRNGKey(0))
            rng = np.random.default_rng(0)
            x = (rng.random((16, cfg.features)) < 0.4).astype(np.int8)
            y = rng.integers(0, cfg.classes, 16).astype(np.int32)
            for name, (k, frac) in {POD_VARIANTS!r}.items():
                if backend != "counter" and name != "dense":
                    continue
                s, st = pod_train_step(cfg, state, to_literals(
                    jnp.asarray(x)), jnp.asarray(y), mesh, seed=3,
                    compact_k=k, compact_frac=frac)
                res[(backend, name)] = (
                    np.asarray(s.ta), np.asarray(s.weights),
                    {{k_: int(v) for k_, v in st.items()}},
                    np.asarray(state.ta))
        pickle.dump(res, open({str(out)!r}, "wb"))
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", [("counter", n) for n in POD_VARIANTS]
                         + [("lfsr", "dense")])
def test_pod_train_step_equals_jax_mesh(ranks, jax_pod, case):
    ta, w, stats, ta0 = jax_pod[case]
    assert not np.array_equal(ta, ta0)           # the step changed states
    for r, out in enumerate(ranks):
        got, got_stats = out["pod"][case]
        _assert_state(got, ta, w, f"rank {r} {case}")
        assert got_stats == stats, (r, case)


def test_pod_train_step_compaction_equals_dense(ranks):
    dense = ranks[0]["pod"][("counter", "dense")][0]
    for name in ("compact_k", "compact_frac"):
        got = ranks[0]["pod"][("counter", name)][0]
        _assert_state(got, dense["ta"], dense["weights"], name)


# ---------------------------------------------------------------------------
# (h) the compressed reductions equal JAX's under vmap over 4 shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "error", "axes"])
def test_compressed_psum_equals_jax_vmap(ranks, name):
    """Each rank's sum and residual equal JAX's ``compressed_psum`` under
    ``jax.vmap(..., axis_name="i")`` over the 4 ranks' inputs (within
    1e-6; the shared scale is the ranks' maximum)."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import compressed_psum as jpsum
    xs, errs, _ = (np.stack(a) for a in zip(*(
        _compression_inputs(r) for r in range(WORLD))))
    if name == "plain":
        total, resid = jax.vmap(lambda x: jpsum(x, "i"), axis_name="i")(
            jnp.asarray(xs))
    else:
        total, resid = jax.vmap(lambda x, e: jpsum(x, "i", e),
                                axis_name="i")(jnp.asarray(xs),
                                               jnp.asarray(errs))
    for r, out in enumerate(ranks):
        got_t, got_r, dtype = out["compress"][name]
        assert dtype == "torch.float32"
        np.testing.assert_allclose(got_t, np.asarray(total[r]), rtol=1e-6,
                                   atol=0, err_msg=f"rank {r} total")
        np.testing.assert_allclose(got_r, np.asarray(resid[r]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"rank {r} residual")


def test_exact_int8_psum_equals_jax_vmap(ranks):
    import jax
    import jax.numpy as jnp
    from repro.runtime import exact_int8_psum as jexact
    ds = np.stack([_compression_inputs(r)[2] for r in range(WORLD)])
    want = jax.vmap(lambda d: jexact(d, "i"), axis_name="i")(jnp.asarray(ds))
    for r, out in enumerate(ranks):
        got, dtype = out["compress"]["int8"]
        assert dtype == "torch.int32"
        np.testing.assert_array_equal(got, np.asarray(want[r]))
    np.testing.assert_array_equal(ranks[0]["compress"]["int8"][0],
                                  ds.sum(0))


# ---------------------------------------------------------------------------
# unit parity in the test process
# ---------------------------------------------------------------------------

def _tcfg(jc):
    return TMConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})


@pytest.mark.parametrize("tm_type", ["coalesced", "vanilla"])
def test_init_state_equals_jax(tm_type):
    import jax
    from repro.core import init_state as jinit
    jc = _jcfg(tm_type=tm_type, features=12, clauses=8, classes=3)
    for seed in (0, 3):
        js = jinit(jc, jax.random.PRNGKey(seed))
        ts = init_state(_tcfg(jc), threefry.key(seed, "cpu"), device="cpu")
        _assert_state(_state_np(ts), js.ta, js.weights, f"seed {seed}")
        # a JAX key array gives the same state
        ts2 = init_state(_tcfg(jc), np.asarray(jax.random.PRNGKey(seed)),
                         device="cpu")
        _assert_state(_state_np(ts2), js.ta, js.weights, "jax key")


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tm_type", ["coalesced", "vanilla"])
def test_feedback_train_step_equals_jax(tm_type, backend, mode):
    import jax
    import jax.numpy as jnp
    from repro.core import init_state as jinit, to_literals as jlits
    from repro.core import feedback as jfb
    from repro.core.prng import PRNG as JPRNG
    from test_torch_prng import jax_prng_numpy
    jc = _jcfg(tm_type=tm_type, features=12, clauses=8, classes=3, T=8,
               s=3.0, prng_backend=backend,
               boost_true_positive=backend != "lfsr")
    tc = _tcfg(jc)
    x, y = _batch(8, 12, 3, seed=1)
    js = jinit(jc, jax.random.PRNGKey(3))
    jp = JPRNG.create(jc, 5)
    ts = convert.state_from_numpy(
        {"ta": np.asarray(js.ta),
         "weights": None if js.weights is None else np.asarray(js.weights)},
        device="cpu")
    tp = convert.prng_from_numpy(jax_prng_numpy(jp), device="cpu")
    jstate, jp2, jst = jfb.train_step(jc, js, jp, (jlits(jnp.asarray(x)),
                                                   jnp.asarray(y)), mode, 4)
    tstate, tp2, tst = feedback.train_step(
        tc, ts, tp, (to_literals(x), torch.from_numpy(y)), mode, 4)
    # a second step, from the new states, on the batch reversed
    xr, yr = x[::-1].copy(), y[::-1].copy()
    jstate, jp2, jst = jfb.train_step(
        jc, jstate, jp2, (jlits(jnp.asarray(xr)), jnp.asarray(yr)), mode, 4)
    tstate, tp2, tst = feedback.train_step(
        tc, tstate, tp2, (to_literals(xr), torch.from_numpy(yr)), mode, 4)
    _assert_state(_state_np(tstate), jstate.ta, jstate.weights, mode)
    for f in ("selected_clauses", "active_groups", "total_groups",
              "correct"):
        assert int(getattr(tst, f)) == int(getattr(jst, f)), f
    want = jax_prng_numpy(jp2)
    for k, v in convert.prng_to_numpy(tp2).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("tm_type", ["coalesced", "vanilla"])
def test_class_sums_equal_jax(tm_type, B, backend):
    """``class_sums`` on the plain product and on the kernel path (the
    edge kernel at B <= 4, the dense one above; JAX's interpret-mode
    Pallas kernels), train and eval mode, and the logical oracle."""
    import jax
    import jax.numpy as jnp
    from repro.core import init_state as jinit, to_literals as jlits
    from repro.core import clause as jclause
    jc = _jcfg(tm_type=tm_type, features=20, clauses=8, classes=3,
               compute_backend=backend)
    tc = _tcfg(jc)
    js = jinit(jc, jax.random.PRNGKey(1))
    # a few all-exclude clauses, so the eval-mode convention shows
    ta = np.asarray(js.ta).copy()
    ta[::3] = 0
    js.ta = jnp.asarray(ta)
    ts = convert.state_from_numpy({"ta": ta, "weights": None if
                                   js.weights is None else
                                   np.asarray(js.weights)}, device="cpu")
    x, _ = _batch(B, 20, 3, seed=B)
    for eval_mode in (False, True):
        jsum, jout = jclause.class_sums(jc, js, jlits(jnp.asarray(x)),
                                        eval_mode)
        tsum, tout = clause.class_sums(tc, ts, to_literals(x), eval_mode)
        np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        inc = ta >= jc.include_threshold
        np.testing.assert_array_equal(
            clause.clause_outputs_logical(
                tc, torch.from_numpy(inc), to_literals(x), eval_mode).numpy(),
            np.asarray(jclause.clause_outputs_logical(
                jc, jnp.asarray(inc), jlits(jnp.asarray(x)), eval_mode)))


def test_threefry_fold_in_and_indexed_bits_equal_jax():
    import jax
    import jax.numpy as jnp
    from repro.core.prng import indexed_bits as jidx
    for seed in (0, 7, 2 ** 32 - 1):
        k = jax.random.PRNGKey(seed)
        for d in (0, 1, 3, 2 ** 31 + 5, 2 ** 32 - 1):
            want = np.asarray(jax.random.fold_in(k, d)).astype(np.int64)
            got = threefry.fold_in(threefry.key(seed, "cpu"), d).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{seed} {d}")
    rows = np.array([0, 5, 2, 31], np.uint32)
    for key in (0, 123, 65535):
        want = np.asarray(jidx(jnp.uint32(key), jnp.asarray(rows), 40, 16))
        got = indexed_bits(key, torch.from_numpy(rows.astype(np.int64)),
                           40, 16)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("tm_type", ["coalesced", "vanilla"])
def test_state_numpy_round_trip(tm_type):
    import jax
    from repro.core import init_state as jinit
    jc = _jcfg(tm_type=tm_type, features=12, clauses=8, classes=3,
               ta_bits=10)
    js = jinit(jc, jax.random.PRNGKey(4), dtype=np.int16)
    leaves = {"ta": np.asarray(js.ta),
              "weights": None if js.weights is None
              else np.asarray(js.weights)}
    back = convert.state_to_numpy(convert.state_from_numpy(leaves,
                                                           device="cpu"))
    assert back["ta"].dtype == np.int16
    _assert_state(back, js.ta, js.weights, "round trip")
    assert "TMState" in repr(convert.state_from_numpy(leaves, device="cpu"))
