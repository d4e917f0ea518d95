"""The port's legacy TM variants and drivers against the JAX package, on
the CPU: ``conv_tm``, ``regression_tm``, ``TMHead`` and
``pool_backbone_features``, ``feedback_fit`` (both modes, both compute
backends), ``TMConfig.ops_per_inference``, ``PRNG.max_rand``,
``fit_threshold`` and ``DTMEngine.pad_features(cfg=)``.

Integer outputs (TA states, weights, PRNG state, stats, histories,
predictions) are held for exact equality; the float pooling at
``rtol=1e-6, atol=1e-6``.  One jitted JAX step per module: each new
batch shape retraces it, so the shapes are few and small.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (PRNG, TMConfig, conv_tm, fit_threshold,
                              regression_tm, threefry, to_literals)
from repro_torch.core.evaluate import feedback_fit
from repro_torch.core.tm_head import TMHead, pool_backbone_features
from test_torch_prng import jax_prng_numpy

CONV = dict(img_h=6, img_w=6, patch=3, clauses=16, classes=3, T=8, s=3.0)
REG = dict(features=12, clauses=16, T=16, s=3.0)


def _state_np(jstate):
    return {"ta": np.asarray(jstate.ta),
            "weights": (None if jstate.weights is None
                        else np.asarray(jstate.weights))}


def _assert_state(tstate, jstate, what=""):
    got = convert.state_to_numpy(tstate)
    np.testing.assert_array_equal(got["ta"], np.asarray(jstate.ta),
                                  err_msg=f"{what} ta")
    assert got["ta"].dtype == np.asarray(jstate.ta).dtype, what
    if jstate.weights is None:
        assert got["weights"] is None, what
    else:
        np.testing.assert_array_equal(got["weights"],
                                      np.asarray(jstate.weights),
                                      err_msg=f"{what} weights")


def _assert_prng(tprng, jprng, what=""):
    want = jax_prng_numpy(jprng)
    for k, v in convert.prng_to_numpy(tprng).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=f"{what} {k}")


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, w)) < 0.4).astype(np.int8), \
        rng.integers(0, 3, n).astype(np.int32)


# ---------------------------------------------------------------------------
# conv_tm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jconv():
    import jax
    from repro.core import conv_tm as jc
    cfg = jc.ConvTMConfig(**CONV)
    step = jax.jit(lambda s, p, im, lb: jc.train_step(cfg, s, p, im, lb))
    return jc, cfg, step


def _conv_state(jc, cfg, seed):
    """A state whose clauses include few literals, so some fire on several
    patches, some on none (a clause that includes a pixel and its
    negation), and the all-exclude clause 0 fires everywhere."""
    import jax.numpy as jnp
    from repro.core.types import TMState as JState
    rng = np.random.default_rng(seed)
    tm = cfg.tm_config()
    j = tm.include_threshold
    ta = np.full((cfg.clauses, cfg.literals), j - 1, np.int32)
    for c in range(1, cfg.clauses):
        ta[c, rng.choice(cfg.patch * cfg.patch, 1 + c % 2)] = j
    ta[3, [0, cfg.patch_features]] = j            # x0 and not x0: never fires
    w = rng.choice([-2, -1, 1, 2], (cfg.classes, cfg.clauses)).astype(np.int32)
    return JState(jnp.asarray(ta), jnp.asarray(w))


def test_conv_init_equals_jax(jconv):
    import jax
    jc, jcfg, _ = jconv
    tcfg = conv_tm.ConvTMConfig(**CONV)
    js, jp = jc.init(jcfg, jax.random.PRNGKey(4))
    ts, tp = conv_tm.init(tcfg, threefry.key(4, "cpu"), device="cpu")
    _assert_state(ts, js, "init")
    _assert_prng(tp, jp, "init")
    assert (tcfg.n_patches, tcfg.pos_bits, tcfg.literals) == (
        jcfg.n_patches, jcfg.pos_bits, jcfg.literals)


def test_conv_infer_and_predict_equal_jax(jconv):
    import jax.numpy as jnp
    jc, jcfg, _ = jconv
    tcfg = conv_tm.ConvTMConfig(**CONV)
    js = _conv_state(jc, jcfg, 1)
    ts = convert.state_from_numpy(_state_np(js), device="cpu")
    x, _ = _images(4, 6, 6, 2)
    for eval_mode in (False, True):
        want = jc.infer(jcfg, js, jnp.asarray(x), eval_mode)
        got = conv_tm.infer(tcfg, ts, x, eval_mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        conv_tm.predict(tcfg, ts, x).numpy(),
        np.asarray(jc.predict(jcfg, js, jnp.asarray(x))))


def test_conv_patch_pick_ties_and_no_fire():
    """Every fired patch of a (datapoint, clause) scores the same, so the
    pick is the first fired patch, and patch 0 where none fired: JAX's
    perturbed argmax, mirrored."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    B, P, C = 3, 9, 5
    fired = np.zeros((B, P, C), np.int32)
    fired[0, [2, 5, 7], 0] = 1          # three ties: the first, 2
    fired[1, [8], 1] = 1                # one, the last patch
    fired[:, :, 2] = 1                  # all: 0
    fired[2, [4, 6], 4] = 1             # two: 4; clause 3 fires nowhere: 0
    patch_rand = rng.integers(0, 1 << 16, (B, C)).astype(np.uint32)
    got = conv_tm.pick_patches(torch.from_numpy(fired),
                               torch.from_numpy(patch_rand.astype(np.int64)))
    noise = (jnp.asarray(patch_rand)[:, None, :] % jnp.uint32(997)).astype(
        jnp.int32)
    score = jnp.asarray(fired) * 1000 + noise % 997
    want = np.asarray(jnp.argmax(score.transpose(0, 2, 1), -1))
    np.testing.assert_array_equal(got.numpy(), want)
    first = np.where(fired.any(1), fired.argmax(1), 0)
    np.testing.assert_array_equal(got.numpy(), first)
    assert got[0, 0] == 2 and got[1, 1] == 8 and got[2, 4] == 4
    assert (got[:, 3] == 0).all() and (got[:, 2] == 0).all()


@pytest.mark.parametrize("boost", [True, False])
def test_conv_train_steps_equal_jax(jconv, boost):
    """Two steps at 6x6 / patch 3 / 16 clauses / B=4 from a state with
    tied, single and absent patch matches: TA, weights, PRNG, stats."""
    import jax.numpy as jnp
    jc, jcfg, step = jconv
    if not boost:
        import jax
        jcfg = dataclasses.replace(jcfg, boost_true_positive=False)
        step = jax.jit(lambda s, p, im, lb: jc.train_step(jcfg, s, p, im,
                                                          lb))
    tcfg = conv_tm.ConvTMConfig(**{**CONV, "boost_true_positive": boost})
    js = _conv_state(jc, jcfg, 3)
    jp = jc.PRNG.create(jcfg.tm_config(), 1)
    ts = convert.state_from_numpy(_state_np(js), device="cpu")
    tp = PRNG.create(tcfg.tm_config(), 1, device="cpu")
    _, cl, fired, _ = jc.infer(jcfg, js, jnp.asarray(_images(4, 6, 6, 0)[0]),
                               False)
    fired = np.asarray(fired)
    assert (fired.sum(1) > 1).any() and (fired.sum(1) == 0).any()
    for k in range(2):
        x, y = _images(4, 6, 6, k)
        js, jp, jst = step(js, jp, jnp.asarray(x), jnp.asarray(y))
        ts, tp, tst = conv_tm.train_step(tcfg, ts, tp, x, y)
        _assert_state(ts, js, f"step {k}")
        _assert_prng(tp, jp, f"step {k}")
        assert int(tst["correct"]) == int(jst["correct"])
    assert (np.asarray(js.ta) != np.asarray(_conv_state(jc, jcfg, 3).ta)).any()
    xt, _ = _images(6, 6, 6, 9)
    np.testing.assert_array_equal(
        conv_tm.predict(tcfg, ts, xt).numpy(),
        np.asarray(jc.predict(jcfg, js, jnp.asarray(xt))))


# ---------------------------------------------------------------------------
# regression_tm
# ---------------------------------------------------------------------------

def test_regression_tm_equals_jax():
    import jax
    import jax.numpy as jnp
    from repro.core import regression_tm as jr
    jcfg = jr.RegressionTMConfig(**REG)
    tcfg = regression_tm.RegressionTMConfig(**REG)
    js, jp = jr.init(jcfg, jax.random.PRNGKey(2))
    ts, tp = regression_tm.init(tcfg, threefry.key(2, "cpu"), device="cpu")
    _assert_state(ts, js, "init")
    _assert_prng(tp, jp, "init")
    # sparser includes so that clauses fire and the errors have both signs
    rng = np.random.default_rng(0)
    ta = np.asarray(js.ta).copy()
    ta[rng.random(ta.shape) < 0.8] = 0
    js = type(js)(jnp.asarray(ta), None)
    ts = convert.state_from_numpy({"ta": ta, "weights": None}, device="cpu")
    step = jax.jit(lambda s, p, l, t: jr.train_step(jcfg, s, p, l, t))
    for k in range(3):
        x = (rng.random((8, REG["features"])) < 0.5).astype(np.int8)
        # targets on the half grid of T too: round half to even
        t = np.concatenate([rng.random(6), [2.5 / 16, 0.5 / 16]]).astype(
            np.float32)
        js, jp, jst = step(js, jp, jnp.asarray(np.concatenate([x, 1 - x],
                                                              -1)),
                           jnp.asarray(t))
        ts, tp, tst = regression_tm.train_step(tcfg, ts, tp, to_literals(x),
                                               torch.from_numpy(t))
        _assert_state(ts, js, f"step {k}")
        _assert_prng(tp, jp, f"step {k}")
        assert tst["mae"].dtype == torch.float32
        assert float(tst["mae"]) == float(jst["mae"])
    x = (rng.random((8, REG["features"])) < 0.5).astype(np.int8)
    for eval_mode in (True, False):
        got = regression_tm.predict(tcfg, ts, to_literals(x), eval_mode)
        want = jr.predict(jcfg, js, jnp.asarray(np.concatenate([x, 1 - x],
                                                                 -1)),
                          eval_mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# TMHead
# ---------------------------------------------------------------------------

def test_tm_head_equals_jax():
    """``TMHead`` at the system test's widths (16 features x 4
    thermometer bits, 32 clauses, 3 classes, T=16, s=4): the seed's state
    and threefry PRNG, two ``train_batch`` calls on identical float32
    pooled features, ``predict``."""
    import jax.numpy as jnp
    from repro.core import TMHead as JHead
    rng = np.random.default_rng(0)
    protos = rng.standard_normal((3, 16))
    y = rng.integers(0, 3, 80).astype(np.int32)
    feats = (protos[y] + 0.3 * rng.standard_normal((80, 16))).astype(
        np.float32)
    kw = dict(calib=feats[:32], therm_bits=4, clauses=32, T=16, s=4.0,
              seed=3)
    jh = JHead.create(16, 3, **kw)
    th = TMHead.create(16, 3, device="cpu", **kw)
    np.testing.assert_array_equal(th.booleanizer.thresholds,
                                  jh.booleanizer.thresholds)
    _assert_state(th.state, jh.state, "create")
    _assert_prng(th.prng, jh.prng, "create")
    for i in range(2):
        xb, yb = feats[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8]
        jst = jh.train_batch(jnp.asarray(xb), jnp.asarray(yb))
        tst = th.train_batch(xb, yb)
        _assert_state(th.state, jh.state, f"batch {i}")
        _assert_prng(th.prng, jh.prng, f"batch {i}")
        for f in ("selected_clauses", "active_groups", "total_groups",
                  "correct"):
            assert int(getattr(tst, f)) == int(getattr(jst, f)), f
    np.testing.assert_array_equal(
        th.predict(feats[32:]).numpy(),
        np.asarray(jh.predict(jnp.asarray(feats[32:]))))
    # JAX's head crosses as numpy and trains on as JAX's does
    crossed = convert.head_from_numpy(
        th.cfg, np.asarray(jh.booleanizer.thresholds), _state_np(jh.state),
        jax_prng_numpy(jh.prng), device="cpu")
    jh.train_batch(jnp.asarray(feats[16:24]), jnp.asarray(y[16:24]))
    crossed.train_batch(feats[16:24], y[16:24])
    _assert_state(crossed.state, jh.state, "crossed head")
    _assert_prng(crossed.prng, jh.prng, "crossed head")


def test_pool_backbone_features_equals_jax():
    import jax.numpy as jnp
    from repro.core import pool_backbone_features as jpool
    rng = np.random.default_rng(1)
    h = rng.standard_normal((4, 7, 6)).astype(np.float32)
    mask = (rng.random((4, 7)) < 0.6).astype(np.int32)
    mask[2] = 0                           # an empty row: the divisor floor
    for m in (None, mask):
        got = pool_backbone_features(
            torch.from_numpy(h), None if m is None else torch.from_numpy(m))
        want = jpool(jnp.asarray(h), None if m is None else jnp.asarray(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# feedback_fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["jnp", "pallas"])
@pytest.mark.parametrize("mode,backend", [("sequential", "threefry"),
                                          ("batched", "threefry"),
                                          ("sequential", "lfsr")])
def test_feedback_fit_equals_jax(mode, backend, compute):
    """A few rows through both drivers: the state, PRNG and history equal
    JAX's.  ``pallas`` runs the port's kernel wrappers (their plain
    versions here) against JAX's interpret-mode kernels; ``sequential``
    takes the edge clause path (B=1), ``batched`` the dense one."""
    from repro.core import TMConfig as JConfig
    from repro.core.evaluate import feedback_fit as jfit
    kw = dict(tm_type="coalesced", features=10, clauses=8, classes=3, T=8,
              s=3.0, prng_backend=backend, compute_backend=compute)
    rng = np.random.default_rng(5)
    x = (rng.random((12, 10)) < 0.4).astype(np.int8)
    y = rng.integers(0, 3, 12).astype(np.int32)
    fit_kw = dict(epochs=2, batch=6, seed=1, mode=mode, chunk=3)
    js, jp, jh = jfit(JConfig(**kw), x, y, **fit_kw)
    ts, tp, th = feedback_fit(TMConfig(**kw), x, y, device="cpu", **fit_kw)
    _assert_state(ts, js, mode)
    _assert_prng(tp, jp, mode)
    assert th == jh


BD_B = 8


@pytest.mark.parametrize("chunk", [1, 4, BD_B])
@pytest.mark.parametrize("tm_type,backend", [("coalesced", "threefry"),
                                             ("coalesced", "lfsr"),
                                             ("vanilla", "counter")])
def test_batched_deltas_equal_jax(tm_type, backend, chunk):
    """``feedback.batched_deltas`` (a chunk of datapoints as one batched
    expression, JAX's ``vmap``) equals JAX's at every chunk size: the
    PRNG state, ``d_ta``, ``d_w``, ``d_sel`` and ``correct``."""
    import jax
    import jax.numpy as jnp
    from repro.core import TMConfig as JConfig
    from repro.core import feedback as jfb
    from repro.core import init_state as jinit, to_literals as jlits
    from repro.core.prng import PRNG as JPRNG
    from repro_torch.core import feedback
    kw = dict(tm_type=tm_type, features=10, clauses=8, classes=3, T=8,
              s=3.0, prng_backend=backend,
              boost_true_positive=backend != "lfsr")
    jc = JConfig(**kw)
    rng = np.random.default_rng(7)
    x = (rng.random((BD_B, 10)) < 0.4).astype(np.int8)
    y = rng.integers(0, 3, BD_B).astype(np.int32)
    js = jinit(jc, jax.random.PRNGKey(4))
    jp = JPRNG.create(jc, 6)
    ts = convert.state_from_numpy(_state_np(js), device="cpu")
    tp = convert.prng_from_numpy(jax_prng_numpy(jp), device="cpu")
    jp2, jta, jw, jsel, jcorr = jfb.batched_deltas(
        jc, js, jp, jlits(jnp.asarray(x)), jnp.asarray(y), chunk)
    tp2, tta, tw, tsel, tcorr = feedback.batched_deltas(
        TMConfig(**kw), ts, tp, to_literals(x), torch.from_numpy(y), chunk)
    _assert_prng(tp2, jp2, f"chunk {chunk}")
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    assert tta.dtype == torch.int32
    if jw is None:
        assert tw is None
    else:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert int(tcorr) == int(jcorr)
    assert np.abs(np.asarray(jta)).sum() > 0          # feedback happened


# ---------------------------------------------------------------------------
# small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tm_type", ["coalesced", "vanilla"])
def test_ops_per_inference_equals_jax(tm_type):
    from repro.core import TMConfig as JConfig
    for f, c, h in ((784, 2000, 10), (12, 8, 3)):
        kw = dict(tm_type=tm_type, features=f, clauses=c, classes=h)
        assert TMConfig(**kw).ops_per_inference() == \
            JConfig(**kw).ops_per_inference()


def test_max_rand_equals_jax():
    from repro.core import TMConfig as JConfig
    from repro.core.prng import PRNG as JPRNG
    for backend in ("lfsr", "counter", "threefry"):
        for rb in (8, 16):
            kw = dict(prng_backend=backend, rand_bits=rb, lfsr_bits=16)
            t = PRNG.create(TMConfig(**kw), 3, n_lanes=16, device="cpu")
            j = JPRNG.create(JConfig(**kw), 3, n_lanes=16)
            assert t.max_rand == j.max_rand == 1 << rb


def test_fit_threshold_equals_jax():
    from repro.core import fit_threshold as jfit
    rng = np.random.default_rng(2)
    calib = rng.standard_normal((33, 5)).astype(np.float32)
    raw = rng.standard_normal((7, 5)).astype(np.float32)
    for value in (None, 0.25):
        tb, jb = fit_threshold(calib, value), jfit(calib, value)
        assert tb.thresholds.dtype == jb.thresholds.dtype == np.float32
        np.testing.assert_array_equal(tb.thresholds, jb.thresholds)
        np.testing.assert_array_equal(tb(raw).numpy(), np.asarray(jb(raw)))


def test_pad_features_takes_cfg_as_jax():
    import jax.numpy as jnp
    from repro.core import TMConfig as JConfig, TileConfig as JTile
    from repro.core.dtm import DTMEngine as JEngine
    from repro_torch.core import DTMEngine, TileConfig
    tile = dict(x=32, y=16, m=16, n=4, max_features=40, max_clauses=16,
                max_classes=4)
    jeng, teng = JEngine(JTile(**tile)), DTMEngine(TileConfig(**tile),
                                                   device="cpu")
    x = (np.random.default_rng(3).random((5, 30)) < 0.5).astype(np.int8)
    want = np.asarray(jeng.pad_features(jnp.asarray(x),
                                        JConfig(features=30)))
    for got in (teng.pad_features(x, TMConfig(features=30)),
                teng.pad_features(x, cfg=None), teng.pad_features(x)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
