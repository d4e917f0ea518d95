"""Training axes the other parity tests do not sweep (CPU, exact).

The port's engine ``train_step`` and ``ProgramBank.train`` against the JAX
engine's ``ref`` backend on: ``ta_bits`` 10 (int32 TA states),
``boost_true_positive=False``, ``lfsr_bits`` 4, 8, 12 and 32 with and
without the seed refresh, ``rand_bits`` 8, ``weight_bits`` 2, T 8000, and
a K=3 bank of mixed kinds (coalesced, vanilla, regression) at
``lfsr_bits`` 4 and 24; and, with the streamed TA words (the JAX engine
under ``REPRO_TA_PRNG=stream``, the port's ``ta_prng="stream"``), that bank
at ``s`` default and 1.0 and single steps of the three kinds at ``s`` 1.0
with the lfsr-4 refresh.  The port's ``fused_step_plain`` is also held
against the JAX package's ``fused_step_ref`` at ``rand_bits`` 8 and T 8000,
where ``p_num << rand_bits`` wraps in int32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ref as jref
from repro_torch import api as tapi
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.kernels.fused_step import fused_step_plain
from test_torch_train import _assert_same, _bridge, _data, _tspec
from test_torch_train_kernels import _front_inputs, _port_front

F = 21   # features
B = 8    # > 4: the fused front; 2B >= 2^4 - 1: an lfsr-4 refresh fires in
         # the TA streams


def _spec(kind, **kw):
    if kind == "regression":
        return japi.TMSpec.regression(features=F, clauses=24, **kw)
    if kind == "vanilla":
        return japi.TMSpec.vanilla(features=F, classes=3, clauses=8, **kw)
    return japi.TMSpec.coalesced(features=F, classes=4, clauses=32, **kw)


@pytest.fixture(scope="module")
def engines():
    """JAX ``ref`` and port engines, one pair per ``rand_bits``, of one
    geometry that fits every spec here."""
    specs = [_spec(k) for k in ("coalesced", "vanilla", "regression")]
    tile = japi.tile_for(*specs, x=32, y=128, m=128, n=4)
    ttile = tapi.tile_for(*(_tspec(s) for s in specs), x=32, y=128, m=128,
                          n=4)
    return {rb: (japi.compile(tile, backend="ref", rand_bits=rb),
                 tapi.compile(ttile, device="cpu", rand_bits=rb))
            for rb in (8, 16)}


def _steps(jeng, teng, jspec, seed, steps=2):
    jtm = japi.TM(jspec, engine=jeng, seed=seed)
    jprog, jprng = jtm.program, jtm.prng
    tprog, tprng = _bridge(jprog, jprng)
    tspec = _tspec(jspec)
    x, y = _data(jspec, steps * B, seed + 7)
    for s in range(steps):
        xb, yb = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        jprog, jprng, jst = jeng.train_step(
            jprog, jprng, jeng.encode(jspec, jnp.asarray(xb)),
            jspec.encode_labels(jnp.asarray(yb)))
        tprog, tprng, tst = teng.train_step(
            tprog, tprng, teng.encode(tspec, xb), tspec.encode_labels(yb))
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(v) for k, v in jst.items()}, s
    _assert_same(tprog, tprng, jprog, jprng, str(jspec))
    return tprog


# every lfsr width with and without the refresh, each beside one more axis
AXES = [("coalesced", 4, True, dict(ta_bits=10, T=300)),
        ("vanilla", 8, False, dict(boost_true_positive=False, T=6)),
        ("coalesced", 12, True, dict(weight_bits=2, T=8000)),
        ("regression", 32, False, dict(ta_bits=10, T=8000)),
        ("coalesced", 4, False, {}),
        ("coalesced", 8, True, {}),
        ("vanilla", 12, False, {}),
        ("coalesced", 32, True, {})]


@pytest.mark.parametrize("kind,lfsr_bits,refresh,kw", AXES)
def test_train_steps_match_jax_on_untested_axes(engines, kind, lfsr_bits,
                                                refresh, kw):
    jeng, teng = engines[16]
    _steps(jeng, teng, _spec(kind, prng_backend="lfsr", lfsr_bits=lfsr_bits,
                             seed_refresh=refresh, **kw), seed=lfsr_bits)


def test_train_steps_match_jax_at_rand_bits_8(engines):
    """rand_bits 8 with weight_bits 2 and T 8000: the selection compare
    wraps in int32 on both sides."""
    jeng, teng = engines[8]
    prog = _steps(jeng, teng, _spec("coalesced", prng_backend="lfsr",
                                    rand_bits=8, weight_bits=2, T=8000),
                  seed=8)
    assert int(prog.weights.abs().max()) <= 2


KINDS = ("coalesced", "vanilla", "regression")


def _bank_steps(jeng, teng, lfsr_bits, **kw):
    """Two steps of a K=3 mixed-kind bank (``ta_bits`` 10) on both
    engines; stats, programs and PRNGs must be equal."""
    specs = [_spec(k, prng_backend="lfsr", lfsr_bits=lfsr_bits, ta_bits=10,
                   **kw) for k in KINDS]
    starts = [(jtm.program, jtm.prng) for jtm in
              (japi.TM(s, engine=jeng, seed=i) for i, s in enumerate(specs))]
    bridged = [_bridge(p, r) for p, r in starts]
    jbank = japi.stack([p for p, _ in starts], jeng,
                       prngs=[r for _, r in starts])
    tbank = tapi.stack([p for p, _ in bridged], teng,
                       prngs=[r for _, r in bridged])
    data = [_data(s, B, 20 + i) for i, s in enumerate(specs)]
    jl = jnp.stack([jeng.encode(s, jnp.asarray(d[0]))
                    for s, d in zip(specs, data)])
    tl = torch.stack([teng.encode(_tspec(s), d[0])
                      for s, d in zip(specs, data)])
    labels = np.stack([np.asarray(s.encode_labels(d[1]))
                       for s, d in zip(specs, data)])
    for _ in range(2):
        jst = jbank.train(jl, jnp.asarray(labels))
        tst = tbank.train(tl, labels)
        for k in STAT_KEYS:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    for k, kind in enumerate(KINDS):
        jp = jax.tree.map(lambda t: t[k], jbank.progs)
        jr = jax.tree.map(lambda t: t[k], jbank.prngs)
        _assert_same(tbank.swap_out(k), tbank.prngs[k], jp, jr, kind)


@pytest.mark.parametrize("lfsr_bits", [4, 24])
def test_mixed_kind_bank_matches_jax(engines, lfsr_bits):
    _bank_steps(*engines[16], lfsr_bits)


@pytest.fixture(scope="module")
def stream_cache():
    return {}


@pytest.fixture
def stream_engines(stream_cache, monkeypatch):
    """The streamed pair: a JAX ``ref`` engine made once for the module
    and run under ``REPRO_TA_PRNG=stream`` (set on the JAX side only), and
    a port engine with ``ta_prng="stream"``."""
    monkeypatch.setenv("REPRO_TA_PRNG", "stream")
    if not stream_cache:
        specs = [_spec(k) for k in KINDS]
        tile = japi.tile_for(*specs, x=32, y=128, m=128, n=4)
        ttile = tapi.tile_for(*(_tspec(s) for s in specs), x=32, y=128,
                              m=128, n=4)
        stream_cache["pair"] = (
            japi.compile(tile, backend="ref"),
            tapi.compile(ttile, device="cpu", ta_prng="stream"))
    return stream_cache["pair"]


@pytest.mark.parametrize("s", [None, 1.0])
@pytest.mark.parametrize("lfsr_bits", [4, 24])
def test_streamed_mixed_kind_bank_matches_jax(stream_engines, lfsr_bits, s):
    jeng, teng = stream_engines
    _bank_steps(jeng, teng, lfsr_bits, **({} if s is None else {"s": s}))
    paths = teng.cache_report()["path_per_stage"]
    assert paths["train_bank_ta"] == "dense"
    assert paths["train_bank_prng"] == "lfsr-stream"
    assert jeng.cache_report()["path_per_stage"]["train_bank_prng"] == \
        "lfsr-stream"


@pytest.mark.parametrize("kind", KINDS)
def test_streamed_steps_at_s_1_match_jax(stream_engines, kind):
    jeng, teng = stream_engines
    _steps(jeng, teng, _spec(kind, prng_backend="lfsr", lfsr_bits=4,
                             seed_refresh=True, s=1.0), seed=3)
    assert teng.cache_report()["path_per_stage"]["train_prng"] == \
        "lfsr-stream"


@pytest.mark.parametrize("frozen", [False, True])
def test_fused_step_plain_matches_jax_at_rand_bits_8_and_T_8000(frozen):
    inp = list(_front_inputs(11, 7, 90, 70, 5, frozen))
    rng = np.random.default_rng(5)
    inp[2] = rng.integers(-2047, 2048, inp[2].shape).astype(np.int32)
    inp[5] = rng.integers(0, 1 << 8, inp[5].shape).astype(np.uint32)
    inp[8] = 8000
    lits, inc, w, labels, neg, rand, cl_mask, h_mask, T, wf = inp
    want = jref.fused_step_ref(*(jnp.asarray(a) for a in inp[:5]),
                               jnp.asarray(rand[0]), jnp.asarray(rand[1]),
                               jnp.asarray(cl_mask), jnp.asarray(h_mask),
                               T, wf, rand_bits=8)
    got = fused_step_plain(*_port_front(*inp), rand_bits=8, n_bits=70)
    for name, g, wnt in zip(("clause", "sums", "sel_lab", "sel_neg"), got,
                            want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt),
                                      err_msg=name)
    assert 0 < int(got[2].sum()) < got[2].numel()
