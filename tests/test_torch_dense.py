"""The dense clause datapath and the streamed TA baseline of the port
against the JAX package (CPU, exact).

The plain versions of ``clause_eval``, ``tm_infer`` and
``ta_update_streamed`` (what a CPU tensor runs, and what the card's
kernels are held against) must equal the JAX package's Pallas kernels in
interpret mode, on ragged shapes, one program and a bank; and the engine's
``kernel_path="mxu"`` and ``ta_prng="stream"`` paths must equal the JAX
engine run under ``REPRO_KERNEL_PATH=mxu`` / ``REPRO_TA_PRNG=stream``
(every program leaf, the PRNG state, the stats and ``path_per_stage``).
The environment is set on the JAX side only: the port takes arguments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api as tapi
from repro_torch.core.booleanize import pack_literals
from repro_torch.core.dtm import STAT_KEYS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.clause_eval import clause_eval, clause_eval_plain
from repro_torch.kernels.ta_update import (stream_rands, ta_update_streamed,
                                           ta_update_streamed_plain)
from repro_torch.kernels.tm_infer import tm_infer, tm_infer_plain
from test_torch_train import _assert_same, _bridge, _data, _jspec, _tspec
from test_torch_train_kernels import P_TA, SEED, STREAMS, _ta_inputs

DENSE_SHAPES = [(5, 130, 200), (1, 64, 100), (32, 257, 256)]   # B, C, L


def _dense(seed, K, B, C, L, p_inc=0.02):
    rng = np.random.default_rng(seed)
    lit = (rng.random((K, B, L)) < 0.6).astype(np.int8)
    inc = (rng.random((K, C, L)) < p_inc).astype(np.int8)
    inc[:, ::9] = 0                             # empty clauses
    inc[:, 1::11, :] = 0
    inc[:, 1::11, :3] = 1                       # short clauses that fire
    lit[:, :, :3] = 1
    return lit, inc


@pytest.mark.parametrize("B,C,L", DENSE_SHAPES)
@pytest.mark.parametrize("eval_mode", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_clause_eval_matches_jax(K, B, C, L, eval_mode):
    lit, inc = _dense(B + C + K, K, B, C, L)
    got = tops.clause_eval_op(torch.from_numpy(lit), torch.from_numpy(inc),
                              eval_mode=eval_mode)
    oracle = tref.clause_eval_ref(torch.from_numpy(lit),
                                  torch.from_numpy(inc), eval_mode)
    assert torch.equal(got, oracle)
    for k in range(K):
        want = np.asarray(jops.clause_eval_op(
            jnp.asarray(lit[k]), jnp.asarray(inc[k]), eval_mode=eval_mode))
        np.testing.assert_array_equal(got[k].numpy(), want)
        one = tops.clause_eval_op(torch.from_numpy(lit[k]),
                                  torch.from_numpy(inc[k]), eval_mode)
        np.testing.assert_array_equal(one.numpy(), want)
    fired = got.sum().item()
    assert 0 < fired < got.numel()


@pytest.mark.parametrize("B,C,L", DENSE_SHAPES[:2])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_tm_infer_matches_jax(B, C, L, eval_mode):
    K, H = 2, 7
    lit, inc = _dense(B * C, K, B, C, L)
    w = np.random.default_rng(C).integers(-9, 10, (K, H, C)).astype(np.int32)
    tl, ti, tw = (torch.from_numpy(a) for a in (lit, inc, w))
    got = tops.tm_infer_op(tl, ti, tw, eval_mode=eval_mode)
    assert torch.equal(got, tref.tm_infer_ref(tl, ti, tw, eval_mode))
    assert torch.equal(got, tops.class_sum_op(
        tops.clause_eval_op(tl, ti, eval_mode), tw))
    for k in range(K):
        want = jops.tm_infer_op(jnp.asarray(lit[k]), jnp.asarray(inc[k]),
                                jnp.asarray(w[k]), eval_mode=eval_mode)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
    assert got.abs().sum() > 0


def test_dense_wrappers_reject_bad_operands():
    lit = torch.zeros((1, 3, 8), dtype=torch.int8)
    inc = torch.zeros((1, 4, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        clause_eval(lit.to(torch.int32), inc)
    with pytest.raises(ValueError):
        clause_eval(lit, inc[:, :, :7])
    with pytest.raises(ValueError):
        tm_infer(lit, inc, torch.zeros((1, 2, 5), dtype=torch.int32))
    with pytest.raises(TypeError):
        tm_infer(lit, inc, torch.zeros((1, 2, 4), dtype=torch.int64))
    meta = torch.empty((1, 2, 2), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        clause_eval(meta, meta)
    # the CPU route is the plain version, exactly
    assert torch.equal(clause_eval(lit, inc, True),
                       clause_eval_plain(lit, inc, True))
    w = torch.ones((1, 2, 4), dtype=torch.int32)
    assert torch.equal(tm_infer(lit, inc, w, False),
                       tm_infer_plain(lit, inc, w, False))


@pytest.mark.parametrize("stream", ["counter", "lfsr4"])
def test_ta_update_streamed_matches_jax(stream):
    """The streamed update with a row offset, against the JAX streamed
    path (the materialised stream and the interpret-mode Pallas kernel),
    and equal to the port's in-kernel update."""
    C, L, B2, row0 = 130, 200, 6, 5
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(len(stream), B2, C, L, 8)
    kw = STREAMS[stream]
    want = np.asarray(jops.ta_update_op(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
        jnp.uint32(SEED), jnp.uint32(P_TA), 16, True, n, backend="pallas",
        row0=row0, stream=True, **kw))
    assert (want != ta).any()
    one = lambda a: torch.from_numpy(np.asarray(a))[None]
    args = (one(ta), pack_literals(one(lits)), one(cl), one(t1), one(t2),
            one(l_mask))
    scal = (torch.tensor([SEED]), torch.tensor([P_TA]),
            torch.tensor([True]), torch.tensor([n]))
    got = tops.ta_update_op(*args, *scal, row0=row0, stream=True, **kw)
    np.testing.assert_array_equal(got[0][0].numpy(), want)
    inkernel = tops.ta_update_op(*args, *scal, row0=row0, **kw)
    for g, i in zip(got, inkernel):
        assert torch.equal(g, i)
    # the random words are the JAX package's stream at the padded keying
    rands = stream_rands(1, B2, C, L, scal[0], "cpu", row0, **kw)
    jr = jref.ta_rand_stream(jnp.uint32(SEED), B2, C, L, 16,
                             row_idx=row0 + jnp.arange(C), **kw)
    np.testing.assert_array_equal(rands[0].numpy().view(np.uint32),
                                  np.asarray(jr))
    for fn in (ta_update_streamed, ta_update_streamed_plain):
        for g, i in zip(fn(*args, rands, *scal[1:]), inkernel):
            assert torch.equal(g, i)


def test_ta_update_streamed_bank_is_per_program():
    K, B2, C, L = 2, 4, 40, 70
    parts = [_ta_inputs(10 + k, B2, C, L, 10) for k in range(K)]
    stack = [torch.from_numpy(np.stack([p[i] for p in parts]))
             for i in range(6)]
    stack[1] = pack_literals(stack[1])
    n = parts[0][-1]
    seed = torch.tensor([SEED, 12345])
    scal = (seed, torch.full((K,), P_TA), torch.tensor([True, False]),
            torch.full((K,), n))
    got = tops.ta_update_op(*stack, *scal, stream=True, prng="counter")
    want = tops.ta_update_op(*stack, *scal, prng="counter")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32


def test_ta_rand_stream_is_one_int32_tensor():
    got = tref.ta_rand_stream(torch.tensor([SEED, 7]), 5, 3, 40, 32,
                              row_idx=torch.arange(3)[None] +
                              torch.tensor([[0], [9]]))
    assert got.dtype == torch.int32 and got.shape == (2, 5, 3, 40)
    for k, (s, r0) in enumerate(((SEED, 0), (7, 9))):
        want = tref.ta_rand_stream(s, 5, 3, 40, 32, row_idx=r0 +
                                   torch.arange(3))
        assert torch.equal(got[k], want)
    assert (got < 0).any()      # 32-bit words keep their top bit


def test_select_paths():
    assert tops.select_path(3, force="mxu") == "mxu"
    assert tops.select_path(32, force="fused", training=True) == "fused"
    assert tops.select_ta_path(1, True, "stream") == "dense"
    assert tops.select_ta_path(1, True, "inkernel") == "compact"
    with pytest.raises(ValueError):
        tops.select_ta_path(1, True, "hbm")
    with pytest.raises(ValueError):
        tapi.compile(tapi.tile_for(tapi.TMSpec.coalesced(8, 2)),
                     device="cpu", ta_prng="hbm")


# --------------------------------------------------------------------------
# the engine against the JAX engine under REPRO_KERNEL_PATH / REPRO_TA_PRNG
# --------------------------------------------------------------------------

SETTINGS = {"mxu": dict(kernel_path="mxu"),
            "stream": dict(ta_prng="stream"),
            "fused_stream": dict(kernel_path="fused", ta_prng="stream")}
KINDS = ("coalesced", "vanilla", "head")


def _env(setting):
    kw = SETTINGS[setting]
    return {"REPRO_KERNEL_PATH": kw.get("kernel_path", ""),
            "REPRO_TA_PRNG": kw.get("ta_prng", "inkernel")}


@pytest.fixture(scope="module")
def geometry():
    tile = japi.tile_for(*(_jspec(k) for k in KINDS), x=32, y=128, m=128,
                         n=4)
    ttile = tapi.tile_for(*(_tspec(_jspec(k)) for k in KINDS), x=32, y=128,
                          m=128, n=4)
    return tile, ttile, {}


@pytest.fixture
def pair(geometry, monkeypatch, request):
    """(JAX engine, port engine) of one setting: the JAX engine (Pallas
    kernels in interpret mode) is made once per setting and runs with the
    setting's environment; the port engine is fresh and takes arguments."""
    setting = request.param
    tile, ttile, cache = geometry
    for k, v in _env(setting).items():
        monkeypatch.setenv(k, v)
    if setting not in cache:
        cache[setting] = japi.compile(tile, backend="kernel")
    return cache[setting], tapi.compile(ttile, device="cpu",
                                        **SETTINGS[setting])


def _paths_agree(teng, jeng):
    got = teng.cache_report()["path_per_stage"]
    want = jeng.cache_report()["path_per_stage"]
    assert got == {k: want[k] for k in got}, (got, want)
    return got


@pytest.mark.parametrize("pair", ["mxu"], indirect=True)
@pytest.mark.parametrize("B", [3, 8])
def test_mxu_engine_inference_matches_jax(pair, B):
    jeng, teng = pair
    both = []
    for i, kind in enumerate(KINDS):
        jspec = _jspec(kind)
        jtm = japi.TM(jspec, engine=jeng, seed=i)
        tprog, _ = _bridge(jtm.program, jtm.prng)
        x, _ = _data(jspec, B, 20 + i)
        jl = jeng.encode(jspec, jnp.asarray(x))
        tl = teng.encode(_tspec(jspec), x)
        js, jc = jeng.infer(jtm.program, jl)
        ts, tc = teng.infer(tprog, tl)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(teng.predict(tprog, tl).numpy(),
                                      np.asarray(jeng.predict(jtm.program,
                                                              jl)))
        both.append((jtm.program, tprog, jl, tl))
    jbank = japi.stack([b[0] for b in both], jeng)
    tbank = tapi.stack([b[1] for b in both], teng)
    js, jc = jbank.infer(jnp.stack([b[2] for b in both]))
    ts, tc = tbank.infer(torch.stack([b[3] for b in both]))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    paths = _paths_agree(teng, jeng)
    assert paths == {"infer": "mxu", "infer_bank": "mxu"}


def _train_both(jeng, teng, kind, backend, B, steps=2, seed=0):
    jspec = _jspec(kind, backend)
    tspec = _tspec(jspec)
    jtm = japi.TM(jspec, engine=jeng, seed=seed)
    jprog, jprng = jtm.program, jtm.prng
    tprog, tprng = _bridge(jprog, jprng)
    x, y = _data(jspec, steps * B, seed + 30)
    for s in range(steps):
        xb, yb = x[s * B:(s + 1) * B], y[s * B:(s + 1) * B]
        jprog, jprng, jst = jeng.train_step(
            jprog, jprng, jeng.encode(jspec, jnp.asarray(xb)),
            jspec.encode_labels(jnp.asarray(yb)))
        tprog, tprng, tst = teng.train_step(
            tprog, tprng, teng.encode(tspec, xb), tspec.encode_labels(yb))
        assert {k: int(v) for k, v in tst.items()} == \
            {k: int(v) for k, v in jst.items()}, (kind, s)
    _assert_same(tprog, tprng, jprog, jprng, f"{kind} {backend}")
    assert not torch.equal(tprog.ta, _bridge(jtm.program, jtm.prng)[0].ta)


@pytest.mark.parametrize("pair", list(SETTINGS), indirect=True)
@pytest.mark.parametrize("backend", ["counter", "lfsr"])
def test_train_step_matches_jax(pair, backend):
    jeng, teng = pair
    kind = "coalesced" if backend == "lfsr" else "vanilla"
    _train_both(jeng, teng, kind, backend, B=6)
    paths = _paths_agree(teng, jeng)
    assert paths["train"] == (teng.kernel_path or "fused")
    assert paths["train_ta"] == ("compact" if teng.ta_prng == "inkernel"
                                 else "dense")
    assert paths["train_prng"] == f"{backend}-{teng.ta_prng}"


@pytest.mark.parametrize("pair", ["mxu", "stream"], indirect=True)
def test_train_bank_matches_jax(pair):
    jeng, teng = pair
    specs = [_jspec(k) for k in KINDS]
    starts = []
    for i, s in enumerate(specs):
        jtm = japi.TM(s, engine=jeng, seed=i)
        starts.append((jtm.program, jtm.prng))
    B = 6
    data = [_data(s, B, 40 + i) for i, s in enumerate(specs)]
    jbank = japi.stack([p for p, _ in starts], jeng,
                       prngs=[r for _, r in starts])
    bridged = [_bridge(p, r) for p, r in starts]
    tbank = tapi.stack([p for p, _ in bridged], teng,
                       prngs=[r for _, r in bridged])
    jl = jnp.stack([jeng.encode(s, jnp.asarray(d[0]))
                    for s, d in zip(specs, data)])
    tl = torch.stack([teng.encode(_tspec(s), d[0])
                      for s, d in zip(specs, data)])
    labels = np.stack([d[1] for d in data])
    jst = jbank.train(jl, jnp.asarray(labels))
    tst = tbank.train(tl, labels)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    for k in range(len(KINDS)):
        _assert_same(tbank.swap_out(k), tbank.prngs[k],
                     jax.tree.map(lambda t: t[k], jbank.progs),
                     jax.tree.map(lambda t: t[k], jbank.prngs), KINDS[k])
    paths = _paths_agree(teng, jeng)
    assert paths["train_bank_ta"] == "dense"
    assert paths["train_bank_prng"] == f"counter-{teng.ta_prng}"


def test_tm_and_server_run_the_dense_stream_engine():
    """``TM`` and ``TMServer`` on an engine with both forces: the same
    programs, answers and histories as the default engine."""
    from repro_torch.launch.serve_tm import TMServer
    spec = tapi.TMSpec.coalesced(features=30, classes=4, clauses=40, T=12,
                                 prng_backend="lfsr")
    tile = tapi.tile_for(spec)
    base = tapi.compile(tile, device="cpu")
    dense = tapi.compile(tile, device="cpu", kernel_path="mxu",
                         ta_prng="stream")
    x, y = _data(spec, 40, 5)
    tms = [tapi.TM(spec, engine=e, seed=2) for e in (base, dense)]
    hists = [tm.fit(x, y, epochs=2, batch=8, rng=np.random.default_rng(1))
             for tm in tms]
    assert hists[0] == hists[1]
    for a, b in zip(tms[0].program.leaves() + tms[0].prng.leaves(),
                    tms[1].program.leaves() + tms[1].prng.leaves()):
        assert torch.equal(a, b)
    answers = []
    for e, tm in zip((base, dense), tms):
        srv = TMServer(e, batch_slot=8)
        srv.register("a", spec, program=tm.program)
        srv.enqueue("a", x[:8])
        answers.append(srv.flush()["a"])
        answers.append(srv.predict("a", x[8:11]))
    np.testing.assert_array_equal(answers[0], answers[2])
    np.testing.assert_array_equal(answers[1], answers[3])
    assert dense.cache_report()["path_per_stage"]["infer_bank"] == "mxu"
