"""The train step's glue kernels' plain versions against the JAX package,
and the engine's choice of path (CPU, exact).

``step_prologue_plain`` and ``step_epilogue_plain``
(``repro_torch/kernels/step_glue.py``) are the engine's torch glue around
the front half.  Here they run on the values of one JAX step (its draws,
its front half's outputs, its program) and must give what the JAX engine
computes inline in ``_train_impl``: the classes, the TA seed, the TA
update's operands, the nudged weights and the stats; a bank that mixes
classifier, Vanilla (frozen) and regression programs must give each
program's own.  The path tests pin where the kernels run: once each a
step on the fused path, never on the clause-sharded, conv or ``ref``
paths.  The kernels themselves are held against these plain versions on
the card (``tests/test_torch_step_glue_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api as tapi, convert
from repro_torch.core.booleanize import unpack_literals
from repro_torch.core import dtm as tdtm
from repro_torch.core.dtm import FIELDS, STAT_KEYS, Shard, StepStats, _one
from repro_torch.kernels import ops as tops, step_glue
from repro_torch.kernels.step_glue import (GROUP, N_STATS, active_groups,
                                           epilogue_geometry,
                                           step_epilogue_plain,
                                           step_prologue_plain)
from test_torch_prng import jax_prng_numpy

SPECS = {
    "coalesced": dict(kind="coalesced", features=21, classes=4, clauses=200,
                      T=16),
    "vanilla": dict(kind="vanilla", features=21, classes=3, clauses=40,
                    T=8),
    "regression": dict(kind="regression", features=21, clauses=150, T=12),
}


def _jspec(kind, backend="counter"):
    kw = dict(SPECS[kind])
    return japi.TMSpec(prng_backend=backend, **kw)


@pytest.fixture(scope="module")
def engines():
    """One JAX engine (ref backend) and one port engine of a geometry that
    fits every kind: R = 256, two 128-row groups."""
    specs = [_jspec(k) for k in SPECS]
    tile = japi.tile_for(*specs, x=32, y=128, m=128, n=4)
    ttile = tapi.tile_for(*(tapi.TMSpec.from_dict(s.to_dict())
                            for s in specs), x=32, y=128, m=128, n=4)
    return japi.compile(tile, backend="ref"), tapi.compile(ttile,
                                                           device="cpu")


def _data(spec, B, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, spec.features)) < 0.5).astype(np.int8)
    if spec.kind == "regression":
        return x, rng.random(B).astype(np.float32)
    return x, rng.integers(0, spec.classes, B).astype(np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jax_step(jeng, kind, B, seed, monkeypatch):
    """One JAX train step of a fresh ``kind`` program with its values
    recorded: the draws' consumers, the front half's outputs, the TA
    update's operands and the weights and stats."""
    jspec = _jspec(kind)
    jtm = japi.TM(jspec, engine=jeng, seed=seed)
    prog, prng = jtm.program, jtm.prng
    x, y = _data(jspec, B, seed + 11)
    plits = jeng.encode(jspec, jnp.asarray(x))
    labels = jspec.encode_labels(jnp.asarray(y))
    rec = {}
    front = jeng._train_front
    was = jeng._weights_and_stats

    def rec_front(prog_, plits_, lits_, cls_lab, neg, sel_rand, **kw):
        out = front(prog_, plits_, lits_, cls_lab, neg, sel_rand, **kw)
        rec.update(cls_lab=cls_lab, neg=neg, sel_rand=sel_rand, front=out)
        return out

    def rec_ta(fn):
        def run(ta, lit2, cl2, t1, t2, *a, **kw):
            rec.update(lit2=lit2, cl2=cl2, t1=t1, t2=t2, seed=kw["seed"])
            return fn(ta, lit2, cl2, t1, t2, *a, **kw)
        return run

    def rec_was(prog_, cl, sel_lab, sel_neg, lab, neg, correct, abs_err):
        new_w, stats = was(prog_, cl, sel_lab, sel_neg, lab, neg, correct,
                           abs_err)
        rec.update(new_w=new_w, stats=stats)
        return new_w, stats

    monkeypatch.setattr(jeng, "_train_front", rec_front)
    monkeypatch.setattr(jeng, "_weights_and_stats", rec_was)
    monkeypatch.setattr(jops, "ta_update_compact_op",
                        rec_ta(jops.ta_update_compact_op))
    monkeypatch.setattr(jops, "ta_update_op", rec_ta(jops.ta_update_op))
    jeng._train_impl(prog, prng, plits, labels)
    monkeypatch.undo()
    tprog = convert.program_from_numpy(
        {f: np.asarray(getattr(prog, f)) for f in FIELDS}, device="cpu")
    tprng = convert.prng_from_numpy(jax_prng_numpy(prng), device="cpu")
    return dict(rec, tprog=tprog, tprng=tprng, plits=_t(plits, torch.int32),
                labels=_t(labels, torch.int32))


def _draws(teng, tprng, B):
    """The port's draws of a step from the bridged PRNG, in the engine's
    order (bank form, K = 1)."""
    r = tprng.map(lambda t: t[None])
    r, c_rand = r.bits((B,))
    r, sel_rand = r.bits((2, B, teng.R))
    r, seed_bits = r.bits((2,))
    return c_rand, seed_bits, sel_rand


def _prologue(teng, rec, B):
    c_rand, seed_bits, sel_rand = _draws(teng, rec["tprng"], B)
    p = rec["tprog"]
    return step_prologue_plain(rec["labels"][None], c_rand, seed_bits,
                               sel_rand, p.h_mask[None],
                               p.regression[None], rand_bits=teng.rand_bits)


def _epilogue_args(teng, rec, pro):
    labels, cls_lab, neg, _, sel_rand = pro
    p = rec["tprog"]
    cl, sums, sel_lab, sel_neg = (_t(a, torch.int32)[None]
                                  for a in rec["front"])
    return (rec["plits"][None], cl, sums, sel_lab, sel_neg, sel_rand,
            labels, cls_lab, neg, p.weights[None], p.cl_mask[None],
            p.w_frozen[None], p.w_clip[None], p.T[None],
            p.regression[None])


def _groups_np(t1, t2, group=GROUP):
    """The Alg-6 group list of JAX's feedback, in numpy."""
    rows = ((np.asarray(t1) > 0) | (np.asarray(t2) > 0)).any(axis=0)
    G = -(-rows.shape[0] // group)
    rows = np.concatenate([rows, np.zeros(G * group - rows.shape[0], bool)])
    act = [g for g in range(G) if rows[g * group:(g + 1) * group].any()]
    return np.array(act + [0] * (G - len(act)), np.int32), len(act)


@pytest.mark.parametrize("B", [1, 5, 32])
@pytest.mark.parametrize("kind", list(SPECS))
def test_plain_glue_matches_jax_step(engines, kind, B, monkeypatch):
    jeng, teng = engines
    rec = _jax_step(jeng, kind, B, seed=B + 3, monkeypatch=monkeypatch)
    pro = _prologue(teng, rec, B)
    labels, cls_lab, neg, ta_seed, sel_rand = pro
    assert labels.dtype == cls_lab.dtype == neg.dtype == torch.int32
    assert sel_rand.dtype == torch.int32
    np.testing.assert_array_equal(cls_lab[0], np.asarray(rec["cls_lab"]))
    np.testing.assert_array_equal(neg[0], np.asarray(rec["neg"]))
    np.testing.assert_array_equal(sel_rand[0], np.asarray(rec["sel_rand"]))
    assert int(ta_seed[0]) == int(rec["seed"])

    lit2, cl2, t1, t2, idx, count, new_w, stats = step_epilogue_plain(
        *_epilogue_args(teng, rec, pro), y=teng.tile.y,
        rand_bits=teng.rand_bits)
    np.testing.assert_array_equal(unpack_literals(lit2, teng.L)[0],
                                  np.asarray(rec["lit2"]))
    for name, got in (("cl2", cl2), ("t1", t1), ("t2", t2)):
        np.testing.assert_array_equal(got[0], np.asarray(rec[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(new_w[0], np.asarray(rec["new_w"]))
    assert stats.shape == (N_STATS, 1)
    assert {k: int(stats[i, 0]) for i, k in enumerate(STAT_KEYS)} == \
        {k: int(v) for k, v in rec["stats"].items()}
    want_idx, want_count = _groups_np(rec["t1"], rec["t2"])
    np.testing.assert_array_equal(idx[0], want_idx)
    assert int(count[0]) == want_count


def test_plain_glue_of_a_mixed_bank_is_per_program(engines, monkeypatch):
    """A bank of a classifier, a Vanilla (frozen weights) and a regression
    program: the bank's glue gives each program the JAX step's values."""
    jeng, teng = engines
    B = 8
    recs = [_jax_step(jeng, kind, B, seed=20 + i, monkeypatch=monkeypatch)
            for i, kind in enumerate(SPECS)]
    pros = [_prologue(teng, r, B) for r in recs]
    bank_pro = [torch.cat(parts) for parts in zip(*pros)]
    singles = [_epilogue_args(teng, r, p) for r, p in zip(recs, pros)]
    bank_args = [torch.cat(parts) for parts in zip(*singles)]
    # the bank's prologue on the stacked draws and program leaves
    draws = [_draws(teng, r["tprng"], B) for r in recs]
    c_rand, seed_bits, sel_rand = (torch.cat(d) for d in zip(*draws))
    got_pro = step_prologue_plain(
        torch.stack([r["labels"] for r in recs]), c_rand, seed_bits,
        sel_rand, torch.stack([r["tprog"].h_mask for r in recs]),
        torch.stack([r["tprog"].regression for r in recs]),
        rand_bits=teng.rand_bits)
    for a, b in zip(got_pro, bank_pro):
        assert torch.equal(a, b)
    out = step_epilogue_plain(*bank_args, y=teng.tile.y,
                              rand_bits=teng.rand_bits)
    lit2, cl2, t1, t2, idx, count, new_w, stats = out
    assert bool(recs[1]["tprog"].w_frozen)
    for k, rec in enumerate(recs):
        for name, got in (("cl2", cl2), ("t1", t1), ("t2", t2)):
            np.testing.assert_array_equal(got[k], np.asarray(rec[name]),
                                          err_msg=f"{k} {name}")
        np.testing.assert_array_equal(new_w[k], np.asarray(rec["new_w"]))
        assert {s: int(stats[i, k]) for i, s in enumerate(STAT_KEYS)} == \
            {s: int(v) for s, v in rec["stats"].items()}
        want_idx, want_count = _groups_np(rec["t1"], rec["t2"])
        np.testing.assert_array_equal(idx[k], want_idx)
        assert int(count[k]) == want_count


def test_active_groups_is_reexported_by_ops():
    assert tops.active_groups is active_groups
    t1 = torch.zeros((2, 4, 300), dtype=torch.int32)
    t2 = torch.zeros_like(t1)
    t1[0, 1, 260] = 1
    t2[1, 3, 5] = 1
    t2[1, 0, 200] = 1
    idx, count = active_groups(t1, t2)
    assert idx.tolist() == [[2, 0, 0], [0, 1, 0]] and count.tolist() == [1, 2]


@pytest.mark.parametrize("R,want", [(1, 1), (128, 1), (129, 2), (256, 2),
                                    (2048, 16), (4224, 16), (8192, 16)])
def test_epilogue_geometry(R, want):
    assert epilogue_geometry(R) == want


def test_epilogue_rejects_bad_operands(engines, monkeypatch):
    jeng, teng = engines
    rec = _jax_step(jeng, "coalesced", 4, seed=5, monkeypatch=monkeypatch)
    args = list(_epilogue_args(teng, rec, _prologue(teng, rec, 4)))
    with pytest.raises(ValueError, match="whole groups"):
        step_glue.step_epilogue(*args, y=96)
    bad = list(args)
    bad[1] = args[1][:, :, :-1]
    with pytest.raises(ValueError, match="sel_lab"):
        step_glue.step_epilogue(*bad)
    with pytest.raises(ValueError, match="regression"):
        step_glue.step_prologue(args[6], torch.zeros((1, 4), dtype=torch.int64),
                                torch.zeros((1, 2), dtype=torch.int64),
                                args[5].to(torch.int64), args[9][:, :, 0],
                                args[14][:0])


def test_step_stats_view_one_row():
    row = torch.arange(2 * N_STATS, dtype=torch.int32).reshape(N_STATS, 2)
    st = StepStats(row)
    assert list(st) == list(STAT_KEYS)
    assert st["correct"].tolist() == row[3].tolist()
    one = st.program(1)
    assert one.row.tolist() == row[:, 1].tolist()
    assert {k: int(v) for k, v in one.items()} == \
        dict(zip(STAT_KEYS, row[:, 1].tolist()))


# --------------------------------------------------------------------- #
# where the kernels run                                                 #
# --------------------------------------------------------------------- #
@pytest.fixture
def spies(monkeypatch):
    """Calls of the two glue wrappers, through the names the ops use."""
    calls = {"step_prologue": 0, "step_epilogue": 0}

    def spy(name):
        fn = getattr(tops, name)

        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for name in calls:
        monkeypatch.setattr(tops, name, spy(name))
    return calls


def _tm(kind, engine, seed=1):
    spec = tapi.TMSpec.from_dict(_jspec(kind, "lfsr").to_dict())
    tm = tapi.TM(spec, engine=engine, seed=seed)
    x, y = _data(spec, 32, seed)
    return (spec, tm.program, tm.prng, engine.encode(spec, x),
            spec.encode_labels(y))


@pytest.mark.parametrize("kind", ["coalesced", "regression"])
def test_fused_path_calls_each_glue_wrapper_once_a_step(engines, spies,
                                                        kind):
    _, teng = engines
    _, prog, prng, lits, labels = _tm(kind, teng)
    for s in range(3):
        prog, prng, stats = teng.train_step(prog, prng, lits, labels)
        assert spies == {"step_prologue": s + 1, "step_epilogue": s + 1}
    assert teng.cache_report()["path_per_stage"]["train"] == "fused"
    assert isinstance(stats, StepStats) and stats.row.shape == (N_STATS,)


def test_bank_step_calls_each_glue_wrapper_once(engines, spies):
    _, teng = engines
    parts = [_tm(kind, teng, seed=i) for i, kind in enumerate(SPECS)]
    progs = tdtm.DTMProgram(*(torch.stack(ls) for ls in zip(
        *(p[1].leaves() for p in parts))))
    prngs = type(parts[0][2]).stack([p[2] for p in parts])
    lits = torch.stack([p[3] for p in parts])
    labels = torch.stack([p[4].to(torch.int32) for p in parts])
    _, _, stats = teng.train_bank(progs, prngs, lits, labels)
    assert spies == {"step_prologue": 1, "step_epilogue": 1}
    assert stats.row.shape == (N_STATS, len(SPECS))


def test_ref_path_runs_the_plain_glue(engines, spies):
    _, teng = engines
    ref = tapi.compile(teng.tile, device="cpu", kernel_path="ref")
    _, prog, prng, lits, labels = _tm("coalesced", ref)
    want = teng.train_step(prog, prng, lits, labels)
    spies.update(step_prologue=0, step_epilogue=0)
    got = ref.train_step(prog, prng, lits, labels)
    assert spies == {"step_prologue": 0, "step_epilogue": 0}
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[2].row, want[2].row)


def test_sharded_path_runs_the_plain_glue(engines, spies, monkeypatch):
    """The clause-sharded body on one rank (its collectives the identity)
    never calls the glue kernels' wrappers and trains as the unsharded
    step does."""
    _, teng = engines
    _, prog, prng, lits, labels = _tm("regression", teng)
    want = teng.train_step(prog, prng, lits, labels)
    spies.update(step_prologue=0, step_epilogue=0)
    monkeypatch.setattr(tdtm, "all_sum", lambda t, group: t)
    monkeypatch.setattr(tdtm, "gather_dim", lambda t, group, dim: t)
    shard = Shard(None, "clauses", 1, 0, teng.R)
    new, _, stats = teng._train_impl(
        _one(prog), prng.map(lambda t: t[None]), lits[None],
        labels[None].to(torch.int32), lanes=1, stage="train_sharded",
        shard=shard)
    assert spies == {"step_prologue": 0, "step_epilogue": 0}
    for f in FIELDS:
        assert torch.equal(getattr(new, f)[0], getattr(want[0], f)), f
    assert torch.equal(stats.program(0).row, want[2].row)


def test_conv_path_never_calls_the_glue(spies):
    spec = tapi.TMSpec.conv(img_h=6, img_w=6, patch=3, classes=3,
                            clauses=16, T=8, prng_backend="lfsr")
    eng = tapi.compile(tapi.tile_for(spec), device="cpu")
    tm = tapi.TM(spec, engine=eng, seed=2)
    x = (np.random.default_rng(0).random((4, 6, 6)) < 0.5).astype(np.int8)
    y = np.array([0, 1, 2, 1], np.int32)
    _, _, stats = eng.train_conv(tm.program, tm.prng, eng.encode(spec, x),
                                 spec.encode_labels(y))
    assert spies == {"step_prologue": 0, "step_epilogue": 0}
    assert isinstance(stats, StepStats) and stats.row.shape == (N_STATS,)


def test_conv_path_takes_the_plain_weights_from_ops(monkeypatch):
    """The conv step's nudges and stats are the plain glue's, reached
    through the ops module like every other glue call."""
    calls = []
    fn = tops.weights_and_stats_plain
    assert fn is step_glue.weights_and_stats_plain
    monkeypatch.setattr(tops, "weights_and_stats_plain",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    spec = tapi.TMSpec.conv(img_h=6, img_w=6, patch=3, classes=3,
                            clauses=16, T=8, prng_backend="lfsr")
    eng = tapi.compile(tapi.tile_for(spec), device="cpu")
    tm = tapi.TM(spec, engine=eng, seed=2)
    x = (np.random.default_rng(0).random((4, 6, 6)) < 0.5).astype(np.int8)
    eng.train_conv(tm.program, tm.prng, eng.encode(spec, x),
                   spec.encode_labels(np.array([0, 1, 2, 1], np.int32)))
    assert calls == [1]


def test_epilogue_op_takes_collectives_only_plain():
    """One switch: the sharded step's collectives go with ``plain``."""
    with pytest.raises(ValueError, match="plain=True"):
        tops.step_epilogue_op(*[None] * 15, vote_sum=lambda v: v)
    with pytest.raises(ValueError, match="plain=True"):
        tops.step_epilogue_op(*[None] * 15, gather=lambda t: t)


@pytest.mark.parametrize("H", [65, 100, 2048])
def test_epilogue_past_max_classes_takes_the_wide_kernel(H):
    """More classes than the cluster kernel's sign masks hold take the
    wide kernel (decided without the card)."""
    assert step_glue.MAX_CLASSES == 64
    assert step_glue.epilogue_wide(32, H, 2048, 128, "cpu") is True
