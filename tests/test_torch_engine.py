"""Engine-level parity of the PyTorch port with the JAX package (CPU).

The same specs, TA states and weights, made from a seed with numpy, are
lowered by both engines; the programs must agree leaf for leaf and
``infer``/``predict`` must agree exactly, for the four flat kinds, both
clause paths (B <= 4 and B > 4), program banks, and one case through the
JAX engine's interpret-mode Pallas kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi, convert
from repro_torch.core.dtm import FIELDS, DTMEngine
from repro_torch.core.types import TileConfig
from repro_torch.kernels import autotune

_CALIB = np.random.default_rng(42).standard_normal((64, 5)).astype(np.float32)
SPECS = {
    "vanilla": dict(kind="vanilla", features=21, classes=3, clauses=6, T=8),
    "coalesced": dict(kind="coalesced", features=21, classes=4, clauses=24,
                      T=16),
    "regression": dict(kind="regression", features=21, clauses=20, T=12),
    "head": None,   # built from the calibration array below
}
BATCHES = (1, 3, 5, 32)


def _jspec(kind):
    if kind == "head":
        return japi.TMSpec.head(_CALIB, classes=3, therm_bits=3, clauses=16,
                                T=10)
    return japi.TMSpec(**SPECS[kind])


def _tspec(kind):
    return tapi.TMSpec.from_dict(_jspec(kind).to_dict())


def _states(spec, seed):
    """TA states with 0-3 includes per clause row (so clauses fire, and
    some rows are empty), and weights for the coalesced-datapath kinds."""
    cfg = spec.tm_config()
    rng = np.random.default_rng(seed)
    j = cfg.include_threshold
    ta = rng.integers(0, j, (cfg.total_clauses, cfg.literals))
    for r in range(cfg.total_clauses):
        k = rng.integers(0, 4)
        ta[r, rng.choice(cfg.literals, k, replace=False)] = rng.integers(
            j, 2 * j, k)
    w = None
    if spec.kind in ("coalesced", "head"):
        w = rng.integers(-5, 6, (cfg.classes, cfg.clauses))
    return ta.astype(np.int32), (None if w is None else w.astype(np.int32))


def _inputs(spec, B, seed):
    rng = np.random.default_rng(seed)
    if spec.kind == "head":
        return rng.standard_normal((B, _CALIB.shape[1])).astype(np.float32)
    return (rng.random((B, spec.features)) < 0.5).astype(np.int8)


@pytest.fixture(scope="module")
def engines():
    specs = [_jspec(k) for k in SPECS]
    tile = japi.tile_for(*specs, x=32, y=16, m=16, n=4)
    return (japi.compile(tile, backend="ref"),
            tapi.compile(tapi.tile_for(*[_tspec(k) for k in SPECS], x=32,
                                       y=16, m=16, n=4), device="cpu"))


def _lower_both(jeng, teng, kind, seed=0):
    jspec, tspec = _jspec(kind), _tspec(kind)
    ta, w = _states(jspec, seed)
    jprog = jeng.lower(jspec, jax.random.PRNGKey(0), ta=jnp.asarray(ta),
                       weights=None if w is None else jnp.asarray(w))
    return jspec, tspec, jprog, teng.lower(tspec, ta=ta, weights=w)


def _leaves(jprog):
    return {f: np.asarray(getattr(jprog, f)) for f in FIELDS}


@pytest.mark.parametrize("kind", list(SPECS))
def test_lower_matches_jax_leaf_for_leaf(engines, kind):
    jeng, teng = engines
    assert dataclasses.asdict(teng.tile) == dataclasses.asdict(jeng.tile)
    assert teng.W == jeng.W
    _, _, jprog, tprog = _lower_both(jeng, teng, kind)
    got = convert.program_to_numpy(tprog)
    for f, want in _leaves(jprog).items():
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    # refresh_include rebuilds the same bitplane from the TA states
    np.testing.assert_array_equal(
        teng.refresh_include(tprog).inc.numpy(), tprog.inc.numpy())


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kind", list(SPECS))
def test_infer_predict_match_jax(engines, kind, B):
    jeng, teng = engines
    jspec, tspec, jprog, tprog = _lower_both(jeng, teng, kind, seed=B)
    x = _inputs(jspec, B, seed=B + 1)
    jl = jeng.encode(jspec, jnp.asarray(x))
    tl = teng.encode(tspec, x)
    np.testing.assert_array_equal(tl.numpy().view(np.uint32), np.asarray(jl))
    if kind != "head":
        np.testing.assert_array_equal(
            teng.pad_features(x).numpy().view(np.uint32),
            np.asarray(jeng.pad_features(jnp.asarray(x))))
    js, jc = jeng.infer(jprog, jl)
    ts, tc = teng.infer(tprog, tl)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(teng.predict(tprog, tl).numpy(),
                                  np.asarray(jeng.predict(jprog, jl)))
    np.testing.assert_array_equal(
        tspec.decode_output(ts, tc).numpy(),
        np.asarray(jspec.decode_output(js, jc)))
    # the seed plan's choice at the engine's padded shape
    want = autotune.planned_path("eval", B, (teng.L, teng.R, teng.H),
                                 device="cpu")
    assert want == "packed_vpu" or B > 4
    assert teng.cache_report()["path_per_stage"]["infer"] == want


def test_some_clauses_fire_and_predictions_vary(engines):
    """The parity cases above are not vacuous."""
    jeng, teng = engines
    _, tspec, _, tprog = _lower_both(jeng, teng, "coalesced", seed=32)
    sums, cl = teng.infer(tprog, teng.encode(tspec, _inputs(tspec, 32, 33)))
    assert 0 < cl.sum() < cl.numel()
    assert len(torch.unique(torch.argmax(sums, -1))) > 1


@pytest.mark.parametrize("B", [1, 8])
def test_infer_matches_jax_interpret_kernels(B):
    """One case through the JAX engine's Pallas kernels (interpret mode)."""
    jspec = _jspec("coalesced")
    tile = japi.tile_for(jspec, x=32, y=16, m=16, n=4)
    jeng = japi.compile(tile, backend="kernel")
    teng = tapi.compile(TileConfig(**dataclasses.asdict(tile)), device="cpu")
    ta, w = _states(jspec, 5)
    jprog = jeng.lower(jspec, jax.random.PRNGKey(0), ta=jnp.asarray(ta),
                       weights=jnp.asarray(w))
    tprog = convert.program_from_numpy(_leaves(jprog), device="cpu")
    x = _inputs(jspec, B, 6)
    js, jc = jeng.infer(jprog, jeng.encode(jspec, jnp.asarray(x)))
    ts, tc = teng.infer(tprog, teng.encode(_tspec("coalesced"), x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("B", [2, 16])
def test_bank_matches_jax_bank(engines, B):
    jeng, teng = engines
    kinds = ["coalesced", "vanilla", "regression", "head"]
    both = [_lower_both(jeng, teng, k, seed=i) for i, k in enumerate(kinds)]
    jbank = japi.stack([b[2] for b in both], jeng)
    tbank = tapi.stack([b[3] for b in both], teng)
    jl = [jeng.encode(b[0], jnp.asarray(_inputs(b[0], B, i)))
          for i, b in enumerate(both)]
    tl = [teng.encode(b[1], _inputs(b[1], B, i)) for i, b in enumerate(both)]
    js, jc = jbank.infer(jnp.stack(jl))
    ts, tc = tbank.infer(torch.stack(tl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for got, want in zip(tbank.predict(tl), jbank.predict(jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a bank equals K single-program runs
    for k, b in enumerate(both):
        s1, c1 = teng.infer(b[3], tl[k])
        np.testing.assert_array_equal(ts[k].numpy(), s1.numpy())
    assert tbank.nbytes == sum(b[3].nbytes for b in both)


def test_bank_swap_out_is_a_copy(engines):
    jeng, teng = engines
    progs = [_lower_both(jeng, teng, "coalesced", seed=s)[3] for s in (1, 2)]
    bank = tapi.stack(progs, teng)
    out = bank.swap_out(0)
    before = convert.program_to_numpy(out)
    bank.swap_in(0, progs[1])
    for f, a in convert.program_to_numpy(out).items():
        np.testing.assert_array_equal(a, before[f], err_msg=f)
    for f, a in convert.program_to_numpy(bank.swap_out(0)).items():
        np.testing.assert_array_equal(
            a, convert.program_to_numpy(progs[1])[f], err_msg=f)
    assert len(bank.unstack()) == 2


def test_argmax_ties_pick_the_first_class(engines):
    """All-zero sums (no clause fires) predict class 0, as in JAX; a tie
    between two classes picks the lower index."""
    jeng, teng = engines
    jspec, tspec = _jspec("coalesced"), _tspec("coalesced")
    cfg = jspec.tm_config()
    ta = np.zeros((cfg.total_clauses, cfg.literals), np.int32)  # all empty
    w = np.zeros((cfg.classes, cfg.clauses), np.int32)
    x = _inputs(jspec, 6, 0)
    jprog = jeng.lower(jspec, jax.random.PRNGKey(0), ta=jnp.asarray(ta),
                       weights=jnp.asarray(w))
    want = np.asarray(jeng.predict(jprog, jeng.encode(jspec, jnp.asarray(x))))
    got = teng.predict(teng.lower(tspec, ta=ta, weights=w),
                       teng.encode(tspec, x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    sums = torch.tensor([[0, 3, 3, -1], [5, 5, 5, 5]], dtype=torch.int32)
    np.testing.assert_array_equal(
        tspec.decode_output(sums, None).numpy(),
        np.asarray(jspec.decode_output(jnp.asarray(sums.numpy()), None)))


def test_forced_kernel_path_gives_the_same_answer(engines):
    jeng, teng = engines
    _, tspec, _, tprog = _lower_both(jeng, teng, "coalesced", seed=3)
    lits = teng.encode(tspec, _inputs(tspec, 2, 4))
    forced = DTMEngine(teng.tile, device="cpu", kernel_path="mxu_popcount")
    a, b = teng.infer(tprog, lits), forced.infer(tprog, lits)
    assert forced.cache_report()["path_per_stage"]["infer"] == "mxu_popcount"
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    plain = DTMEngine(teng.tile, device="cpu", kernel_path="ref")
    for x, y in zip(a, plain.infer(tprog, lits)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert plain.cache_report()["path_per_stage"]["infer"] == "ref"
    with pytest.raises(ValueError):
        DTMEngine(teng.tile, device="cpu", kernel_path="vpu")


def test_convert_round_trip_keeps_dtypes(engines):
    jeng, teng = engines
    _, _, jprog, _ = _lower_both(jeng, teng, "head")
    leaves = _leaves(jprog)
    prog = convert.program_from_numpy(leaves, device="cpu")
    assert prog.inc.dtype == torch.int32 and prog.ta.dtype == torch.uint8
    assert prog.T.dim() == 0
    back = convert.program_to_numpy(prog)
    for f, a in leaves.items():
        assert back[f].dtype == a.dtype and back[f].shape == a.shape, f
        np.testing.assert_array_equal(back[f], a)
    with pytest.raises(KeyError):
        convert.program_from_numpy({"ta": leaves["ta"]}, device="cpu")


def test_spec_json_crosses_both_ways():
    for kind in SPECS:
        j = _jspec(kind)
        t = tapi.TMSpec.from_dict(j.to_dict())
        back = japi.TMSpec.from_dict(t.to_dict())
        assert back.tm_config() == j.tm_config()
        assert t.tm_config().total_clauses == j.tm_config().total_clauses


def test_estimator_lowers_invariants_and_scores():
    spec = tapi.TMSpec.coalesced(features=12, classes=3, clauses=16)
    tm = tapi.TM(spec, device="cpu", seed=3)
    cfg = spec.tm_config()
    ta = tm.program.ta[:cfg.total_clauses].to(torch.int32)
    j = cfg.include_threshold
    real = tm.program.l_mask.bool()
    assert set(torch.unique(ta[:, real]).tolist()) <= {j - 1, j}
    w = tm.program.weights[:cfg.classes, :cfg.clauses]
    assert set(torch.unique(w).tolist()) <= {-1, 1}
    same = tapi.TM(spec, device="cpu", seed=3).program
    assert torch.equal(same.ta, tm.program.ta)
    x = (np.random.default_rng(0).random((40, 12)) < 0.5).astype(np.int8)
    y = np.zeros(40, np.int32)
    preds = tm.predict(x)
    assert preds.shape == (40,)
    assert tm.score(x, y, batch=16) == float((preds.numpy() == 0).mean())
    assert tm.class_sums(x[:3]).shape == (3, tm.engine.H)
    reg = tapi.TM(tapi.TMSpec.regression(features=12, clauses=8), device="cpu")
    assert reg.score(x, np.zeros(40), batch=16) <= 0.0


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is legitimate")
    tile = tapi.tile_for(tapi.TMSpec.coalesced(features=8, classes=2))
    with pytest.raises(RuntimeError):
        tapi.compile(tile)
    with pytest.raises(RuntimeError):
        DTMEngine(tile, device="cuda")
    with pytest.raises(RuntimeError):
        tapi.TM(tapi.TMSpec.coalesced(features=8, classes=2))
    with pytest.raises(RuntimeError):
        convert.program_from_numpy(
            _leaves(japi.compile(tile, backend="ref").lower(
                japi.TMSpec.coalesced(features=8, classes=2),
                jax.random.PRNGKey(0))))
