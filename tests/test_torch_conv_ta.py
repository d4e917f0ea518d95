"""The conv step's TA stage on the CPU: its plain version against the JAX
package, the wrapper's checks, and where the engine runs it (exact).

``conv_ta_update_plain`` (``repro_torch/kernels/conv_ta.py``) is the
engine's torch chain from the patch pick to the new include bitplane.
The port's conv step calls it through the wrapper, so a step must equal
the JAX engine's ``_train_conv_impl``: padded and full patch slots,
padded literals, boost on and off, B = 1 and 3, uint8 and int32 TA
states.  A clause-row window (``row0`` > 0, the full-width draws) must
give the full step's rows.  The wrapper raises on operands the kernels do
not take; ``cache_report()["path_per_stage"]`` names the path.  The
kernels themselves are held against the plain version on the card
(``tests/test_torch_conv_ta_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch.core.dtm import FIELDS, STAT_KEYS
from repro_torch.kernels import conv_ta, ops as tops
from repro_torch.kernels.conv_ta import conv_ta_update, conv_ta_update_plain
from test_torch_conv import (FLAT, TILE, WIDE, _conv, _images, _labels,
                             _port_engine, _start, _tspec)
from test_torch_train import _assert_same

CASES = {                               # spec, batch rows
    "padded": (_conv(), 3),
    "full": (WIDE, 3),
    "b1": (_conv(), 1),
    "no_boost": (_conv(boost_true_positive=False), 3),
    "int32_ta": (_conv(ta_bits=10), 3),
    "int32_ta_full_b1": (japi.TMSpec.conv(5, 7, 2, classes=3, clauses=12,
                                          T=6, ta_bits=10,
                                          prng_backend="lfsr"), 1),
}


@pytest.fixture(scope="module")
def engines():
    """The JAX engine, the port's default and forced-``ref`` engines of one
    geometry (R = 16, L = 32: both conv specs have padded literals; the
    first has padded patch slots)."""
    jeng = japi.compile(japi.tile_for(_conv(), WIDE, FLAT, **TILE),
                        backend="ref")
    return jeng, _port_engine(jeng), _port_engine(jeng, kernel_path="ref")


@pytest.fixture
def calls(monkeypatch):
    """The operands of each call of the wrapper and of the plain version,
    through the names ``ops`` uses."""
    seen = {"conv_ta_update": [], "conv_ta_update_plain": []}

    def spy(name):
        fn = getattr(tops, name)

        def run(*a, **kw):
            seen[name].append((a, kw))
            return fn(*a, **kw)
        return run
    for name in seen:
        monkeypatch.setattr(tops, name, spy(name))
    return seen


def _step(jeng, teng, spec, B, seed):
    """One conv step of a spec on both engines from the same program."""
    jprog, jprng, tprog, tprng = _start(jeng, spec, seed)
    x, y = _images(spec, B, seed + 1), _labels(spec, B, seed + 2)
    jprog, jprng, jst = jeng.train_fn(spec)(
        jprog, jprng, jeng.encode(spec, jnp.asarray(x)), jnp.asarray(y))
    tprog, tprng, tst = teng.train_fn(_tspec(spec))(
        tprog, tprng, teng.encode(_tspec(spec), x), torch.as_tensor(y))
    return (jprog, jprng, jst), (tprog, tprng, tst)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stage_matches_the_jax_conv_step(engines, calls, case):
    jeng, teng, _ = engines
    spec, B = CASES[case]
    (jprog, jprng, jst), (tprog, tprng, tst) = _step(jeng, teng, spec, B,
                                                     seed=len(case))
    assert len(calls["conv_ta_update"]) == 1
    (a, kw), = calls["conv_ta_update"]
    assert kw == {"row0": 0} and a[2].shape[:2] == (1, B)
    assert a[0].dtype == (torch.int32 if spec.ta_bits > 8 else torch.uint8)
    assert {k: int(v) for k, v in tst.items()} == \
        {k: int(jst[k]) for k in STAT_KEYS}
    _assert_same(tprog, tprng, jprog, jprng, case)
    # the step changed TA states, so the stage is not vacuous here
    assert not torch.equal(tprog.ta, _start(jeng, spec, len(case))[2].ta)
    assert teng.cache_report()["path_per_stage"]["train_conv_ta"] == \
        "conv_ta"


@pytest.mark.parametrize("row0,r_loc", [(8, 8), (0, 8), (4, 4), (12, 4)])
def test_a_row_window_gives_the_full_steps_rows(engines, calls, row0,
                                                r_loc):
    """The clause-sharded contract: a window's program rows with the
    full-width draws and ``row0`` give the full step's rows."""
    _, teng, _ = engines
    _step(*engines[:2], _conv(backend="lfsr"), 3, seed=11)
    (a, _), = calls["conv_ta_update"]
    full = conv_ta_update(*a)
    rows = slice(row0, row0 + r_loc)
    win = list(a)
    # program rows: ta, inc, cl_p, cl, sel_lab, sel_neg, weights, cl_mask
    for i, dim in ((0, 1), (1, 1), (3, 3), (4, 2), (5, 2), (6, 2), (7, 2),
                   (13, 1)):
        win[i] = a[i].narrow(dim, row0, r_loc).contiguous()
    got = conv_ta_update(*win, row0=row0)
    assert torch.equal(got[0], full[0][:, rows])
    assert torch.equal(got[1], full[1][:, rows])
    assert torch.equal(conv_ta_update_plain(*win, row0=row0)[0], got[0])


def test_ref_path_runs_the_plain_version_and_records_no_kernel(engines,
                                                               calls):
    jeng, teng, ref = engines
    spec = _tspec(_conv(backend="lfsr"))
    _, _, prog, prng = _start(jeng, _conv(backend="lfsr"), 5)
    x = teng.encode(spec, _images(spec, 3, 6))
    y = torch.as_tensor(_labels(spec, 3, 7))
    want = teng.train_conv(prog, prng, x, y)
    n = len(calls["conv_ta_update"])
    got = ref.train_conv(prog, prng, x, y)
    assert len(calls["conv_ta_update"]) == n
    assert len(calls["conv_ta_update_plain"]) == 1
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    paths = ref.cache_report()["path_per_stage"]
    assert paths["train_conv"] == "ref" and "train_conv_ta" not in paths


def test_cpu_operands_launch_nothing(engines):
    jeng, teng, _ = engines
    spec = _tspec(_conv())
    _, _, prog, prng = _start(jeng, _conv(), 2)
    before = conv_ta.conv_ta_update.launches
    teng.train_conv(prog, prng, teng.encode(spec, _images(spec, 3, 1)),
                    torch.as_tensor(_labels(spec, 3, 2)))
    assert conv_ta.conv_ta_update.launches == before
    assert tops.launch_counts()["conv_ta_update"] == before


def test_flat_step_never_calls_the_conv_stage(engines, calls):
    jeng, teng, _ = engines
    spec = _tspec(FLAT)
    tm = tapi.TM(spec, engine=teng, seed=1)
    x = (np.random.default_rng(0).random((4, FLAT.features)) < 0.5
         ).astype(np.int8)
    teng.train_step(tm.program, tm.prng, teng.encode(spec, x),
                    spec.encode_labels(np.array([0, 1, 2, 1])))
    assert calls == {"conv_ta_update": [], "conv_ta_update_plain": []}


def _operands(K=1, B=2, P=3, R=4, L=40, Wl=2, H=3, Rg=None):
    g = torch.Generator().manual_seed(0)
    Rg = Rg or R
    i32 = dict(dtype=torch.int32)
    return [torch.zeros((K, R, L), dtype=torch.uint8),
            torch.zeros((K, R, -(-L // 32)), **i32),
            torch.zeros((K, B, P, Wl), **i32),
            torch.zeros((K, B, P, R), **i32), torch.zeros((K, B, R), **i32),
            torch.zeros((K, B, R), **i32), torch.zeros((K, B, R), **i32),
            torch.zeros((K, H, R), **i32), torch.zeros((K, B), **i32),
            torch.ones((K, B), **i32),
            torch.randint(0, 1 << 16, (K, B, P, Rg), generator=g),
            torch.randint(0, 1 << 16, (K, 2, B, Rg, L), generator=g),
            torch.ones((K, L), **i32), torch.ones((K, R), **i32),
            torch.full((K,), 6554, **i32), torch.ones(K, dtype=torch.bool),
            torch.full((K,), 256, **i32)]


def test_wrapper_runs_on_zero_feedback_and_keeps_the_states():
    a = _operands()
    a[0] = torch.randint(0, 256, a[0].shape, dtype=torch.uint8)
    new_ta, new_inc = conv_ta_update(*a)
    assert torch.equal(new_ta, a[0]) and new_ta.dtype == torch.uint8
    want = (a[0].to(torch.int32) >= 128).to(torch.int64)
    want = torch.nn.functional.pad(want, (0, 64 - 40)).reshape(1, 4, 2, 32)
    want = (want << torch.arange(32)).sum(-1)
    assert torch.equal(new_inc, torch.where(want >= 2 ** 31, want - 2 ** 32,
                                            want).to(torch.int32))


@pytest.mark.parametrize("what,edit,err", [
    ("ta dtype", lambda a: a.__setitem__(0, a[0].to(torch.int16)),
     TypeError),
    ("draws dtype", lambda a: a.__setitem__(11, a[11].to(torch.int32)),
     TypeError),
    ("boost dtype", lambda a: a.__setitem__(15, a[15].to(torch.int32)),
     TypeError),
    ("cl_p shape", lambda a: a.__setitem__(3, a[3][:, :, :2]), ValueError),
    ("weights shape", lambda a: a.__setitem__(7, a[7][..., :3]),
     ValueError),
    ("draws layout", lambda a: a.__setitem__(
        11, a[11].transpose(3, 4).contiguous().transpose(3, 4)), ValueError),
    ("window past the draws", None, ValueError),
    ("too few literal words", lambda a: a.__setitem__(2, a[2][..., :1]),
     ValueError),
    ("a device without a kernel", lambda a: a.__setitem__(
        slice(None), [t.to("meta") for t in a]), ValueError),
])
def test_wrapper_raises_on_operands_it_does_not_take(what, edit, err):
    a = _operands()
    if edit is None:
        with pytest.raises(err):
            conv_ta_update(*a, row0=1)
        return
    edit(a)
    with pytest.raises(err):
        conv_ta_update(*a)
