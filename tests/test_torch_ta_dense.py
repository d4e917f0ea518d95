"""The dense and streamed TA updates on the one kernel body: what the CPU
can check (exact).

* The dense and streamed wrappers take every per-program scalar form that
  ``scalar_spec`` takes (int64, int32, bool and other tensors; 0-d, [1],
  [K]; ints; uint32 values at or above 2^31) and give the JAX oracle's
  states (CPU route), and ``scalar_spec`` reads those forms as the same
  values (what the kernel reads).
* Their host work for a launch (library lookup and SM count stubbed): the
  engine's int32 feedback and other operands go to the kernel as the
  same tensors, no [K, 5] scalar block is built, the grid lists every
  group, and 2B runs past the first dense kernel's 12·2B ≤ 48 KB limit.
* The plain ``ta_update_streamed`` (what the card's kernel is held
  against) equals the JAX interpret-mode Pallas kernel at 2B = 66 with
  int32 states, without boost, on words at and either side of p_ta.
* ``TMSpec.to_bool`` runs on the card unless the caller asks for the CPU.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ta_update import ta_update_streamed as j_ta_update_streamed
from test_torch_redesign import _old_params, scalar_values
from test_torch_train_kernels import P_TA, STREAMS, _ta_inputs
from repro_torch import api as tapi
from repro_torch.core.booleanize import pack_literals
from repro_torch.kernels import clause_eval as ce
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ta_update as tu

K, B2, C, L = 3, 10, 45, 70
BIG = [2 ** 31 + 5, 2 ** 32 - 1, 2 ** 31]


def _bank(B2_, C_, L_, ta_bits, seed=0):
    """K programs' operands from ``_ta_inputs``: numpy per program, and
    the port's stacked tensors (packed literals)."""
    parts = [_ta_inputs(seed + k, B2_, C_, L_, ta_bits) for k in range(K)]
    stack = [torch.from_numpy(np.stack([p[i] for p in parts]))
             for i in range(6)]
    stack[1] = pack_literals(stack[1])
    return parts, stack


def _forms(case):
    """(seed, p_ta, boost, n_states, row0) in one of the scalar forms."""
    if case == "tensors":
        return (torch.tensor(BIG), torch.tensor([6554, 2 ** 16, 7],
                                                dtype=torch.int32),
                torch.tensor([True, False, True]),
                torch.tensor([1024, 512, 1024]),
                torch.tensor([0, 5, 300]))
    if case == "zero_d":
        return (torch.tensor(BIG[0]), torch.tensor(6554, dtype=torch.int32),
                torch.tensor(False), torch.tensor(1024, dtype=torch.int16),
                torch.tensor(7, dtype=torch.uint8))
    if case == "ints":
        return BIG[1], 6554, True, 1024, 2 ** 31 + 3
    if case == "int32_bits":        # uint32 values as their int32 bits
        return (torch.tensor(BIG).sub(2 ** 32).to(torch.int32),
                torch.tensor([-1, 6554, 0], dtype=torch.int32),
                torch.tensor([1, 0, 2], dtype=torch.int8),
                torch.tensor([1024, 256, 1024], dtype=torch.int32), 0)
    return (torch.tensor([BIG[0]]), torch.tensor([6554]),
            torch.tensor([True]), torch.tensor([1024]), torch.tensor([9]))


@pytest.mark.parametrize("case", ["tensors", "zero_d", "ints", "int32_bits",
                                  "one_elem"])
@pytest.mark.parametrize("kind", ["dense", "streamed"])
def test_wrappers_take_every_scalar_form(case, kind):
    parts, stack = _bank(B2, C, L, 10, seed=len(case))
    forms = _forms(case)
    want = _old_params(K, *forms).expand(K, 5)    # uint32 values per program
    for x, col in zip(forms, want.t()):           # what the kernel reads
        assert torch.equal(scalar_values(tu.scalar_spec(x, K, "cpu"), K),
                           col)
    kw = STREAMS["lfsr24"]
    if kind == "streamed":
        gen = np.random.default_rng(5)
        words = gen.integers(0, 2 ** 32, (K, B2, C, L), dtype=np.uint64)
        words[..., ::3] &= 0xFFFF                 # and some 16-bit words
        rands = torch.from_numpy(words.astype(np.uint32).view(np.int32))
        new_ta, new_inc = tu.ta_update_streamed(*stack, rands, *forms[1:4])
    else:
        new_ta, new_inc = tu.ta_update(*stack, *forms, **kw)
    assert new_ta.dtype == torch.int32
    for k, (ta, lits, cl, t1, t2, l_mask, _) in enumerate(parts):
        seed, p_ta, boost, n, row0 = (int(v) for v in want[k])
        extra = (dict(rands=jnp.asarray(rands[k].numpy().view(np.uint32)))
                 if kind == "streamed" else
                 dict(row_idx=jnp.asarray(
                     (row0 + np.arange(C)) % 2 ** 32, jnp.uint32), **kw))
        ref = np.asarray(jref.ta_update_ref(
            jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
            jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
            jnp.uint32(seed), jnp.uint32(p_ta), 16, bool(boost), n, **extra))
        np.testing.assert_array_equal(new_ta[k].numpy(), ref)
        np.testing.assert_array_equal(
            new_inc[k].numpy().view(np.uint32),
            np.asarray(jref.pack_include(jnp.asarray(ref), n)))


@pytest.fixture
def host_launch(monkeypatch):
    """``prepare_*`` on CPU tensors with the library lookup and the SM
    count stubbed: the host work of a launch, without the launch.  The
    plain versions' [K, 5] scalar block must not be built."""
    monkeypatch.setattr(tu._build, "entry", lambda *a: (None, None))
    monkeypatch.setattr(ce, "sm_count", lambda index: 132)

    def no_block(*a, **kw):
        raise AssertionError("a kernel launch built the [K, 5] block")
    monkeypatch.setattr(tu, "_params", no_block)


def _engine_operands(B2_, C_, L_):
    """Operands in the engine's dtypes: uint8 states, int32 words,
    feedback and l_mask, int64/bool/int32 per-program scalars."""
    _, (ta, lits, cl, t1, t2, l_mask) = _bank(B2_, C_, L_, 8)
    fb = [t.to(torch.int32) for t in (cl, t1, t2)]
    scal = (torch.tensor(BIG), torch.full((K,), P_TA),
            torch.tensor([True, False, True]),
            torch.full((K,), 256, dtype=torch.int32))
    return (ta, lits, *fb, l_mask.to(torch.int32).contiguous()), scal


@pytest.mark.parametrize("kind", ["dense", "streamed"])
def test_launch_takes_engine_operands_as_they_are(host_launch, kind):
    ops_, scal = _engine_operands(20, 300, 100)
    if kind == "dense":
        launch, (out, inc) = tu.prepare_ta_update(
            *ops_, *scal, row0=torch.tensor(7), **STREAMS["lfsr4"])
        rec_at, blocks = 6, launch.args[-1]
        refresh = launch.args[-4]
    else:
        rands = torch.zeros((K, 20, 300, 100), dtype=torch.int32)
        launch, (out, inc) = tu.prepare_ta_update_streamed(*ops_, rands,
                                                           *scal[1:])
        rec_at, blocks = 6, launch.args[-1]
        assert launch.args[7] == rands.data_ptr()
    # every operand is the caller's tensor, in the kernel's argument order
    for i, t in enumerate(ops_):
        assert any(k is t for k in launch.keep)
        assert launch.args[i] == t.data_ptr()
    assert out.shape == ops_[0].shape and out.dtype == torch.uint8
    assert inc.shape == (K, 300, 4) and inc.dtype == torch.int32
    # every group: 3 groups × 32 row quads × 1 step of 4 word chunks
    assert blocks == tu.sparse_blocks(3, 300, 4, 132) == 3 * 32
    recs = ctypes.cast(launch.args[rec_at],
                       ctypes.POINTER(tu._Scalar * 5)).contents
    if kind == "dense":
        assert refresh == 1                       # 2B = 20 >= 2^4 - 1
        assert recs[4].ptr is not None and recs[4].stride == 0
        want = (scal[0], scal[1], scal[2], scal[3])
    else:                                         # seed and row0 unused
        assert recs[0].ptr is None and recs[4].ptr is None
        want = (None, scal[1], scal[2], scal[3])
    for rec, t in zip(recs, want):
        if t is not None:
            assert rec.ptr == t.data_ptr()
            assert rec.bytes == t.element_size() and rec.stride == 1


@pytest.mark.parametrize("kind", ["dense", "streamed"])
def test_launch_takes_2b_past_the_first_kernels_limit(host_launch, kind):
    """The first dense kernel kept 12 bytes a batch row in shared memory
    (2B ≤ 4096); the shared body keeps 96 bytes per 64 rows (streamed:
    and 272 bytes of Type I row lists)."""
    def prepare(B2_):
        ta = torch.zeros((1, 5, 3), dtype=torch.uint8)
        lits = torch.zeros((1, B2_, 1), dtype=torch.int32)
        fb = torch.zeros((1, B2_, 5), dtype=torch.int32)
        l_mask = torch.ones((1, 3), dtype=torch.int32)
        scal = (1, P_TA, True, 256)
        if kind == "dense":
            return tu.prepare_ta_update(ta, lits, fb, fb, fb, l_mask, *scal)
        rands = torch.zeros((1, B2_, 5, 3), dtype=torch.int32)
        return tu.prepare_ta_update_streamed(ta, lits, fb, fb, fb, l_mask,
                                             rands, *scal[1:])
    streamed = kind == "streamed"
    assert 12 * 4500 > 48 * 1024
    assert tu.sparse_smem(5, 4500, streamed) <= 48 * 1024
    launch, _ = prepare(4500)
    assert launch.args[-1] == 32                  # one group, 32 quads
    assert tu.sparse_smem(5, 33000, streamed) > 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        prepare(33000)


def test_ta_update_streamed_plain_matches_interpret_pallas():
    """2B = 66 (two 64-row chunks on the card), int32 states, no boost;
    random 32-bit words with some at p_ta − 1, p_ta and p_ta + 1."""
    B2_, C_, L_ = 66, 24, 40
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(66, B2_, C_, L_, 10)
    p_ta = 2 ** 31 + 12345
    gen = np.random.default_rng(66)
    words = gen.integers(0, 2 ** 32, (B2_, C_, L_), dtype=np.uint64)
    pick = gen.random(words.shape)
    words[pick < 0.1] = p_ta - 1
    words[(pick >= 0.1) & (pick < 0.2)] = p_ta
    words[(pick >= 0.2) & (pick < 0.25)] = p_ta + 1
    words = words.astype(np.uint32)
    want = np.asarray(j_ta_update_streamed(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
        jnp.asarray(words), jnp.uint32(p_ta), boost=False, n_states=n,
        yt=C_, xt=L_, interpret=True))
    assert (want != ta).any()
    one = lambda a: torch.from_numpy(np.asarray(a))[None]
    args = (one(ta), pack_literals(one(lits)), one(cl), one(t1), one(t2),
            one(l_mask), one(words.view(np.int32)))
    scal = (torch.tensor([p_ta]), torch.tensor([False]), torch.tensor([n]))
    for fn in (tu.ta_update_streamed, tu.ta_update_streamed_plain):
        new_ta, new_inc = fn(*args, *scal)
        assert new_ta.dtype == torch.int32
        np.testing.assert_array_equal(new_ta[0].numpy(), want)
        np.testing.assert_array_equal(
            new_inc[0].numpy().view(np.uint32),
            np.asarray(jref.pack_include(jnp.asarray(want), n)))
    assert torch.equal(new_inc, tref.pack_include(new_ta, n))


def test_to_bool_defaults_to_the_card(monkeypatch):
    """Like the port's other entry points: without a card, a call that
    names no device raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.array([[0, 1, 1], [1, 0, 0]], np.int8)
    spec = tapi.TMSpec.coalesced(features=3, classes=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.to_bool(x)
    got = spec.to_bool(x, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, torch.as_tensor(x))
    head = tapi.TMSpec.head(np.array([[0.0, 0.0], [1.0, 4.0],
                                      [2.0, 8.0]], np.float32), classes=2,
                            therm_bits=1)             # cuts 1.0 and 4.0
    raw = np.array([[1.0, 3.0]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        head.to_bool(raw)
    bits = head.to_bool(raw, device="cpu")
    assert bits.device.type == "cpu" and bits.tolist() == [[1, 0]]
