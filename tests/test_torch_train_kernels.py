"""Training kernels of the port against the JAX package (CPU, exact).

The plain versions of ``fused_step``, ``ta_update`` and
``ta_update_sparse`` (what a CPU tensor runs, and what the card's kernels
are held against) must equal the JAX oracles in ``repro/kernels/ref.py``
and, at one shape each, the Pallas kernels in interpret mode: both stream
families, boost on and off, ta_bits 8 and 10, an L that is not a multiple
of 256, a row offset, duplicate sparse indices and zero active groups.
The compacted update equals the dense one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ta_update import ta_update_sparse as j_ta_update_sparse
from repro_torch.core.booleanize import pack_literals
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_step import fused_step, fused_step_plain
from repro_torch.kernels.ta_update import (ta_update, ta_update_plain,
                                           ta_update_sparse,
                                           ta_update_sparse_plain)


def _front_inputs(seed, B, R, L, H, frozen):
    rng = np.random.default_rng(seed)
    lits = rng.integers(0, 2, (B, L)).astype(np.int8)
    inc = (rng.random((R, L)) < 0.03).astype(np.int8)
    inc[:3] = 0                                   # empty clauses fire
    w = rng.integers(-6, 7, (H, R)).astype(np.int32)
    w[:, ::4] = 0
    labels = rng.integers(0, H - 1, B).astype(np.int32)
    neg = ((labels + 1 + rng.integers(0, H - 2, B)) % (H - 1)).astype(
        np.int32)
    rand = rng.integers(0, 1 << 16, (2, B, R)).astype(np.uint32)
    cl_mask = (np.arange(R) < R - 5).astype(np.int32)
    h_mask = (np.arange(H) < H - 1).astype(np.int32)
    return lits, inc, w, labels, neg, rand, cl_mask, h_mask, 13, int(frozen)


def _port_front(lits, inc, w, labels, neg, rand, cl_mask, h_mask, T, wf):
    """The same inputs in the port's kernel form (K = 1, packed words)."""
    one = lambda a: torch.from_numpy(np.asarray(a))[None]
    return (pack_literals(one(lits)), pack_literals(one(inc)), one(w),
            one(labels), one(neg), one(rand.astype(np.int64)), one(cl_mask),
            one(h_mask), torch.tensor([T], dtype=torch.int32),
            torch.tensor([wf], dtype=torch.int32))


@pytest.mark.parametrize("B,R,L,H", [(1, 20, 42, 3), (5, 70, 100, 4),
                                     (32, 130, 64, 6)])
@pytest.mark.parametrize("frozen", [False, True])
def test_fused_step_plain_matches_jax_oracle(B, R, L, H, frozen):
    inp = _front_inputs(B + R, B, R, L, H, frozen)
    lits, inc, w, labels, neg, rand, cl_mask, h_mask, T, wf = inp
    want = jref.fused_step_ref(*(jnp.asarray(a) for a in inp[:5]),
                               jnp.asarray(rand[0]), jnp.asarray(rand[1]),
                               jnp.asarray(cl_mask), jnp.asarray(h_mask),
                               T, wf)
    args = _port_front(*inp)
    dense = tref.fused_step_ref(
        torch.from_numpy(lits), torch.from_numpy(inc), torch.from_numpy(w),
        torch.from_numpy(labels), torch.from_numpy(neg),
        torch.from_numpy(rand[0].astype(np.int64)),
        torch.from_numpy(rand[1].astype(np.int64)),
        torch.from_numpy(cl_mask), torch.from_numpy(h_mask), T, wf)
    for fn in (fused_step, fused_step_plain):
        got = fn(*args, n_bits=L)
        for name, g, d, wnt in zip(("clause", "sums", "sel_lab", "sel_neg"),
                                   got, dense, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt),
                                          err_msg=name)
            np.testing.assert_array_equal(d.numpy(), np.asarray(wnt))
    packed = tops.packed_step_op(*(a[0] for a in args), n_bits=L)
    for g, wnt in zip(packed, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert np.asarray(want[2]).sum() > 0 and np.asarray(want[3]).sum() > 0


def test_fused_step_matches_interpret_pallas():
    inp = _front_inputs(3, 6, 40, 70, 4, False)
    lits, inc, w, labels, neg, rand, cl_mask, h_mask, T, wf = inp
    want = jops.fused_step_op(*(jnp.asarray(a) for a in inp[:5]),
                              jnp.asarray(rand[0]), jnp.asarray(rand[1]),
                              jnp.asarray(cl_mask), jnp.asarray(h_mask), T,
                              wf, backend="pallas")
    got = tops.fused_step_op(*(a[0] for a in _port_front(*inp)), n_bits=70)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_fused_step_bank_axis_is_per_program():
    inps = [_front_inputs(s, 5, 40, 64, 4, s % 2 == 1) for s in range(3)]
    ports = [_port_front(*i) for i in inps]
    bank = [torch.cat(parts) for parts in zip(*ports)]
    got = fused_step(*bank, n_bits=64)
    for k, p in enumerate(ports):
        for g, w in zip(got, fused_step_plain(*p, n_bits=64)):
            assert torch.equal(g[k], w[0])


def _ta_inputs(seed, B2, C, L, ta_bits):
    rng = np.random.default_rng(seed)
    n = 1 << ta_bits
    ta = rng.integers(0, n, (C, L)).astype(np.uint8 if ta_bits <= 8
                                          else np.int32)
    lits = rng.integers(0, 2, (B2, L)).astype(np.int8)
    cl = rng.integers(0, 2, (B2, C)).astype(np.int8)
    t1 = (rng.random((B2, C)) < 0.25).astype(np.int8)
    t2 = (rng.random((B2, C)) < 0.25).astype(np.int8)
    t1[:, C // 2:C // 2 + 3] = 0                 # rows without feedback
    t2[:, C // 2:C // 2 + 3] = 0
    l_mask = (np.arange(L) < L - 6).astype(np.int32)
    return ta, lits, cl, t1, t2, l_mask, n


def _port_ta(ta, lits, cl, t1, t2, l_mask):
    one = lambda a: torch.from_numpy(np.asarray(a))[None]
    return (one(ta), pack_literals(one(lits)), one(cl), one(t1), one(t2),
            one(l_mask))


STREAMS = {"counter": dict(prng="counter"),
           "lfsr24": dict(prng="lfsr", lfsr_bits=24),
           "lfsr4": dict(prng="lfsr", lfsr_bits=4),
           "lfsr4_norefresh": dict(prng="lfsr", lfsr_bits=4,
                                   seed_refresh=False)}
SEED, P_TA = 0x9E3779B9, 6554


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("boost", [True, False])
@pytest.mark.parametrize("ta_bits", [8, 10])
def test_ta_update_plain_matches_jax_oracle(stream, boost, ta_bits):
    C, L, B2 = 45, 300, 34             # L not a multiple of 256
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(ta_bits + len(stream), B2,
                                                 C, L, ta_bits)
    kw = STREAMS[stream]
    row0 = 77
    want = jref.ta_update_ref(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl), jnp.asarray(t1),
        jnp.asarray(t2), jnp.asarray(l_mask), jnp.uint32(SEED),
        jnp.uint32(P_TA), 16, boost, n, row_idx=row0 + jnp.arange(C), **kw)
    want = np.asarray(want)
    assert (want != ta.astype(np.int32)).any()
    args = _port_ta(ta, lits, cl, t1, t2, l_mask)
    scal = (torch.tensor([SEED]), torch.tensor([P_TA]),
            torch.tensor([boost]), torch.tensor([n]))
    for fn in (ta_update, ta_update_plain):
        new_ta, new_inc = fn(*args, *scal, row0=row0, **kw)
        assert new_ta.dtype == args[0].dtype
        np.testing.assert_array_equal(new_ta[0].numpy().astype(np.int32),
                                      want)
        np.testing.assert_array_equal(
            new_inc[0].numpy().view(np.uint32),
            np.asarray(jref.pack_include(jnp.asarray(want), n)))
    got = tref.ta_update_ref(*(torch.from_numpy(a) for a in
                               (ta, lits, cl, t1, t2, l_mask)), SEED, P_TA,
                             16, boost, n, row_idx=row0 + torch.arange(C),
                             **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stream", list(STREAMS))
def test_ta_rand_stream_matches_jax(stream):
    """The materialised stream (the consumed randoms, row by row) and the
    stream keys, at a row offset."""
    kw = STREAMS[stream]
    want = jref.ta_rand_stream(jnp.uint32(SEED), 20, 9, 300, 16,
                               row_idx=jnp.arange(9) + 5, **kw)
    got = tref.ta_rand_stream(SEED, 20, 9, 300, 16,
                              row_idx=torch.arange(9) + 5, **kw)
    assert got.shape == (20, 9, 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stream", ["counter", "lfsr4"])
def test_ta_update_matches_interpret_pallas(stream):
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(1, 6, 20, 70, 8)
    kw = STREAMS[stream]
    want = jops.ta_update_op(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
        jnp.uint32(SEED), jnp.uint32(P_TA), 16, False, n,
        backend="pallas", row0=3, **kw)
    got, _ = ta_update(*_port_ta(ta, lits, cl, t1, t2, l_mask),
                       torch.tensor([SEED]), torch.tensor([P_TA]),
                       torch.tensor([False]), torch.tensor([n]), row0=3,
                       **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("stream", ["counter", "lfsr24"])
def test_ta_update_sparse_matches_interpret_pallas(stream):
    """Duplicate indices, and the tiles the JAX kernel returns compacted
    equal the port's rows of those groups."""
    C, L = 384, 256
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(2, 4, C, L, 8)
    kw = STREAMS[stream]
    idx = np.array([2, 0, 2], np.int32)
    want = np.asarray(j_ta_update_sparse(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
        jnp.asarray(idx), seed=jnp.uint32(SEED), p_ta=jnp.uint32(P_TA),
        boost=True, n_states=n, interpret=True, **kw))
    args = _port_ta(ta, lits, cl, t1, t2, l_mask)
    inc = tref.pack_include(args[0], n)
    new_ta, new_inc = ta_update_sparse(
        *args, inc, torch.from_numpy(idx)[None], torch.tensor([3]),
        torch.tensor([SEED]), torch.tensor([P_TA]), torch.tensor([True]),
        torch.tensor([n]), **kw)
    for slot, g in enumerate(idx):
        np.testing.assert_array_equal(
            new_ta[0, g * 128:(g + 1) * 128].numpy(),
            want[slot * 128:(slot + 1) * 128])
    # group 1 is not listed: its rows and include words stay
    assert torch.equal(new_ta[0, 128:256], args[0][0, 128:256])
    assert torch.equal(new_inc[0, 128:256], inc[0, 128:256])


def _compact_case(seed, K, B2, C, L, stream, ta_bits=8, dead=()):
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(seed, B2, C, L, ta_bits)
    for g in dead:                      # groups without any feedback
        t1[:, g * 128:(g + 1) * 128] = 0
        t2[:, g * 128:(g + 1) * 128] = 0
    args = [a.expand(K, *a.shape[1:]).clone()
            for a in _port_ta(ta, lits, cl, t1, t2, l_mask)]
    scal = (torch.tensor([SEED + k for k in range(K)]),
            torch.full((K,), P_TA), torch.arange(K) % 2 == 0,
            torch.full((K,), n))
    return args, scal, STREAMS[stream], n


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("dead", [(), (1,), (0, 1, 2)])
def test_compact_equals_dense(stream, dead):
    args, scal, kw, n = _compact_case(4, 2, 10, 300, 90, stream, dead=dead)
    dense = tops.ta_update_op(*args, *scal, **kw)
    inc = tref.pack_include(args[0], scal[3])
    compact = tops.ta_update_compact_op(*args, inc, *scal, **kw)
    for d, c in zip(dense, compact):
        assert torch.equal(d, c)
    idx, count = tops.active_groups(args[3], args[4])
    assert count.tolist() == [3 - len(dead)] * 2
    live = [g for g in range(3) if g not in dead]
    assert idx[:, :len(live)].tolist() == [live] * 2


def test_zero_active_groups_leave_the_state():
    args, scal, kw, n = _compact_case(5, 1, 4, 200, 64, "counter",
                                      dead=(0, 1))
    inc = tref.pack_include(args[0], n)
    idx, count = tops.active_groups(args[3], args[4])
    assert int(count[0]) == 0
    for fn in (ta_update_sparse, ta_update_sparse_plain):
        new_ta, new_inc = fn(*args, inc, idx, count, *scal, **kw)
        assert torch.equal(new_ta, args[0]) and torch.equal(new_inc, inc)


@pytest.mark.parametrize("stream", ["counter", "lfsr4"])
def test_sparse_update_in_place(stream):
    """In place, the listed groups (one listed twice) are written into
    ``ta`` and ``inc`` themselves, with the values of the copying update;
    the groups left alone keep their states."""
    args, scal, kw, n = _compact_case(9, 2, 6, 300, 90, stream)
    inc = tref.pack_include(args[0], scal[3])
    idx = torch.tensor([[2, 0, 2], [1, 1, 0]], dtype=torch.int32)
    cnt = torch.tensor([3, 2], dtype=torch.int32)
    want = ta_update_sparse(*args, inc, idx, cnt, *scal, **kw)
    ta, inc_ = args[0].clone(), inc.clone()
    got = ta_update_sparse(ta, *args[1:], inc_, idx, cnt, *scal,
                           inplace=True, **kw)
    assert got[0] is ta and got[1] is inc_
    assert torch.equal(ta, want[0]) and torch.equal(inc_, want[1])
    assert torch.equal(ta[0, 128:256], args[0][0, 128:256])
    assert torch.equal(ta[1, 256:], args[0][1, 256:])
    strided = ta.transpose(1, 2).contiguous().transpose(1, 2)
    for bad_ta, bad_inc in ((strided, inc_), (ta, inc_.to(torch.int64))):
        with pytest.raises(ValueError, match="in-place"):
            ta_update_sparse(bad_ta, *args[1:], bad_inc, idx, cnt, *scal,
                             inplace=True, **kw)


def test_ta_update_bank_axis_is_per_program():
    args, scal, kw, n = _compact_case(6, 3, 8, 150, 40, "lfsr24")
    got = ta_update(*args, *scal, row0=torch.tensor([0, 5, 9]), **kw)
    for k, row0 in enumerate((0, 5, 9)):
        one = ta_update(*(a[k:k + 1] for a in args),
                        *(s[k:k + 1] for s in scal), row0=row0, **kw)
        assert torch.equal(got[0][k], one[0][0])
        assert torch.equal(got[1][k], one[1][0])


def test_ta_wrappers_reject_bad_operands():
    args, scal, kw, n = _compact_case(7, 1, 4, 40, 40, "counter")
    with pytest.raises(ValueError):
        ta_update(args[0], args[1][:, :, :1], *args[2:], *scal)
    with pytest.raises(TypeError):
        ta_update(args[0].to(torch.int16), *args[1:], *scal)
    with pytest.raises(ValueError):
        ta_update(*args, *scal, prng="threefry")
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError):
        ta_update(*meta, *scal)


def test_cpu_training_ops_launch_no_kernel():
    tops.reset_launch_counts()
    args, scal, kw, n = _compact_case(8, 1, 4, 40, 40, "counter")
    tops.ta_update_op(*args, *scal)
    tops.ta_update_compact_op(*args, tref.pack_include(args[0], n), *scal)
    tops.fused_step_op(*(a[0] for a in _port_front(
        *_front_inputs(0, 5, 20, 40, 3, False))))
    assert set(tops.launch_counts().values()) == {0}
    assert tops.select_path(32, training=True) == "fused"
    assert tops.select_path(4, training=True) == "packed_vpu"
    assert tops.select_path(32, force="mxu_popcount",
                            training=True) == "mxu_popcount"
    assert tops.select_ta_path(1) == "compact"
    assert tops.select_ta_path(1, skip=False) == tops.select_ta_path(3) \
        == "dense"
