"""The redesigned ``clause_eval`` and ``ta_update_sparse`` of the port:
what the CPU can check (exact).

* The plain ``clause_eval`` (what the card's kernel is held against)
  equals the JAX package's ``clause_eval`` at the new kernel's tile and
  split edges, and counts any nonzero byte as 1.
* The wrapper's split chooser covers every (k, b, c, l) exactly once and
  gives the training shape more blocks than one per 64 clauses.
* The plain ``ta_update_sparse`` equals the interpret-mode Pallas kernel
  with duplicate, negative and past-C slots, a count below the slot count
  with garbage after it, and 2B above 64; both LFSR refresh settings.
* The per-program scalars the sparse kernel takes as they come (tensors,
  0-d, [1], ints, uint32 values at or above 2^31) read as the [K, 5]
  block the other TA kernels take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ta_update import ta_update_sparse as j_ta_update_sparse
from test_torch_train_kernels import P_TA, SEED, STREAMS, _port_ta, _ta_inputs
from repro_torch.kernels import ref as tref
from repro_torch.kernels import clause_eval as ce
from repro_torch.kernels import ta_update as tu

EDGE_L = [1, 15, 16, 17, 31, 32, 33, 513]


def split_ranges(L, cps):
    """The literal range [lo, hi) of each split, as the kernel walks them
    (split s covers chunks [s·cps, (s + 1)·cps) of ``ce.CHUNK`` bytes)."""
    step = cps * ce.CHUNK
    return [(lo, min(lo + step, L)) for lo in range(0, max(L, 1), step)]


def grid_blocks(K, B, C, L, sms):
    """Blocks of one ``clause_eval`` launch (csrc dtm_clause_eval's grid)."""
    splits, _ = ce.clause_split(K, B, C, L, sms)
    return -(-C // ce.TILE_C) * splits * -(-B // ce.TILE_B) * K


def scalar_values(spec, K):
    """The uint32 values (int64 [K]) the sparse kernel reads from
    ``spec`` (``ta_update.scalar_spec``), as csrc sp::read_u32 reads
    them: element ``k · stride`` of an int64, int32 or bool tensor,
    truncated to 32 bits; or the value."""
    t, nbytes, stride, value = spec
    if t is None:
        return torch.full((K,), value & tref.M32, dtype=torch.int64)
    assert t.dtype in (torch.int64, torch.int32, torch.bool)
    assert nbytes == t.element_size()
    read = t.detach().as_strided((K,), (stride,)).cpu()
    return read.to(torch.int64) & tref.M32


@pytest.mark.parametrize("L", EDGE_L)
@pytest.mark.parametrize("B,C", [(1, 127), (32, 128), (33, 129)])
def test_clause_eval_plain_matches_jax_at_tile_edges(L, B, C):
    rng = np.random.default_rng(L * 100 + B + C)
    K = 2
    lit = (rng.random((K, B, L)) < 0.7).astype(np.int8)
    inc = (rng.random((K, C, L)) < 0.05).astype(np.int8)
    inc[:, ::5] = 0                               # empty rows
    inc[:, 1::6] = 0
    inc[:, 1::6, 0] = 1                           # one-literal clauses
    for eval_mode in (False, True):
        got = ce.clause_eval(torch.from_numpy(lit), torch.from_numpy(inc),
                             eval_mode)
        for k in range(K):
            want = np.asarray(jops.clause_eval_op(
                jnp.asarray(lit[k]), jnp.asarray(inc[k]),
                eval_mode=eval_mode))
            np.testing.assert_array_equal(got[k].numpy(), want)
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("L", [17, 513])
def test_clause_eval_plain_counts_any_nonzero_byte(L):
    """Bytes other than 0 and 1: the plain version (and so the kernel)
    equals the JAX oracle on the operands' != 0 tests."""
    rng = np.random.default_rng(L)
    lit = rng.integers(-128, 128, (2, 9, L)).astype(np.int8)
    lit[rng.random(lit.shape) < 0.3] = 0
    inc = rng.integers(-128, 128, (2, 40, L)).astype(np.int8)
    inc[rng.random(inc.shape) < 0.97] = 0
    inc[:, ::4] = 0
    for eval_mode in (False, True):
        got = ce.clause_eval(torch.from_numpy(lit), torch.from_numpy(inc),
                             eval_mode)
        for k in range(2):
            want = np.asarray(jref.clause_eval_ref(
                jnp.asarray((lit[k] != 0).astype(np.int8)),
                jnp.asarray((inc[k] != 0).astype(np.int8)), eval_mode))
            np.testing.assert_array_equal(got[k].numpy(), want)


def test_clause_eval_plain_matches_jax_past_64k_literals():
    """L above 65,536 (where a kernel split walks two literal ranges)."""
    L = 65553
    rng = np.random.default_rng(L)
    lit = (rng.random((1, 5, L)) < 0.8).astype(np.int8)
    inc = np.zeros((1, 7, L), np.int8)
    for c in range(1, 7):                         # row 0 stays empty
        inc[0, c, rng.integers(L - 200 * c, L, 2)] = 1
    for eval_mode in (False, True):
        got = ce.clause_eval(torch.from_numpy(lit), torch.from_numpy(inc),
                             eval_mode)
        want = np.asarray(jops.clause_eval_op(
            jnp.asarray(lit[0]), jnp.asarray(inc[0]), eval_mode=eval_mode))
        np.testing.assert_array_equal(got[0].numpy(), want)


def _axis_cover(n, step, ranges=None):
    """How often the tiles of one axis cover each index."""
    seen = np.zeros(max(n, 1), np.int32)
    for lo, hi in ranges or [(lo, min(lo + step, n))
                             for lo in range(0, max(n, 1), step)]:
        seen[lo:max(hi, lo + (n == 0))] += 1
    return seen


@pytest.mark.parametrize("K,B,C,L,sms", [
    (1, 32, 2048, 1664, 132), (4, 32, 4224, 3200, 132), (1, 1, 1, 1, 132),
    (2, 33, 129, 513, 132), (3, 70, 300, 1000, 8), (1, 5, 7, 8192, 132),
    (1, 3, 130, 65553, 132), (2, 544, 2048, 200000, 132)])
def test_clause_split_covers_every_element_once(K, B, C, L, sms):
    """The launch is batch tiles × clause tiles × splits per program, so
    each (k, b, c, l) is covered once iff each axis is cut into a
    partition; small shapes are also checked element by element."""
    splits, cps = ce.clause_split(K, B, C, L, sms)
    ranges = split_ranges(L, cps)
    assert len(ranges) == splits
    assert 1 <= splits <= ce.MAX_SPLITS and cps >= 1
    # a split packs more than MAX_CHUNKS chunks (in ranges) only once the
    # splits run out
    assert cps <= ce.MAX_CHUNKS or splits == ce.MAX_SPLITS
    assert (splits - 1) * cps * ce.CHUNK < max(L, 1) <= splits * cps * ce.CHUNK
    for seen in (_axis_cover(L, 0, ranges), _axis_cover(B, ce.TILE_B),
                 _axis_cover(C, ce.TILE_C)):
        assert (seen == 1).all()
    if K * B * C * L <= 1 << 23:
        seen = np.zeros((K, B, C, L), np.int8)
        for k in range(K):
            for b0 in range(0, B, ce.TILE_B):
                for c0 in range(0, C, ce.TILE_C):
                    for lo, hi in ranges:
                        seen[k, b0:b0 + ce.TILE_B, c0:c0 + ce.TILE_C,
                             lo:hi] += 1
        assert (seen == 1).all()


def test_clause_split_fills_the_card_at_the_training_shape():
    # the first design launched ceil(C/64) · ceil(B/32) · K = 32 blocks here
    splits, _ = ce.clause_split(1, 32, 2048, 1664, 132)
    assert splits > 1
    assert grid_blocks(1, 32, 2048, 1664, 132) > 32 * 2
    # a shape that already fills the card is not split further than needed
    assert ce.clause_split(64, 256, 8192, 256, 132)[0] == 1
    # any L: past 65,536 literals a split walks more than one range
    L = ce.MAX_SPLITS * ce.MAX_CHUNKS * ce.CHUNK + 1
    assert ce.clause_split(1, 1, 1, L, 132) == (ce.MAX_SPLITS,
                                                ce.MAX_CHUNKS + 1)


def _old_params(K, seed, p_ta, boost, n_states, row0):
    """The [K, 5] scalar block as the first sparse wrapper built it."""
    def col(v):
        if isinstance(v, torch.Tensor):
            t = v.expand(K) if v.dim() == 0 else v
        else:
            t = torch.full((K,), int(v), dtype=torch.int64)
        return t.to(torch.int64) & tref.M32
    return torch.stack([col(seed), col(p_ta), col(boost), col(n_states),
                        col(row0)], dim=-1)


@pytest.mark.parametrize("case", ["tensors", "zero_d", "ints", "int32_bits",
                                  "one_elem"])
def test_sparse_scalars_read_as_the_old_block(case):
    K = 3
    big = [2 ** 31 + 5, 2 ** 32 - 1, 2 ** 31]
    if case == "tensors":
        v = (torch.tensor(big), torch.tensor([6554, 2 ** 31 + 1, 7]),
             torch.tensor([True, False, True]),
             torch.tensor([256, 1024, 16], dtype=torch.int32),
             torch.tensor([0, 5, 300]))
    elif case == "zero_d":
        v = (torch.tensor(big[0]), torch.tensor(6554, dtype=torch.int32),
             torch.tensor(False), torch.tensor(256, dtype=torch.int16),
             torch.tensor(7, dtype=torch.uint8))
    elif case == "ints":
        v = (big[1], 6554, True, 256, 2 ** 31 + 3)
    elif case == "int32_bits":      # uint32 values as their int32 bits
        v = (torch.tensor(big, dtype=torch.int64).sub(2 ** 32).to(
            torch.int32), torch.tensor([-1, 6554, -(2 ** 31)],
                                       dtype=torch.int32),
             torch.tensor([1, 0, 2], dtype=torch.int8),
             torch.tensor([256, 256, 256], dtype=torch.int32), 0)
    else:
        v = (torch.tensor([big[0]]), torch.tensor([6554]),
             torch.tensor([True]), torch.tensor([256]), torch.tensor([9]))
    got = torch.stack([scalar_values(tu.scalar_spec(x, K, "cpu"), K)
                       for x in v], dim=-1)
    want = _old_params(K, *v).expand(K, 5)   # a [1] scalar: every program
    assert torch.equal(got, want)
    # and the plain path reads them the same way
    assert torch.equal(tu._params(K, *v, "cpu").to(torch.int64) & tref.M32,
                       want)


def test_sparse_scalars_take_views_and_reject_bad_shapes():
    base = torch.tensor([1, 2 ** 31 + 9, 3, 4, 5, 6], dtype=torch.int64)
    view = base[1::2]                 # stride 2
    got = scalar_values(tu.scalar_spec(view, 3, "cpu"), 3)
    assert got.tolist() == [2 ** 31 + 9, 4, 6]
    spec = tu.scalar_spec(torch.tensor([1.0, 2.0, 3.0]), 3, "cpu")
    assert spec[0].dtype == torch.int64
    with pytest.raises(ValueError):
        tu.scalar_spec(torch.zeros(2), 3, "cpu")
    with pytest.raises(ValueError):
        tu.scalar_spec(torch.zeros((3, 1)), 3, "cpu")


def test_sparse_launch_settings():
    # a refresh can fire within a call only when 2B covers the period
    assert tu.lfsr_refresh("lfsr", 4, True, 15)
    assert not tu.lfsr_refresh("lfsr", 4, True, 14)
    assert not tu.lfsr_refresh("lfsr", 4, False, 130)
    assert not tu.lfsr_refresh("lfsr", 24, True, 64)
    assert not tu.lfsr_refresh("counter", 4, True, 130)
    # a block per item of the listed slots (group, row quad, 4 word
    # chunks), at most a few blocks per SM
    chunks = -(-52 // tu.SPARSE_WORDS)
    items = 16 * (tu.GROUP // tu.SPARSE_ROWS) * -(-chunks // tu.SPARSE_WARPS)
    assert tu.sparse_blocks(16, 2048, 52, 132) == min(
        items, tu.SPARSE_BLOCKS_PER_SM * 132)
    assert tu.sparse_blocks(99, 200, 2, 132) == 2 * 32   # 2 groups exist
    assert tu.sparse_blocks(1, 1, 1, 132) == 32          # quads past C exit
    # the engine's int32 feedback goes to the kernel as it is; any other
    # dtype as its > 0 test in int32
    i32 = torch.tensor([[[0, 1, 3]]], dtype=torch.int32)
    assert all(t is i32 for t in tu._feedback(i32, i32, i32))
    odd = (i32.bool(), torch.tensor([[[-1, 2 ** 32, 1]]]),
           torch.tensor([[[0, -128, 255]]], dtype=torch.int16))
    got = tu._feedback(*odd)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in got)
    assert [t.tolist() for t in got] == [[[[0, 1, 1]]], [[[0, 1, 1]]],
                                         [[[0, 0, 1]]]]


@pytest.mark.parametrize("B2", [66, 130])
@pytest.mark.parametrize("stream", ["counter", "lfsr4", "lfsr4_norefresh",
                                    "lfsr24"])
def test_ta_update_sparse_slots_match_interpret_pallas(B2, stream):
    """Slots with a duplicate, a negative entry and a group past C, and
    garbage past the count: the port's update of the listed groups equals
    the JAX kernel's tiles of the unique valid groups."""
    C, L = 384, 256
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(B2, B2, C, L, 8)
    kw = STREAMS[stream]
    args = _port_ta(ta, lits, cl, t1, t2, l_mask)
    inc = tref.pack_include(args[0], n)
    slots = torch.tensor([[2, -1, 2, 9, 0, 1, 1]], dtype=torch.int32)
    count = torch.tensor([5])                     # slots 5.. are garbage
    new_ta, new_inc = tu.ta_update_sparse(
        *args, inc, slots, count, torch.tensor([SEED]),
        torch.tensor([P_TA]), torch.tensor([False]), torch.tensor([n]),
        row0=7, **kw)
    groups = np.array([2, 0], np.int32)           # unique, valid, listed
    want = np.asarray(j_ta_update_sparse(
        jnp.asarray(ta), jnp.asarray(lits), jnp.asarray(cl),
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(l_mask),
        jnp.asarray(groups), seed=jnp.uint32(SEED), p_ta=jnp.uint32(P_TA),
        boost=False, n_states=n, row0=jnp.uint32(7), interpret=True, **kw))
    for slot, g in enumerate(groups):
        rows = slice(g * 128, (g + 1) * 128)
        np.testing.assert_array_equal(new_ta[0, rows].numpy(),
                                      want[slot * 128:(slot + 1) * 128])
        np.testing.assert_array_equal(
            new_inc[0, rows].numpy().view(np.uint32),
            np.asarray(jref.pack_include(
                jnp.asarray(want[slot * 128:(slot + 1) * 128]), n)))
    # group 1 is listed only past the count: it keeps its state
    assert torch.equal(new_ta[0, 128:256], args[0][0, 128:256])
    assert torch.equal(new_inc[0, 128:256], inc[0, 128:256])
    assert (new_ta[0, :128] != args[0][0, :128]).any()


@pytest.mark.parametrize("count", [0, -3])
def test_ta_update_sparse_count_of_zero_or_less_updates_nothing(count):
    ta, lits, cl, t1, t2, l_mask, n = _ta_inputs(3, 6, 200, 64, 8)
    args = _port_ta(ta, lits, cl, t1, t2, l_mask)
    inc = tref.pack_include(args[0], n)
    new_ta, new_inc = tu.ta_update_sparse(
        *args, inc, torch.tensor([[0, 1]], dtype=torch.int32),
        torch.tensor([count]), SEED, P_TA, True, n)
    assert torch.equal(new_ta, args[0]) and torch.equal(new_inc, inc)
