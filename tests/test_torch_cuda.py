"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (decided inside the fixture, never at import).  Run them on a
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The datapath is integer, so kernel and plain version must agree exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.booleanize import pack_literals
from repro_torch.kernels import _build, ops
from repro_torch.kernels.class_sum import class_sum, class_sum_plain
from repro_torch.kernels.clause_eval import clause_eval, clause_eval_plain
from repro_torch.kernels.tm_infer import tm_infer, tm_infer_plain
from repro_torch.kernels.fused_step import (fused_step, fused_step_plain,
                                            prepare_fused_step)
from repro_torch.kernels.ta_update import (stream_rands, ta_update,
                                           ta_update_plain, ta_update_sparse,
                                           ta_update_sparse_plain,
                                           ta_update_streamed,
                                           ta_update_streamed_plain)
from repro_torch.kernels.packed_clause import (packed_clause_eval,
                                               packed_clause_eval_plain,
                                               packed_clause_tile,
                                               packed_clause_tile_plain)
from repro_torch.launch.serve_tm import TMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _words(gen, shape, density, dev):
    """int32 words whose 32 bits are each set with ``density``."""
    bits = torch.rand((*shape, 32), generator=gen) < density
    w = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32).to(dev)


def _operands(K, B, R, W, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lit = _words(gen, (K, B, W), 0.75, dev)
    inc = _words(gen, (K, R, W), 0.01, dev)
    inc[:, ::7] = 0                      # empty clauses: the eval-mode gate
    return lit, inc


SHAPES = [(1, 1, 1, 1), (1, 3, 17, 2), (2, 4, 130, 5), (3, 5, 33, 4),
          (2, 32, 200, 101), (1, 33, 65, 8), (4, 7, 64, 100)]


@pytest.mark.parametrize("K,B,R,W", SHAPES)
@pytest.mark.parametrize("eval_mode", [False, True])
def test_clause_kernels_match_plain(dev, K, B, R, W, eval_mode):
    lit, inc = _operands(K, B, R, W, dev, seed=K * B + R)
    for n_bits in (32 * W, 32 * W - 5 if W > 1 else 20):
        want = packed_clause_eval_plain(lit, inc, eval_mode, n_bits)
        assert torch.equal(want, packed_clause_tile_plain(lit, inc, eval_mode,
                                                          n_bits))
        for fn in (packed_clause_eval, packed_clause_tile):
            got = fn(lit, inc, eval_mode, n_bits)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.int32
            assert torch.equal(got, want), (fn.__name__, n_bits)


def test_clause_kernels_take_strided_and_unaligned_operands(dev):
    lit, inc = _operands(1, 3, 50, 8, dev, seed=3)
    want = packed_clause_eval_plain(lit.expand(3, -1, -1),
                                    inc.expand(3, -1, -1), True)
    for fn in (packed_clause_eval, packed_clause_tile):
        got = fn(lit.expand(3, -1, -1), inc.expand(3, -1, -1), True)
        assert torch.equal(got, want), fn.__name__
    # an include view one word off 16-byte alignment takes the scalar loads
    base = torch.zeros(inc.numel() + 1, dtype=torch.int32, device=dev)
    base[1:] = inc.reshape(-1)
    shifted = base[1:].view(inc.shape)
    for fn in (packed_clause_eval, packed_clause_tile):
        assert torch.equal(fn(lit, shifted, True),
                           packed_clause_eval_plain(lit, inc, True))


@pytest.mark.parametrize("K,B,R,H", [(1, 1, 1, 1), (1, 3, 300, 4),
                                     (4, 32, 4224, 16), (2, 5, 77, 19),
                                     (3, 9, 130, 33)])
def test_class_sum_kernel_matches_plain(dev, K, B, R, H):
    gen = torch.Generator().manual_seed(K + B + R + H)
    cl = torch.randint(0, 2, (K, B, R), generator=gen,
                       dtype=torch.int32).to(dev)
    w = torch.randint(-2047, 2048, (K, H, R), generator=gen,
                      dtype=torch.int32).to(dev)
    got = class_sum(cl, w)
    torch.cuda.synchronize()
    assert torch.equal(got, class_sum_plain(cl, w))


def test_wrappers_count_launches_and_never_fall_back(dev):
    ops.reset_launch_counts()
    lit, inc = _operands(1, 2, 40, 3, dev)
    ops.packed_clause_eval_op(lit[0], inc[0], eval_mode=True)
    ops.packed_clause_mxu_op(lit, inc, eval_mode=True)
    ops.class_sum_op(torch.ones((2, 40), dtype=torch.int32, device=dev),
                     torch.ones((3, 40), dtype=torch.int32, device=dev))
    assert ops.launch_counts() == {"packed_clause_eval": 1,
                                   "packed_clause_tile": 1, "class_sum": 1,
                                   "fused_step": 0, "ta_update": 0,
                                   "ta_update_sparse": 0, "clause_eval": 0,
                                   "tm_infer": 0, "ta_update_streamed": 0,
                                   "lfsr_bits": 0, "threefry_bits": 0,
                                   "step_prologue": 0, "step_epilogue": 0}
    with pytest.raises(ValueError):
        packed_clause_eval(lit, inc.cpu())
    with pytest.raises(TypeError):
        class_sum(lit.to(torch.int64), inc)


def test_server_on_card_matches_cpu(dev):
    roster = {"a": api.TMSpec.coalesced(features=40, classes=5, clauses=64),
              "b": api.TMSpec.vanilla(features=33, classes=3, clauses=10),
              "c": api.TMSpec.regression(features=40, clauses=30, T=20)}
    tile = api.tile_for(*roster.values())
    rng = np.random.default_rng(0)
    servers = {}
    for device in ("cpu", "cuda"):
        for slot in (2, 16):
            eng = api.compile(tile, device=device)
            srv = TMServer(eng, batch_slot=slot)
            for i, (name, spec) in enumerate(roster.items()):
                cfg = spec.tm_config()
                ta = np.random.default_rng(i).integers(
                    0, 128, (cfg.total_clauses, cfg.literals))
                ta[:, :2] = 200                     # two includes per row
                w = None if spec.kind != "coalesced" else np.random.default_rng(
                    i).integers(-3, 4, (cfg.classes, cfg.clauses))
                srv.register(name, spec,
                             program=eng.lower(spec, ta=ta, weights=w))
            servers[device, slot] = srv
    xs = {n: (rng.random((16, s.features)) < 0.5).astype(np.int8)
          for n, s in roster.items()}
    for slot in (2, 16):
        outs = []
        for device in ("cpu", "cuda"):
            srv = servers[device, slot]
            for n, x in xs.items():
                srv.enqueue(n, x[:slot])
            outs.append(srv.flush())
            outs.append({n: srv.predict(n, x[:slot]) for n, x in xs.items()})
        for a, b in ((outs[0], outs[2]), (outs[1], outs[3])):
            for n in roster:
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def _front_operands(K, B, R, W, H, dev, seed, frozen):
    gen = torch.Generator().manual_seed(seed)
    lit, inc = _operands(K, B, R, W, dev, seed=seed)
    w = torch.randint(-9, 10, (K, H, R), generator=gen, dtype=torch.int32)
    w[:, :, ::3] = 0
    labels = torch.randint(0, H, (K, B), generator=gen, dtype=torch.int32)
    neg = (labels + 1) % H
    rand = torch.randint(0, 1 << 16, (K, 2, B, R), generator=gen)
    cl_mask = (torch.arange(R) < R - R // 5).to(torch.int32).expand(K, R)
    h_mask = (torch.arange(H) < max(H - 2, 1)).to(torch.int32).expand(K, H)
    T = torch.randint(1, 60, (K,), generator=gen, dtype=torch.int32)
    wf = torch.full((K,), int(frozen), dtype=torch.int32)
    return [t.to(dev) for t in (lit, inc, w, labels, neg, rand, cl_mask,
                                h_mask, T, wf)]


@pytest.mark.parametrize("K,B,R,W,H", [(1, 1, 1, 1, 1), (1, 3, 17, 2, 3),
                                       (2, 5, 130, 5, 4), (3, 33, 200, 3, 19),
                                       (1, 32, 2048, 52, 16),
                                       (2, 7, 64, 101, 40)])
@pytest.mark.parametrize("frozen", [False, True])
def test_fused_step_kernel_matches_plain(dev, K, B, R, W, H, frozen):
    args = _front_operands(K, B, R, W, H, dev, K + B + R + W + H, frozen)
    for n_bits in (32 * W, 32 * W - 3):
        got = fused_step(*args, rand_bits=16, n_bits=n_bits)
        torch.cuda.synchronize()
        want = fused_step_plain(*args, rand_bits=16, n_bits=n_bits)
        for name, g, w in zip(("clause", "sums", "sel_lab", "sel_neg"),
                              got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), name
    assert R < 17 or got[2].sum() > 0, "some clauses must be selected"


def test_fused_step_takes_strided_operands(dev):
    args = _front_operands(2, 6, 40, 3, 5, dev, 1, False)
    rand_t = args[5].transpose(2, 3).contiguous().transpose(2, 3)
    strided = args[:5] + [rand_t] + args[6:]
    want = fused_step_plain(*args)
    for g, w in zip(fused_step(*strided), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        fused_step(*args[:5], args[5].cpu(), *args[6:])


# The cluster geometry of fused_step and class_sum: R below one block's
# share, R not a multiple of the 256-row tile or the class_sum span, R
# past one cluster's worth (4224 and 4100 = 17 tiles of 256), B off the
# batch tile (1, 5, 33), K=3, H=1, 20 and 40, W=1 and 101 (two staged word
# chunks).  fused_step stages the include rows two ways: one bulk copy a
# warp (W=4, 52, 100) and 4-byte copies (W or R not a multiple of 4, or
# W=256: the whole rows do not fit in shared memory).
FRONT_GEOMETRY = [(1, 1, 17, 1, 1), (1, 5, 300, 3, 40), (3, 33, 4224, 4, 16),
                  (2, 33, 1000, 101, 5), (1, 32, 2048, 52, 16),
                  (3, 1, 129, 8, 1), (2, 7, 512, 100, 20),
                  (1, 5, 4100, 256, 3)]


def _select_operands(K, B, R, W, H, dev, seed, rand_bits, t_max, frozen):
    """Front-half operands whose selection runs at its arithmetic edges:
    random words of ``rand_bits`` bits, T up to ``t_max`` (8000 makes
    ``p_num << rand_bits`` wrap in int32 at 24 bits), weights up to ±2047
    so the class sums leave [-T, T], and ``frozen`` per program."""
    gen = torch.Generator().manual_seed(seed)
    lit, inc = _operands(K, B, R, W, dev, seed=seed)
    w = torch.randint(-2047, 2048, (K, H, R), generator=gen,
                      dtype=torch.int32)
    w[:, :, ::3] = 0
    labels = torch.randint(0, H, (K, B), generator=gen, dtype=torch.int32)
    neg = (labels + 1) % H
    rand = torch.randint(0, 1 << rand_bits, (K, 2, B, R), generator=gen,
                         dtype=torch.int32)
    cl_mask = (torch.arange(R) < R - R // 5).to(torch.int32).expand(K, R)
    h_mask = (torch.arange(H) < max(H - 2, 1)).to(torch.int32).expand(K, H)
    T = torch.randint(max(t_max // 2, 1), t_max + 1, (K,), generator=gen,
                      dtype=torch.int32)
    wf = torch.tensor(frozen, dtype=torch.int32)
    return [t.contiguous().to(dev) for t in (lit, inc, w, labels, neg, rand,
                                             cl_mask, h_mask, T, wf)]


def _same_front(args, rand_bits=16, n_bits=None):
    got = fused_step(*args, rand_bits=rand_bits, n_bits=n_bits)
    torch.cuda.synchronize()
    want = fused_step_plain(*args, rand_bits=rand_bits, n_bits=n_bits)
    for name, g, w in zip(("clause", "sums", "sel_lab", "sel_neg"), got,
                          want):
        assert g.dtype == torch.int32 and torch.equal(g, w), name
    return got


@pytest.mark.parametrize("K,B,R,W,H", FRONT_GEOMETRY)
def test_fused_step_cluster_geometry_matches_plain(dev, K, B, R, W, H):
    args = _front_operands(K, B, R, W, H, dev, 7 * K + B + R + W + H,
                           False)
    args[9] = (torch.arange(K, device=dev) % 2).to(torch.int32)
    for n_bits in (32 * W, 32 * W - 7 if W > 1 else 25):
        _same_front(args, n_bits=n_bits)


@pytest.mark.parametrize("rand_bits", [8, 16, 24])
@pytest.mark.parametrize("t_max", [60, 8000])
def test_fused_step_selection_edges_match_plain(dev, rand_bits, t_max):
    args = _select_operands(3, 33, 300, 4, 10, dev, rand_bits + t_max,
                            rand_bits, t_max, [0, 1, 1])
    got = _same_front(args, rand_bits=rand_bits, n_bits=120)
    assert got[2].sum() > 0 and got[3].sum() > 0


def test_fused_step_is_one_launch_without_scratch(dev):
    """A call on the engine's operands (contiguous int32) launches one
    kernel and nothing else: no fill, no cast, no copy."""
    from torch.profiler import ProfilerActivity, profile
    args = _select_operands(1, 32, 2048, 52, 16, dev, 3, 16, 500, [0])
    fused_step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_step(*args)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(kernels) == 1 and "fused_step" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 3, kernels


def test_fused_step_takes_unaligned_include_words(dev):
    """An include view off 16-byte alignment takes the 4-byte copies."""
    args = _select_operands(1, 6, 512, 52, 16, dev, 9, 16, 500, [1])
    base = torch.zeros(args[1].numel() + 1, dtype=torch.int32, device=dev)
    base[1:] = args[1].reshape(-1)
    shifted = args[:1] + [base[1:].view(args[1].shape)] + args[2:]
    want = fused_step_plain(*args)
    for g, w in zip(fused_step(*shifted), want):
        assert torch.equal(g, w)


def test_prepare_fused_step_is_the_bare_launch(dev):
    args = _select_operands(2, 5, 300, 3, 7, dev, 4, 16, 60, [1, 0])
    want = fused_step(*args)
    before = fused_step.launches
    launch, got = prepare_fused_step(*args)
    assert fused_step.launches == before
    launch()
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bare_launches_hold_their_outputs(dev):
    """A bare launch whose outputs the caller dropped still writes into
    live memory: ``torch.cuda.graph`` empties the allocator's cache before
    a capture, which would release the freed memory to CUDA."""
    from repro_torch.kernels.tm_infer import prepare_tm_infer
    args = _select_operands(2, 5, 300, 3, 7, dev, 4, 16, 60, [1, 0])
    gen = torch.Generator().manual_seed(3)
    lit = (torch.rand((1, 4, 100), generator=gen) < 0.5).to(torch.int8)
    inc = (torch.rand((1, 64, 100), generator=gen) < 0.05).to(torch.int8)
    w = torch.randint(-3, 4, (1, 5, 64), generator=gen, dtype=torch.int32)
    for launch, outs in (prepare_fused_step(*args),
                         prepare_tm_infer(lit.to(dev), inc.to(dev),
                                          w.to(dev))):
        ptrs = {t.data_ptr() for t in
                (outs if isinstance(outs, tuple) else (outs,))}
        del outs
        kept = {t.data_ptr() for t in
                torch.utils._pytree.tree_leaves(launch.keep)
                if isinstance(t, torch.Tensor)}
        assert ptrs <= kept
        torch.cuda.empty_cache()
        launch()
        torch.cuda.synchronize()


@pytest.mark.parametrize("K,B,R,H", [(1, 1, 50, 1), (1, 5, 300, 40),
                                     (3, 33, 4224, 16), (1, 1, 4224, 16),
                                     (1, 32, 2048, 16), (2, 5, 4101, 1),
                                     (1, 33, 130, 40), (4, 32, 4224, 16)])
def test_class_sum_cluster_geometry_matches_plain(dev, K, B, R, H):
    gen = torch.Generator().manual_seed(3 * K + B + R + H)
    cl = torch.randint(0, 2, (K, B, R), generator=gen,
                       dtype=torch.int32).to(dev)
    w = torch.randint(-2047, 2048, (K, H, R), generator=gen,
                      dtype=torch.int32).to(dev)
    got = class_sum(cl, w)
    torch.cuda.synchronize()
    assert torch.equal(got, class_sum_plain(cl, w))


def test_class_sum_takes_strided_and_unaligned_operands(dev):
    """Program strides off a multiple of 4 and a pointer off 16-byte
    alignment take the scalar loads."""
    gen = torch.Generator().manual_seed(5)
    cl = torch.randint(0, 2, (3, 6, 257), generator=gen,
                       dtype=torch.int32).to(dev)
    w = torch.randint(-9, 10, (3, 5, 257), generator=gen,
                      dtype=torch.int32).to(dev)
    want = class_sum_plain(cl, w)
    base = torch.zeros(cl.numel() + 1, dtype=torch.int32, device=dev)
    base[1:] = cl.reshape(-1)
    assert torch.equal(class_sum(base[1:].view(cl.shape), w), want)
    pad = torch.zeros((3, 7, 257), dtype=torch.int32, device=dev)
    pad[:, :6] = cl
    assert torch.equal(class_sum(pad[:, :6], w), want)


def _ta_operands(K, B2, C, L, dev, seed, ta_bits):
    gen = torch.Generator().manual_seed(seed)
    n = 1 << ta_bits
    ta = torch.randint(0, n, (K, C, L), generator=gen,
                       dtype=torch.int32).to(torch.uint8 if ta_bits <= 8
                                             else torch.int32)
    bits = torch.randint(0, 2, (K, B2, L), generator=gen, dtype=torch.int8)
    lits = pack_literals(bits)
    cl = torch.randint(0, 2, (K, B2, C), generator=gen, dtype=torch.int8)
    t1 = (torch.rand((K, B2, C), generator=gen) < 0.2).to(torch.int8)
    t2 = (torch.rand((K, B2, C), generator=gen) < 0.2).to(torch.int8)
    t1[:, :, C // 2:] = 0               # half the rows get no feedback
    t2[:, :, C // 2:] = 0
    l_mask = (torch.arange(L) < L - 3).to(torch.int32).expand(K, L)
    seed_ = torch.randint(0, 2 ** 32, (K,), generator=gen, dtype=torch.int64)
    p_ta = torch.full((K,), 6554, dtype=torch.int32)
    boost = torch.arange(K) % 2 == 0
    n_states = torch.full((K,), n, dtype=torch.int32)
    return ([t.to(dev) for t in (ta, lits, cl, t1, t2, l_mask)],
            [t.to(dev) for t in (seed_, p_ta, boost, n_states)])


STREAMS = [dict(prng="counter"), dict(prng="lfsr", lfsr_bits=24),
           dict(prng="lfsr", lfsr_bits=4),
           dict(prng="lfsr", lfsr_bits=4, seed_refresh=False)]


@pytest.mark.parametrize("K,B2,C,L", [(1, 2, 1, 1), (2, 6, 37, 300),
                                      (3, 64, 130, 257), (1, 64, 256, 1664)])
@pytest.mark.parametrize("ta_bits", [8, 10])
@pytest.mark.parametrize("stream", range(len(STREAMS)))
def test_ta_update_kernels_match_plain(dev, K, B2, C, L, ta_bits, stream):
    ops_, scal = _ta_operands(K, B2, C, L, dev, K + C + L + stream, ta_bits)
    kw = STREAMS[stream]
    for row0 in (0, 300):
        got = ta_update(*ops_, *scal, row0=row0, **kw)
        torch.cuda.synchronize()
        want = ta_update_plain(*ops_, *scal, row0=row0, **kw)
        assert got[0].dtype == ops_[0].dtype
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    inc = got[1]
    G = -(-C // 128)
    idx = torch.tensor([[g % G for g in (0, 0, G - 1)]] * K,
                       dtype=torch.int32, device=dev)      # a duplicate
    for count in ([0] * K, [min(3, G + 1)] * K, list(range(K))):
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        got = ta_update_sparse(*ops_, inc, idx, cnt, *scal, **kw)
        torch.cuda.synchronize()
        want = ta_update_sparse_plain(*ops_, inc, idx, cnt, *scal, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # in place, the duplicate slot must not update its group twice
        ta_i, inc_i = ops_[0].clone(), inc.clone()
        got = ta_update_sparse(ta_i, *ops_[1:], inc_i, idx, cnt, *scal,
                               inplace=True, **kw)
        assert got[0] is ta_i and got[1] is inc_i
        assert torch.equal(ta_i, want[0]) and torch.equal(inc_i, want[1])
    # every group listed: the dense result
    full = torch.arange(G, dtype=torch.int32, device=dev).expand(K, G)
    cnt = torch.full((K,), G, dtype=torch.int32, device=dev)
    dense = ta_update(*ops_, *scal, **kw)
    for g, w in zip(ta_update_sparse(*ops_, inc, full, cnt, *scal, **kw),
                    dense):
        assert torch.equal(g, w)


def test_ta_update_takes_strided_feedback(dev):
    ops_, scal = _ta_operands(2, 8, 40, 96, dev, 5, 8)
    t1 = ops_[3].transpose(1, 2).contiguous().transpose(1, 2)
    want = ta_update_plain(*ops_, *scal)
    got = ta_update(*ops_[:3], t1, *ops_[4:], *scal)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        ta_update(ops_[0].cpu(), *ops_[1:], *scal)


def _bridge(spec, tile, device, seed=3):
    eng = api.compile(tile, device=device)
    tm = api.TM(spec, engine=eng, seed=seed)
    return eng, tm.program, tm.prng


@pytest.mark.parametrize("backend", ["counter", "lfsr"])
@pytest.mark.parametrize("B", [1, 32])
def test_train_steps_on_card_match_cpu(dev, backend, B):
    spec = api.TMSpec.coalesced(features=40, classes=5, clauses=300, T=20,
                                prng_backend=backend)
    tile = api.tile_for(spec)
    cpu, p_c, r_c = _bridge(spec, tile, "cpu")
    gpu = api.compile(tile, device="cuda")
    p_g, r_g = p_c.to(dev), r_c.to(dev)
    rng = np.random.default_rng(B)
    ops.reset_launch_counts()
    for _ in range(3):
        x = (rng.random((B, 40)) < 0.5).astype(np.int8)
        y = spec.encode_labels(rng.integers(0, 5, B))
        p_c, r_c, s_c = cpu.train_step(p_c, r_c, cpu.encode(spec, x), y)
        p_g, r_g, s_g = gpu.train_step(p_g, r_g, gpu.encode(spec, x),
                                       y.to(dev))
        for a, b in zip(p_c.leaves(), p_g.leaves()):
            assert torch.equal(a, b.cpu())
        for a, b in zip(r_c.leaves(), r_g.leaves()):
            assert torch.equal(a, b.cpu())
        for k in s_c:
            assert int(s_c[k]) == int(s_g[k]), k
    counts = ops.launch_counts()
    front = "fused_step" if B > 4 else "packed_clause_eval"
    assert counts[front] == 3 and counts["ta_update_sparse"] == 3


def _dense_operands(K, B, C, L, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    lit = (torch.rand((K, B, L), generator=gen) < 0.7).to(torch.int8)
    inc = (torch.rand((K, C, L), generator=gen) < 0.01).to(torch.int8)
    inc[:, ::7] = 0                      # empty clauses: the eval-mode gate
    lit[:, :, :2] = 1
    inc[:, 1::5, :] = 0
    inc[:, 1::5, :2] = 1                 # clauses that fire
    return lit.to(dev), inc.to(dev)


DENSE = [(1, 1, 1, 1), (1, 5, 130, 200), (2, 32, 64, 16), (3, 33, 65, 257),
         (4, 32, 4224, 3200), (1, 32, 2048, 1664), (2, 70, 300, 1000)]


@pytest.mark.parametrize("K,B,C,L", DENSE)
@pytest.mark.parametrize("eval_mode", [False, True])
def test_clause_eval_kernel_matches_plain(dev, K, B, C, L, eval_mode):
    lit, inc = _dense_operands(K, B, C, L, dev, K + B + C + L)
    want = clause_eval_plain(lit, inc, eval_mode)
    got = clause_eval(lit, inc, eval_mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if C > 1:
        assert 0 < int(want.sum()) < want.numel()
    # rows one byte off 16-byte alignment: the byte-load staging
    base = torch.zeros(inc.numel() + 1, dtype=torch.int8, device=dev)
    base[1:] = inc.reshape(-1)
    assert torch.equal(clause_eval(lit, base[1:].view(inc.shape), eval_mode),
                       want)


@pytest.mark.parametrize("K,B,C,L,H", [(1, 1, 1, 1, 1), (2, 5, 130, 200, 7),
                                       (4, 32, 4224, 3200, 16),
                                       (3, 33, 65, 257, 19),
                                       (1, 40, 300, 96, 33)])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_tm_infer_kernel_matches_plain(dev, K, B, C, L, H, eval_mode):
    lit, inc = _dense_operands(K, B, C, L, dev, K * B + C + H)
    gen = torch.Generator().manual_seed(H)
    w = torch.randint(-2047, 2048, (K, H, C), generator=gen,
                      dtype=torch.int32).to(dev)
    got = tm_infer(lit, inc, w, eval_mode)
    torch.cuda.synchronize()
    assert torch.equal(got, tm_infer_plain(lit, inc, w, eval_mode))
    assert torch.equal(got, class_sum(clause_eval(lit, inc, eval_mode), w))


@pytest.mark.parametrize("K,B2,C,L", [(1, 2, 1, 1), (2, 6, 37, 300),
                                      (1, 64, 256, 1664), (2, 64, 130, 257)])
@pytest.mark.parametrize("ta_bits", [8, 10])
@pytest.mark.parametrize("stream", range(len(STREAMS)))
def test_ta_update_streamed_kernel_matches_plain(dev, K, B2, C, L, ta_bits,
                                                 stream):
    ops_, scal = _ta_operands(K, B2, C, L, dev, K + C + L + stream, ta_bits)
    kw = STREAMS[stream]
    rands = stream_rands(K, B2, C, L, scal[0], dev, 300, **kw)
    got = ta_update_streamed(*ops_, rands, *scal[1:])
    torch.cuda.synchronize()
    want = ta_update_streamed_plain(*ops_, rands, *scal[1:])
    inkernel = ta_update(*ops_, *scal, row0=300, **kw)
    for g, w, i in zip(got, want, inkernel):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, i)
    # the engine's op builds the same stream itself
    for g, w in zip(ops.ta_update_op(*ops_, *scal, row0=300, stream=True,
                                     **kw), want):
        assert torch.equal(g, w)


def test_dense_kernels_raise_and_never_fall_back(dev, monkeypatch):
    ops.reset_launch_counts()
    lit, inc = _dense_operands(1, 3, 40, 64, dev, 0)
    w = torch.ones((1, 2, 40), dtype=torch.int32, device=dev)
    ops_, scal = _ta_operands(1, 4, 40, 64, dev, 1, 8)
    rands = stream_rands(1, 4, 40, 64, scal[0], dev)
    with pytest.raises(ValueError):
        clause_eval(lit, inc.cpu())
    with pytest.raises(ValueError):
        ta_update_streamed(*ops_, rands.cpu(), *scal[1:])
    # a launch the card refuses (a grid y of 65536 batch blocks) raises
    big = torch.ones((1, 32 * 65536, 1), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError):
        clause_eval(big, torch.ones((1, 1, 1), dtype=torch.int8,
                                    device=dev))

    def broken(name):
        raise _build.KernelBuildError(f"{name} did not build")
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(_build.KernelBuildError):
        clause_eval(lit, inc)
    with pytest.raises(_build.KernelBuildError):
        tm_infer(lit, inc, w)
    with pytest.raises(_build.KernelBuildError):
        ta_update_streamed(*ops_, rands, *scal[1:])
    assert ops.launch_counts()["clause_eval"] == 0
    assert ops.launch_counts()["tm_infer"] == 0
    assert ops.launch_counts()["ta_update_streamed"] == 0


@pytest.mark.parametrize("force", [dict(kernel_path="mxu"),
                                   dict(ta_prng="stream"),
                                   dict(kernel_path="mxu", ta_prng="stream")])
def test_dense_and_stream_paths_on_card_match_cpu(dev, force):
    spec = api.TMSpec.coalesced(features=40, classes=5, clauses=300, T=20,
                                prng_backend="lfsr")
    tile = api.tile_for(spec)
    cpu, p_c, r_c = _bridge(spec, tile, "cpu")
    gpu = api.compile(tile, device="cuda", **force)
    p_g, r_g = p_c.to(dev), r_c.to(dev)
    rng = np.random.default_rng(7)
    ops.reset_launch_counts()
    for B in (3, 32):
        x = (rng.random((B, 40)) < 0.5).astype(np.int8)
        y = spec.encode_labels(rng.integers(0, 5, B))
        s_c, c_c = cpu.infer(p_c, cpu.encode(spec, x))
        s_g, c_g = gpu.infer(p_g, gpu.encode(spec, x))
        assert torch.equal(s_c, s_g.cpu()) and torch.equal(c_c, c_g.cpu())
        p_c, r_c, st_c = cpu.train_step(p_c, r_c, cpu.encode(spec, x), y)
        p_g, r_g, st_g = gpu.train_step(p_g, r_g, gpu.encode(spec, x),
                                        y.to(dev))
        for a, b in zip(p_c.leaves() + r_c.leaves(),
                        p_g.leaves() + r_g.leaves()):
            assert torch.equal(a, b.cpu())
        for k in st_c:
            assert int(st_c[k]) == int(st_g[k]), k
    counts = ops.launch_counts()
    if force.get("kernel_path") == "mxu":
        assert counts["clause_eval"] == 4 and counts["fused_step"] == 0
    if force.get("ta_prng") == "stream":
        assert counts["ta_update_streamed"] == 2
        assert counts["ta_update_sparse"] == counts["ta_update"] == 0


# ---- the streaming clause_eval: tile, split and alignment edges ------------

EDGE_L = [1, 15, 16, 17, 31, 32, 33, 513, 1664, 3200]


@pytest.mark.parametrize("L", EDGE_L)
@pytest.mark.parametrize("B", [1, 32, 33, 70])
@pytest.mark.parametrize("C", [127, 128, 129])
def test_clause_eval_stream_edges(dev, L, B, C):
    """Tile edges (32 batch rows, 128 clauses), every split the chooser
    makes at these shapes, both modes, bytes other than 0 and 1, and a
    view one byte off 16-byte alignment."""
    from repro_torch.kernels.clause_eval import clause_split, sm_count
    gen = torch.Generator().manual_seed(L * 1000 + B * 10 + C)
    K = 2
    lit = torch.randint(-128, 128, (K, B, L), generator=gen,
                        dtype=torch.int8)
    lit[torch.rand((K, B, L), generator=gen) < 0.3] = 0
    inc = torch.randint(-128, 128, (K, C, L), generator=gen,
                        dtype=torch.int8)
    inc[torch.rand((K, C, L), generator=gen) < 0.97] = 0
    inc[:, ::5] = 0                              # empty rows
    inc[:, 1::6] = 0
    inc[:, 1::6, 0] = 7                          # one-literal clauses
    lit, inc = lit.to(dev), inc.to(dev)
    splits, _ = clause_split(K, B, C, L, sm_count(0))
    for eval_mode in (False, True):
        want = clause_eval_plain(lit, inc, eval_mode)
        got = clause_eval(lit, inc, eval_mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (splits, eval_mode)
        base = torch.zeros(lit.numel() + 1, dtype=torch.int8, device=dev)
        base[1:] = lit.reshape(-1)
        assert torch.equal(clause_eval(base[1:].view(lit.shape), inc,
                                       eval_mode), want)
    assert 0 < int(want.sum()) < want.numel()


def test_clause_eval_stream_bank_and_many_batch_tiles(dev):
    lit, inc = _dense_operands(5, 70, 4225, 3200, dev, 11)
    for eval_mode in (False, True):
        assert torch.equal(clause_eval(lit, inc, eval_mode),
                           clause_eval_plain(lit, inc, eval_mode))


@pytest.mark.parametrize("L", [65553, 65664])
def test_clause_eval_stream_past_64k_literals(dev, L):
    """L above 65,536 literals: each split packs its literals in two
    ranges.  A third of the clauses have their includes in second ranges
    only; both alignments (65553 and the view one byte off load bytes,
    65664 copies 16 bytes), both modes."""
    from repro_torch.kernels.clause_eval import (CHUNK, MAX_CHUNKS,
                                                 clause_split, sm_count)
    K, B, C = 2, 33, 130
    splits, cps = clause_split(K, B, C, L, sm_count(0))
    assert cps > MAX_CHUNKS
    second = torch.cat([torch.arange(CHUNK * (s * cps + MAX_CHUNKS),
                                     min(CHUNK * (s + 1) * cps, L))
                        for s in range(splits)
                        if CHUNK * (s * cps + MAX_CHUNKS) < L])
    gen = torch.Generator().manual_seed(L)
    lit = (torch.rand((K, B, L), generator=gen) < 0.75).to(torch.int8) * 3
    inc = torch.zeros((K, C, L), dtype=torch.int8)
    pos = torch.randint(0, L, (K, C, 2), generator=gen)
    pos[:, ::3] = second[torch.randint(0, len(second), (K, -(-C // 3), 2),
                                       generator=gen)]
    inc.scatter_(2, pos, -5)
    inc[:, 1::11] = 0                            # empty rows
    lit, inc = lit.to(dev), inc.to(dev)
    base = torch.zeros(lit.numel() + 1, dtype=torch.int8, device=dev)
    base[1:] = lit.reshape(-1)
    for eval_mode in (False, True):
        want = clause_eval_plain(lit, inc, eval_mode)
        assert torch.equal(clause_eval(lit, inc, eval_mode), want)
        assert torch.equal(clause_eval(base[1:].view(lit.shape), inc,
                                       eval_mode), want)
        late = want[:, :, ::3]
        assert 0 < int(late.sum()) < late.numel()


def test_clause_eval_many_clusters_back_to_back(dev):
    """K > 1 and several clusters per SM, launched back to back on one
    stream: each split writes rank 0's shared memory only once every split
    of its cluster has started, so every launch gives the plain result."""
    from repro_torch.kernels.clause_eval import clause_split, sm_count
    K, B, C, L = 3, 40, 600, 1664
    assert clause_split(K, B, C, L, sm_count(0))[0] > 1
    lit, inc = _dense_operands(K, B, C, L, dev, 5)
    want = clause_eval_plain(lit, inc, True)
    outs = [clause_eval(lit, inc, True) for _ in range(64)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


# ---- the redesigned ta_update_sparse: slots, batch sizes, streams, scalars --

SPARSE_B2 = [2, 64, 66, 130]


@pytest.mark.parametrize("B2", SPARSE_B2)
@pytest.mark.parametrize("ta_bits", [8, 10])
@pytest.mark.parametrize("stream", range(len(STREAMS)))
def test_ta_update_sparse_redesign_edges(dev, B2, ta_bits, stream):
    K, C, L = 2, 300, 257                 # 3 groups, the last one ragged
    ops_, scal = _ta_operands(K, B2, C, L, dev, B2 + ta_bits + stream,
                              ta_bits)
    kw = STREAMS[stream]
    seeds = torch.tensor([2 ** 31 + 12345, 2 ** 32 - 7], dtype=torch.int64)
    inc = ta_update(*ops_, *scal, **kw)[1]
    G = 3
    # slot lists: a duplicate, a negative entry, a group past C, and
    # garbage after the count
    idx = torch.tensor([[2, -1, 2, 0, 7, 1, 99], [G, 1, 1, -5, 0, 2, 2]],
                       dtype=torch.int32, device=dev)
    for count in ([0, 0], [4, 3], [7, 7], [2, 0]):
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        for seed, row0 in ((seeds.to(dev), 300),
                           (seeds[:1].to(dev), torch.tensor(
                               [5, 300], dtype=torch.int32, device=dev)),
                           (int(seeds[0]), 0),
                           (torch.tensor(int(seeds[1]), device=dev), 17)):
            args = (*ops_, inc, idx, cnt, seed, *scal[1:])
            want = ta_update_sparse_plain(*args, row0=row0, **kw)
            got = ta_update_sparse(*args, row0=row0, **kw)
            torch.cuda.synchronize()
            assert got[0].dtype == ops_[0].dtype
            assert torch.equal(got[0], want[0]), (count, row0)
            assert torch.equal(got[1], want[1]), (count, row0)
            ta_i, inc_i = ops_[0].clone(), inc.clone()
            got = ta_update_sparse(ta_i, *ops_[1:], inc_i, idx, cnt, seed,
                                   *scal[1:], row0=row0, inplace=True, **kw)
            assert got[0] is ta_i and torch.equal(ta_i, want[0])
            assert torch.equal(inc_i, want[1])


def test_ta_update_sparse_reads_engine_dtypes(dev):
    """int32 feedback (the engine's) and others (their > 0 tests), int64,
    int32 and bool scalars: the same states as int8 feedback."""
    ops_, scal = _ta_operands(1, 64, 256, 1664, dev, 3, 8)
    kw = dict(prng="lfsr", lfsr_bits=24)
    inc = ta_update(*ops_, *scal, **kw)[1]
    idx = torch.arange(2, dtype=torch.int32, device=dev)[None]
    cnt = torch.full((1,), 2, dtype=torch.int32, device=dev)
    want = ta_update_sparse_plain(*ops_, inc, idx, cnt, *scal, **kw)
    for dt in (torch.int32, torch.bool, torch.int64):
        fb = [t.to(dt) for t in ops_[2:5]]
        got = ta_update_sparse(*ops_[:2], *fb, ops_[5], inc, idx, cnt,
                               scal[0], scal[1].to(torch.int64),
                               scal[2].to(torch.int32),
                               scal[3].to(torch.int64), **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ta_update_prepared_launch_counts_and_matches(dev):
    """The bare launch of prepare_* gives the wrapper's result and counts."""
    from repro_torch.kernels import ta_update as tu
    ops_, scal = _ta_operands(1, 8, 130, 100, dev, 4, 8)
    inc = ta_update(*ops_, *scal)[1]
    idx = torch.tensor([[1, 0]], dtype=torch.int32, device=dev)
    cnt = torch.full((1,), 2, dtype=torch.int32, device=dev)
    want = ta_update_sparse(*ops_, inc, idx, cnt, *scal)
    n = ta_update_sparse.launches
    launch, got = tu.prepare_ta_update_sparse(*ops_, inc, idx, cnt, *scal)
    launch()
    torch.cuda.synchronize()
    assert ta_update_sparse.launches == n + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- the dense and streamed updates on the shared body: edges -------------

def _u32_words(values):
    """int32 bit patterns of uint32 values."""
    v = torch.as_tensor(values, dtype=torch.int64)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


@pytest.mark.parametrize("B2", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("C", [37, 130])
@pytest.mark.parametrize("L", [1, 257, 300])
@pytest.mark.parametrize("ta_bits", [8, 10])
def test_ta_update_dense_and_streamed_edges(dev, B2, C, L, ta_bits):
    """2B on either side of and across the 64-row chunk; C not a multiple
    of 4 (the feedback's non-vector load) or of 128; L with word-chunk
    tails; every stream, lfsr4 with a refresh inside the call where
    2B >= 15; the engine's int32 feedback."""
    ops_, scal = _ta_operands(2, B2, C, L, dev, 1000 * B2 + C + L + ta_bits,
                              ta_bits)
    ops_[2:5] = [t.to(torch.int32) for t in ops_[2:5]]
    row0s = (0, torch.tensor([5, 300], dtype=torch.int32, device=dev))
    for kw in STREAMS:
        for row0 in row0s:
            got = ta_update(*ops_, *scal, row0=row0, **kw)
            torch.cuda.synchronize()
            want = ta_update_plain(*ops_, *scal, row0=row0, **kw)
            assert got[0].dtype == ops_[0].dtype
            assert torch.equal(got[0], want[0]), (kw, row0)
            assert torch.equal(got[1], want[1]), (kw, row0)
        rands = stream_rands(2, B2, C, L, scal[0], dev, row0s[1], **kw)
        got_s = ta_update_streamed(*ops_, rands, *scal[1:])
        torch.cuda.synchronize()
        want_s = ta_update_streamed_plain(*ops_, rands, *scal[1:])
        for g, w, i in zip(got_s, want_s, got):
            assert g.dtype == w.dtype and torch.equal(g, w), kw
            assert torch.equal(g, i), kw


def test_ta_update_dense_and_streamed_scalar_forms(dev):
    """K=3 with per-program scalars as int64, int32, bool and other
    tensors, 0-d and [1] tensors, Python ints, uint32 values >= 2^31."""
    K, B2, C, L = 3, 66, 130, 300
    ops_, _ = _ta_operands(K, B2, C, L, dev, 33, 10)
    big = [2 ** 31 + 5, 2 ** 32 - 1, 2 ** 31]
    t = lambda v, dt=torch.int64: torch.tensor(v, dtype=dt, device=dev)
    forms = [
        (t(big), t([6554, 2 ** 16, 7], torch.int32),
         t([True, False, True], torch.bool), t(1024), 300),
        (big[1], t(6554, torch.int32), True, t([1024], torch.int32),
         t([0, 5, 300])),
        (_u32_words(big).to(dev), t([0, 6554, 2 ** 32 - 1]),
         t([1, 0, 2], torch.int8), 1024, t(7, torch.int32)),
        (t([big[0]]), t([6554]), t([False], torch.bool), t(512, torch.int16),
         t([9], torch.int32))]
    for f in forms:
        for kw in STREAMS[:2]:
            got = ta_update(*ops_, *f, **kw)
            torch.cuda.synchronize()
            want = ta_update_plain(*ops_, *f, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            rands = stream_rands(K, B2, C, L, f[0], dev, f[4], **kw)
            got_s = ta_update_streamed(*ops_, rands, *f[1:4])
            torch.cuda.synchronize()
            want_s = ta_update_streamed_plain(*ops_, rands, *f[1:4])
            for g, w, i in zip(got_s, want_s, got):
                assert torch.equal(g, w) and torch.equal(g, i)


@pytest.mark.parametrize("ta_bits", [8, 10])
def test_ta_update_streamed_p_ta_edges(dev, ta_bits):
    """p_ta = 0 (no word is low), p_ta >= 2^rand_bits (every 16-bit word
    is low), words placed at p_ta − 1 and p_ta, and words and p_ta at or
    above 2^31 (an unsigned compare)."""
    K, B2, C, L = 2, 65, 130, 257
    ops_, scal = _ta_operands(K, B2, C, L, dev, 11 + ta_bits, ta_bits)
    gen = torch.Generator().manual_seed(7)
    words = torch.randint(0, 2 ** 16, (K, B2, C, L), generator=gen,
                          dtype=torch.int64)

    def run(w, p):
        a = (*ops_, _u32_words(w).to(dev),
             torch.full((K,), p, dtype=torch.int64, device=dev), *scal[2:])
        got = ta_update_streamed(*a)
        torch.cuda.synchronize()
        want = ta_update_streamed_plain(*a)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return got
    for p in (0, 1, 6554, 2 ** 16, 2 ** 16 + 1, 2 ** 31 + 3, 2 ** 32 - 1):
        w = words.clone()
        if p > 0:
            w[..., ::5] = p - 1
            w[..., 1::5] = p
            w[..., 2::7] = 2 ** 32 - 1
        run(w, p)
    # no word low: p_ta = 0, or every word 2^32 − 1 against that p_ta;
    # every word low: p_ta at 2^16, or every word 0 against p_ta = 1
    none = run(words, 0)
    for g, w in zip(none, run(torch.full_like(words, 2 ** 32 - 1),
                              2 ** 32 - 1)):
        assert torch.equal(g, w)
    every = run(words, 2 ** 16)
    for g, w in zip(every, run(torch.zeros_like(words), 1)):
        assert torch.equal(g, w)
    assert not torch.equal(none[0], every[0])


def test_ta_update_dense_and_streamed_read_engine_dtypes(dev):
    """With the engine's operands (int32 feedback and l_mask, int64/int32/
    bool scalars) the dense and streamed launches take the same tensor
    objects; the bare launch counts and matches; other feedback dtypes
    (their > 0 tests) give the same states."""
    from repro_torch.kernels import ta_update as tu
    ops_, scal = _ta_operands(1, 64, 256, 1664, dev, 3, 8)
    kw = dict(prng="lfsr", lfsr_bits=24)
    eng = [ops_[0], ops_[1], *[t.to(torch.int32) for t in ops_[2:5]],
           ops_[5].contiguous()]
    sc = (scal[0], scal[1].to(torch.int64), scal[2], scal[3])
    want = ta_update_plain(*eng, *sc, **kw)
    rands = stream_rands(1, 64, 256, 1664, scal[0], dev, **kw)
    for wrapper, prep, extra, s_ in (
            (ta_update, tu.prepare_ta_update, (), sc),
            (ta_update_streamed, tu.prepare_ta_update_streamed, (rands,),
             sc[1:])):
        launch, got = prep(*eng, *extra, *s_, **(kw if not extra else {}))
        for t in (*eng, *extra, *s_):
            assert any(k is t for k in launch.keep)
        n = wrapper.launches
        launch()
        torch.cuda.synchronize()
        assert wrapper.launches == n + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for dt in (torch.int8, torch.bool, torch.int64):
            fb = [t.to(dt) for t in eng[2:5]]
            got = wrapper(*eng[:2], *fb, eng[5], *extra, *s_,
                          **(kw if not extra else {}))
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("ta_bits", [8, 10])
def test_ta_update_streamed_full_type1_rows(dev, ta_bits):
    """Rows with Type I feedback from every batch row (64 listed rows a
    chunk: many load rounds), from none, and from the last row of a chunk
    only, across three chunks and a ragged quad."""
    K, B2, C, L = 2, 130, 37, 300
    ops_, scal = _ta_operands(K, B2, C, L, dev, 17 + ta_bits, ta_bits)
    t1 = ops_[3].to(torch.int32)
    t1[:, :, :6] = 1                    # every batch row
    t1[:, :, 6:9] = 0                   # none
    t1[:, :, 9] = 0
    t1[:, 63::64, 9] = 1                # the last row of each chunk
    ops_[3] = t1
    for kw in STREAMS[:2]:
        rands = stream_rands(K, B2, C, L, scal[0], dev, 5, **kw)
        got = ta_update_streamed(*ops_, rands, *scal[1:])
        torch.cuda.synchronize()
        want = ta_update_streamed_plain(*ops_, rands, *scal[1:])
        inkernel = ta_update(*ops_, *scal, row0=5, **kw)
        for g, w, i in zip(got, want, inkernel):
            assert torch.equal(g, w) and torch.equal(g, i)
