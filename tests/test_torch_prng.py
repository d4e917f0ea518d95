"""The port's PRNG against the JAX package's, bit for bit (CPU).

``PRNG.bits`` over consecutive calls and shapes, for the counter backend
and the LFSR cluster at 4 bits (where the seed refresh fires within a
few calls, with and without it) and 24 bits; a stacked bank PRNG against
its programs; the numpy round trip; threefry raising.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng
from repro.core.types import TMConfig as JConfig
from repro_torch import api, convert
from repro_torch.core import prng as tprng
from repro_torch.core.types import TMConfig

CASES = [("counter", 24, True), ("lfsr", 24, True), ("lfsr", 4, True),
         ("lfsr", 4, False), ("lfsr", 12, True)]
SHAPES = [(5,), (2, 3, 4000), (2,), (9000,), (1,), (3, 7), (8192,)]


def jax_prng_numpy(p) -> dict:
    """A JAX ``PRNG`` as the port's numpy PRNG dict."""
    d = {"backend": p.backend, "lfsr_bits": p.lfsr_bits,
         "rand_bits": p.rand_bits, "seed_refresh": p.seed_refresh}
    if p.backend == "lfsr":
        d.update(lanes=np.asarray(p.state.lanes),
                 master=np.asarray(p.state.master),
                 cycles=np.asarray(p.state.cycles))
    else:
        d["state"] = np.asarray(p.state)
    return d


def _assert_same_state(t, j):
    got, want = convert.prng_to_numpy(t), jax_prng_numpy(j)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("backend,lfsr_bits,refresh", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_bits_match_jax_over_consecutive_calls(backend, lfsr_bits, refresh,
                                               seed):
    kw = dict(prng_backend=backend, lfsr_bits=lfsr_bits,
              seed_refresh=refresh)
    j = jprng.PRNG.create(JConfig(**kw), seed)
    t = tprng.PRNG.create(TMConfig(**kw), seed, device="cpu")
    _assert_same_state(t, j)
    for _ in range(3):          # 30+ cycles: the 4-bit refresh fires twice
        for shape in SHAPES:
            j, want = j.bits(shape)
            t, got = t.bits(shape)
            assert got.shape == shape and got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_same_state(t, j)
    if backend == "lfsr" and refresh:
        assert int(t.state.master) != int(tprng.PRNG.create(
            TMConfig(**kw), seed, device="cpu").state.master) \
            or lfsr_bits > 4


@pytest.mark.parametrize("backend", ["counter", "lfsr"])
def test_bank_prng_draws_per_program(backend):
    cfg = TMConfig(prng_backend=backend, lfsr_bits=8)
    singles = [tprng.PRNG.create(cfg, s, n_lanes=64, device="cpu")
               for s in (1, 2, 3)]
    bank = tprng.PRNG.stack(singles)
    assert bank.lead == (3,)
    for shape in [(5,), (2, 40), (3,)]:
        bank, got = bank.bits(shape)
        assert got.shape == (3, *shape)
        for k in range(3):
            singles[k], want = singles[k].bits(shape)
            np.testing.assert_array_equal(got[k].numpy(), want.numpy())
    for k in range(3):
        for a, b in zip(bank[k].leaves(), singles[k].leaves()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tprng.PRNG.stack([singles[0], tprng.PRNG.create(
            TMConfig(prng_backend=backend, lfsr_bits=12), 1, n_lanes=64,
            device="cpu")])


@pytest.mark.parametrize("backend", ["counter", "lfsr"])
def test_numpy_round_trip(backend):
    p = tprng.PRNG.create(TMConfig(prng_backend=backend), 5, device="cpu")
    p, _ = p.bits((100,))
    d = convert.prng_to_numpy(p)
    assert all(d[k].dtype == np.uint32 for k in d
               if isinstance(d[k], np.ndarray))
    back = convert.prng_from_numpy(d, device="cpu")
    assert (back.backend, back.lfsr_bits, back.rand_bits,
            back.seed_refresh) == (p.backend, p.lfsr_bits, p.rand_bits,
                                   p.seed_refresh)
    for a, b in zip(back.leaves(), p.leaves()):
        assert torch.equal(a, b)
    # a JAX PRNG crosses and keeps drawing the same numbers
    j = jprng.PRNG.create(JConfig(prng_backend=backend), 5)
    t = convert.prng_from_numpy(jax_prng_numpy(j), device="cpu")
    j, want = j.bits((3, 11))
    t, got = t.bits((3, 11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError):
        convert.prng_from_numpy({**d, **{k: np.asarray(v, np.int64)
                                         for k, v in d.items()
                                         if isinstance(v, np.ndarray)}},
                                device="cpu")


@pytest.mark.parametrize("backend", ["counter", "lfsr"])
def test_prng_defaults_to_the_card(backend, monkeypatch):
    """Like every entry point of the port, a PRNG made without a device
    is meant for CUDA: without a card that raises instead of silently
    landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TMConfig(prng_backend=backend, lfsr_bits=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprng.PRNG.create(cfg, 1, n_lanes=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprng.make_cluster(1, 64, 8)
    cpu = tprng.PRNG.create(cfg, 1, n_lanes=64, device="cpu")
    assert {t.device.type for t in cpu.leaves()} == {"cpu"}


def test_splitmix_and_xorshift_match_jax():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 1000, dtype=np.uint64)
    xt = torch.from_numpy(x.astype(np.int64))
    xj = jnp.asarray(x.astype(np.uint32))
    np.testing.assert_array_equal(tprng._splitmix32(xt).numpy(),
                                  np.asarray(jprng._splitmix32(xj)))
    np.testing.assert_array_equal(tprng._xorshift32(xt).numpy(),
                                  np.asarray(jprng._xorshift32(xj)))
    assert tprng._TAPS == jprng._TAPS


def test_threefry_raises_a_clear_error():
    cfg = TMConfig(prng_backend="threefry")
    with pytest.raises(NotImplementedError, match="threefry"):
        tprng.PRNG.create(cfg, 0)
    spec = api.TMSpec.coalesced(features=8, classes=2, clauses=16,
                                prng_backend="threefry")
    assert spec.tm_config().prng_backend == "threefry"   # specs still cross
    with pytest.raises(NotImplementedError, match="threefry"):
        api.TM(spec, device="cpu")
    engine = api.compile(api.tile_for(spec), device="cpu")
    prog = engine.lower(spec, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="threefry"):
        engine.bind(prog, spec=spec)
