"""Kernel-level parity of the PyTorch port with the JAX package (CPU).

The plain versions of the port's kernels (what a CPU tensor runs) must
equal the JAX oracles in ``repro/kernels/ref.py`` exactly, and, at one
tiny shape per kernel, the Pallas kernels in interpret mode.  Also: the
packed literal layout, the import isolation of the port, and the rule
that a CUDA request never falls back to the CPU.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import booleanize as jbool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import booleanize as tbool
from repro_torch.kernels import _build, ops as tops, ref as tref
from repro_torch.kernels.class_sum import class_sum, class_sum_plain
from repro_torch.kernels.packed_clause import (packed_clause_eval,
                                               packed_clause_eval_plain,
                                               packed_clause_tile,
                                               packed_clause_tile_plain)


def _words(rng, shape, density=0.5):
    """Random uint32 words whose bits are set with ``density``."""
    bits = rng.random((*shape, 32)) < density
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def _t(a):
    """numpy uint32/int -> torch (uint32 as int32 bits)."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def _operands(seed, B, C, W):
    rng = np.random.default_rng(seed)
    lit = _words(rng, (B, W), 0.7)
    inc = _words(rng, (C, W), 0.02)
    inc[0] = 0                       # an empty clause: the eval-mode gate
    inc[1] = _words(rng, (W,), 0.0)  # (another)
    return lit, inc


SHAPES = [(1, 12, 1), (3, 17, 2), (4, 40, 3), (5, 33, 4), (32, 70, 5)]


@pytest.mark.parametrize("B,C,W", SHAPES)
@pytest.mark.parametrize("eval_mode", [False, True])
def test_packed_clause_plain_matches_jax_oracles(B, C, W, eval_mode):
    lit, inc = _operands(B * 100 + C, B, C, W)
    n_bits = 32 * W - 7              # ragged literal count: tail masking
    want = np.asarray(jref.packed_clause_eval_ref(
        jnp.asarray(lit), jnp.asarray(inc), eval_mode, n_bits=n_bits))
    want_mxu = np.asarray(jref.packed_clause_mxu_ref(
        jnp.asarray(lit), jnp.asarray(inc), eval_mode, n_bits=n_bits))
    np.testing.assert_array_equal(want, want_mxu)
    assert 0 < want.sum() < want.size, "the case must fire some clauses"
    for fn in (packed_clause_eval, packed_clause_tile,
               packed_clause_eval_plain, packed_clause_tile_plain):
        got = fn(_t(lit)[None], _t(inc)[None], eval_mode, n_bits)
        assert got.dtype == torch.int32 and got.shape == (1, B, C)
        np.testing.assert_array_equal(got[0].numpy(), want,
                                      err_msg=fn.__name__)


def test_packed_clause_bank_axis_is_per_program():
    """K programs in one call equal K separate calls."""
    pairs = [_operands(k, 6, 20, 3) for k in range(3)]
    lit = torch.stack([_t(p[0]) for p in pairs])
    inc = torch.stack([_t(p[1]) for p in pairs])
    for op in (tops.packed_clause_eval_op, tops.packed_clause_mxu_op):
        got = op(lit, inc, eval_mode=True, n_bits=90)
        for k, (lk, ik) in enumerate(pairs):
            want = jref.packed_clause_eval_ref(jnp.asarray(lk),
                                               jnp.asarray(ik), True, 90)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                op(_t(lk), _t(ik), eval_mode=True, n_bits=90).numpy(),
                np.asarray(want))


@pytest.mark.parametrize("jax_op,port_op", [
    (jops.packed_clause_eval_op, tops.packed_clause_eval_op),
    (jops.packed_clause_mxu_op, tops.packed_clause_mxu_op)])
def test_packed_clause_matches_interpret_pallas(jax_op, port_op):
    lit, inc = _operands(7, 3, 9, 5)
    want = jax_op(jnp.asarray(lit), jnp.asarray(inc), eval_mode=True,
                  backend="pallas", n_bits=150)
    got = port_op(_t(lit), _t(inc), eval_mode=True, n_bits=150)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,C,H", [(1, 7, 2), (3, 40, 4), (32, 64, 3)])
def test_class_sum_plain_matches_jax_oracle(B, C, H):
    rng = np.random.default_rng(B + C + H)
    cl = rng.integers(0, 2, (B, C)).astype(np.int32)
    w = rng.integers(-2047, 2048, (H, C)).astype(np.int32)
    want = np.asarray(jref.class_sum_ref(jnp.asarray(cl), jnp.asarray(w)))
    for fn in (class_sum, class_sum_plain):
        got = fn(_t(cl)[None], _t(w)[None])
        assert got.dtype == torch.int32 and got.shape == (1, B, H)
        np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(tops.class_sum_op(_t(cl), _t(w)).numpy(),
                                  want)


def test_class_sum_matches_interpret_pallas():
    rng = np.random.default_rng(3)
    cl = rng.integers(0, 2, (3, 40)).astype(np.int32)
    w = rng.integers(-9, 10, (4, 40)).astype(np.int32)
    want = jops.class_sum_op(jnp.asarray(cl), jnp.asarray(w),
                             backend="pallas")
    np.testing.assert_array_equal(
        tops.class_sum_op(_t(cl), _t(w)).numpy(), np.asarray(want))


def test_dense_clause_eval_oracle():
    rng = np.random.default_rng(5)
    lits = rng.integers(0, 2, (4, 50)).astype(np.int8)
    inc = (rng.random((9, 50)) < 0.05).astype(np.int8)
    inc[0] = 0
    for eval_mode in (False, True):
        want = jref.clause_eval_ref(jnp.asarray(lits), jnp.asarray(inc),
                                    eval_mode)
        got = tref.clause_eval_ref(torch.from_numpy(lits),
                                   torch.from_numpy(inc), eval_mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_pack_unpack_layout_matches_jax(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (3, n)).astype(np.int8)
    want = np.asarray(jbool.pack_literals(jnp.asarray(bits)))
    got = tbool.pack_literals(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tref.pack_bitplane(torch.from_numpy(bits))
                                  .numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tbool.unpack_literals(got, n).numpy(),
                                  bits)
    np.testing.assert_array_equal(
        tref.unpack_bitplanes_i8(got).numpy(),
        np.asarray(jref.unpack_bitplanes_i8(jnp.asarray(want))))


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 95, 96])
def test_tail_mask_matches_jax(n_bits):
    words = _words(np.random.default_rng(0), (2, 3), 0.9)
    want = np.asarray(jref.tail_mask_words(jnp.asarray(words), n_bits))
    got = tref.tail_mask_words(_t(words), n_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_include_and_booleanizer_match_jax():
    rng = np.random.default_rng(1)
    ta = rng.integers(0, 256, (5, 70)).astype(np.int32)
    np.testing.assert_array_equal(
        tref.pack_include(torch.from_numpy(ta), 256).numpy().view(np.uint32),
        np.asarray(jref.pack_include(jnp.asarray(ta), 256)))
    calib = rng.standard_normal((64, 6))
    jb = jbool.fit_thermometer(calib, bits=3)
    tb = tbool.fit_thermometer(calib, bits=3)
    np.testing.assert_array_equal(jb.thresholds, tb.thresholds)
    # raw values ON the cuts: the float32 compare decides the same side
    raw = np.concatenate([rng.standard_normal((8, 6)),
                          jb.thresholds.T.astype(np.float64)])
    np.testing.assert_array_equal(tb(raw).numpy(), np.asarray(jb(raw)))


def test_cpu_ops_launch_no_kernel():
    tops.reset_launch_counts()
    lit, inc = _operands(0, 2, 8, 2)
    tops.packed_clause_eval_op(_t(lit), _t(inc))
    tops.packed_clause_mxu_op(_t(lit), _t(inc))
    assert set(tops.launch_counts().values()) == {0}


def test_select_path_thresholds_and_force():
    assert tops.select_path(1) == tops.select_path(4) == "packed_vpu"
    assert tops.select_path(5) == tops.select_path(32) == "mxu_popcount"
    assert tops.select_path(32, force="packed_vpu") == "packed_vpu"
    with pytest.raises(ValueError):
        tops.select_path(1, force="ref")     # the JAX jnp path: not ported


def test_wrappers_reject_bad_operands():
    lit, inc = _operands(0, 2, 8, 2)
    with pytest.raises(TypeError):
        packed_clause_eval(_t(lit)[None].long(), _t(inc)[None])
    with pytest.raises(ValueError):
        packed_clause_tile(_t(lit)[None], _t(inc)[None, :, :1])
    with pytest.raises(ValueError):
        packed_clause_eval(_t(lit)[None], _t(inc)[None], n_bits=65)
    with pytest.raises(ValueError):
        class_sum(torch.zeros((1, 2, 8), dtype=torch.int32),
                  torch.zeros((1, 3, 7), dtype=torch.int32))
    # neither CPU nor CUDA: no kernel and no plain version
    meta = torch.empty((1, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        packed_clause_eval(meta, meta)
    with pytest.raises(ValueError):
        class_sum(meta, meta)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    with pytest.raises(_build.KernelBuildError):
        _build.find_nvcc(str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(_build.KernelBuildError):
        _build.build(build_dir=tmp_path)
    assert not list(tmp_path.iterdir()), "a failed build leaves nothing"


def test_library_path_tracks_sources(tmp_path):
    a = _build.library_path("packed_clause", tmp_path)
    b = _build.library_path("class_sum", tmp_path)
    assert a.parent == tmp_path and a != b
    assert a == _build.library_path("packed_clause", tmp_path)


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.core.prng', 'repro_torch.core.device',\n"
        "          'repro_torch.kernels.fused_step',\n"
        "          'repro_torch.kernels.ta_update'):\n"
        "    assert m in sys.modules, m\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={**os.environ, "PYTHONPATH": src})
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 18
