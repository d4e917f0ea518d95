"""The ``examples/*_torch.py`` mirrors on the CPU, at small sizes.

Each mirror's ``main(argv)`` runs with ``--device cpu`` at a few clauses,
narrow widths and one epoch.  The quickstart's and the head's histories
and accuracies equal the JAX estimator's at the same calls and seed (the
JAX side on its ``ref`` backend); ``dtm_reconfigure_torch``'s scores and
``cache_report()`` equal JAX's after the same run (the counts are the
port's graphs, none captured on the CPU; the paths under the one
documented rename); the two serving mirrors' answers equal a synchronous
``TMServer`` twin's.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from repro_torch import api
from repro_torch.analysis.trace_audit import jax_equivalent
from repro_torch.launch.serve_tm import demo_batch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _mirror(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_mirror", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jspec(spec):
    from repro import api as japi
    return japi.TMSpec.from_dict(spec.to_dict())


def test_quickstart_mirror_equals_jax():
    from repro.api import TM as JTM, TMSpec as JSpec
    from repro.data import MNIST_LIKE as JMNIST
    from repro.data import make_bool_dataset as jdata
    argv = ["--device", "cpu", "--n", "96", "--train", "64",
            "--features", "64", "--clauses", "16", "--epochs", "2",
            "--batch", "16"]
    out = _mirror("quickstart_torch").main(argv)
    assert out["device"] == "cpu"
    x, y = jdata(dataclasses.replace(JMNIST, features=64), 96)
    spec = JSpec.coalesced(features=64, classes=10, clauses=16, T=48, s=6.0)
    tm = JTM(spec, backend="ref", seed=0)
    hist = tm.fit(x[:64], y[:64], epochs=2, batch=16, x_test=x[64:],
                  y_test=y[64:])
    assert out["history"] == hist
    assert out["accuracy"] == tm.score(x[64:], y[64:])


def test_tm_head_mirror_equals_jax():
    from repro.api import TM as JTM, TMSpec as JSpec
    mod = _mirror("tm_head_torch")
    argv = ["--device", "cpu", "--n", "96", "--calib", "32", "--train",
            "64", "--clauses", "16", "--epochs", "2", "--batch", "16"]
    out = mod.main(argv)
    # the mirror's own data, then the JAX script's calls on it
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 96).astype(np.int32)
    means = rng.standard_normal((3, 24)).astype(np.float32) * 1.5
    raw = means[y] + rng.standard_normal((96, 24)).astype(np.float32)
    feats = np.tanh(raw @ rng.standard_normal((24, 8)).astype(np.float32))
    spec = JSpec.head(feats[:32], classes=3, therm_bits=6, clauses=16,
                      T=32, s=4.0)
    head = JTM(spec, backend="ref", seed=0)
    hist = head.fit(feats[:64], y[:64], epochs=2, batch=16)
    assert out["history"] == hist
    assert out["accuracy"] == head.score(feats[64:], y[64:], batch=64)


def test_dtm_reconfigure_mirror_equals_jax():
    from repro import api as japi
    mod = _mirror("dtm_reconfigure_torch")
    out = mod.main(["--device", "cpu", "--n", "0.125", "--scale", "4",
                    "--features", "64", "--epochs", "1", "--batch", "16"])
    roster = mod.models(0.125, 4, 64)
    jspecs = {n: _jspec(spec) for n, (spec, _, _) in roster.items()}
    engine = japi.compile(japi.tile_for(*jspecs.values()), backend="ref")
    for name, (_, (xtr, ytr, xte, yte), _) in roster.items():
        tm = japi.TM(jspecs[name], engine=engine, seed=0)
        tm.fit(xtr, ytr, epochs=1, batch=16)
        assert out["scores"][name] == tm.score(xte, yte, batch=64), name
    want, got = engine.cache_report(), out["cache"]
    assert set(got) == set(want)
    # the stages JAX traced once are the ones the port's graphs stand for;
    # none is captured on the CPU
    assert {k for k, v in want.items() if v == 1} == {
        "infer", "infer_conv", "fit_epoch", "fit_epoch_conv"}
    assert all(v == 0 for k, v in got.items() if k != "path_per_stage")
    assert jax_equivalent({"p": got["path_per_stage"]}) == \
        {"p": want["path_per_stage"]}


def test_serve_stream_mirror_answers_equal_a_synchronous_twin():
    mod = _mirror("serve_stream_torch")
    out = mod.main(["--device", "cpu", "--requests", "16", "--scale", "4"])
    assert out["completed"] == out["submitted"] == 16 + 4
    spec_of = mod.tenants(4)
    roster = {n: s for n, (s, _, _) in spec_of.items()}
    twin = api.serve(roster, batch_slot=mod.B, device="cpu")
    assert len(out["answers"]) == 16
    for name, seed, preds in out["answers"]:
        want = twin.server.predict(name, demo_batch(roster[name], mod.B,
                                                     seed=seed))
        np.testing.assert_array_equal(np.asarray(preds), want,
                                      err_msg=f"{name} {seed}")


def test_train_while_serve_mirror_answers_equal_a_synchronous_twin():
    mod = _mirror("train_while_serve_torch")
    out = mod.main(["--device", "cpu", "--steps", "3", "--scale", "2"])
    assert out["stats"]["retries"] == 1            # the injected fault
    roster = mod.make_roster(2)
    twin = api.serve(roster, batch_slot=mod.B, device="cpu").server
    for step in range(3):
        for name in roster:
            twin.train(name, *mod.batches(roster, name, step))
    for name in roster:
        assert out["steps"][name] == twin.tenants[name].steps == 3
        assert out["continued_steps"][name] == 4
        want = twin.predict(name, demo_batch(roster[name], mod.B, seed=7))
        np.testing.assert_array_equal(np.asarray(out["predictions"][name]),
                                      want, err_msg=name)


def test_batched_predict_pads_the_tail_batch_as_jax_does():
    """The tail batch is padded to the batch size and the padding
    stripped (the JAX package's ``batched_predict``), so ``score`` runs
    the engine's inference at one batch shape: one graph on the card,
    where the unpadded tail made a second (found by
    ``dtm_reconfigure_torch`` at its small size)."""
    from repro.core.evaluate import batched_predict as jbp
    from repro_torch.core.evaluate import batched_predict
    x = np.arange(40 * 3).reshape(40, 3)
    seen = []

    def fn(xb):
        seen.append(xb.shape)
        return xb.sum(axis=1)
    got = batched_predict(fn, x, batch=16)
    assert seen == [(16, 3)] * 3
    np.testing.assert_array_equal(got, jbp(lambda b: b.sum(axis=1), x,
                                           batch=16))
    assert batched_predict(fn, x[:5], batch=16).shape == (5,)
