"""CPU tests of what a configuration file brings to a run: the model
specification whole, the input shape of its tasks and the plain reference
it names, each added to a copy of the benchmark as new files only."""
from __future__ import annotations

import io
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import control, data, drivers, run as bench  # noqa: E402
from portbench.tests import pb_tiny  # noqa: E402

CONV_REF = "portbench/tests/conv_reference.py"


def _files(root: pathlib.Path) -> dict:
    return {p: p.read_bytes() for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _conv_config(**kw) -> dict:
    task = dict(pb_tiny.task(144, 4, 7), shape=[12, 12])
    cfg = dict(name="tiny_c", models={"c": pb_tiny.conv_model()},
               data={"c": task}, train_rows=64,
               engine=dict(pb_tiny.ENGINE, P=64), reference=CONV_REF)
    cfg.update(kw)
    return cfg


def _run(root, cell, seed=23):
    c = bench.load_cell(cell, seed, "cpu", root=root)
    return c, bench.run(c, 0.2, False, out=io.StringIO(), err=io.StringIO())


def test_a_configuration_names_its_reference(tmp_path):
    """A flat configuration that names a copy of the flat reference under
    a new file name is judged by that copy, and correct."""
    root = pb_tiny.make_tree(tmp_path)
    before = _files(root)
    src = (root / "portbench/tm_reference.py").read_text()
    (root / "portbench/flat_copy_reference.py").write_text(
        src + "\n\nJUDGED = []\n_train_step = train_step\n\n\n"
        "def train_step(*args):\n    JUDGED.append(len(args[5]))\n"
        "    return _train_step(*args)\n")
    cfg = dict(pb_tiny.CONFIGS["tiny_t"], name="tiny_r",
               reference="portbench/flat_copy_reference.py")
    cell, = pb_tiny.add_config(root, cfg)
    c, res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert c.ref.__file__ == str(root / "portbench/flat_copy_reference.py")
    assert c.ref.JUDGED and set(c.ref.JUDGED) == {32}    # the check epoch
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("mix", ["tfit", "tonline"])
def test_a_conv_configuration_with_its_own_reference_is_files(tmp_path, mix):
    """A conv configuration (12x12 images, patch 5, 64 clauses, 4 classes)
    with its task's image shape and a reference of its own: set-up and a
    window of ``fit`` and of ``partial_fit``, judged correct, with no file
    that was there changed."""
    from repro_torch import api
    root = pb_tiny.make_tree(tmp_path)
    before = _files(root)
    cfg = _conv_config()
    cell, = pb_tiny.add_config(root, cfg, (mix,))
    c, res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert c.ref.KINDS == ("conv",) and c.ref.bool_features(
        cfg["models"]["c"]) == 5 * 5 + 7 + 7
    assert all(p.read_bytes() == b for p, b in before.items())
    spec = drivers.spec_of(api, cfg["models"]["c"])
    assert (spec.kind, spec.img_h, spec.img_w, spec.patch) == \
        ("conv", 12, 12, 5)
    assert spec.n_patches == 64 and spec.bool_features == 39
    ta, w = data.initial_program(cfg["models"]["c"],
                                 np.random.default_rng(0), c.ref)
    assert ta.shape == (64, 2 * 39) and w.shape == (4, 64)
    # the engine's patch slots are checked where the configuration states
    # them
    root2 = tmp_path / "p65"
    shutil.copytree(root, root2)
    cell, = pb_tiny.add_config(root2, _conv_config(
        name="tiny_p", engine=dict(pb_tiny.ENGINE, P=65)), (mix,))
    with pytest.raises(RuntimeError, match="engine P=64, the configuration "
                                           "states 65"):
        _run(root2, cell)


def test_the_conv_control_and_faults_fail(tmp_path):
    """The conv reference separates: one bit narrower in the program's
    place, or a step with its state unchanged or half of its batch, is
    not correct."""
    root = pb_tiny.make_tree(tmp_path)
    cell, = pb_tiny.add_config(root, _conv_config())
    r = control.readings(bench.load_cell(cell, 29, "cpu", root=root), 0.2)
    assert all(v == 0 for v in r["program"].values()), r
    for what in ("control",) + control.FAULTS["fit"]:
        assert any(v > 0 for v in r[what].values()), (what, r)


def test_the_conv_reference_answers_as_the_program():
    from repro_torch import api
    ref = bench.reference(_conv_config())
    m = pb_tiny.conv_model()
    task = _conv_config()["data"]["c"]
    spec = drivers.spec_of(api, m)
    tm = api.TM(spec, engine=api.compile(api.tile_for(spec), device="cpu"),
                seed=3)
    x, y = data.make_bool_dataset(task, 96, 4)
    x = data.shaped(task, x)
    tm.fit(x, y, epochs=1, batch=32, rng=np.random.default_rng(2))
    L, f = tm.engine.L, ref.bool_features(m)
    ta = tm.program.ta[:64].numpy()
    ta = np.concatenate([ta[:, :f], ta[:, L // 2:L // 2 + f]], axis=1)
    w = tm.program.weights[:4, :64].numpy()
    assert (tm.predict(x).numpy() == ref.predict(m, ta, w, x, "cpu")
            .numpy()).all()


def test_a_kind_the_reference_does_not_judge_stops_the_run(tmp_path,
                                                            monkeypatch):
    """The conv configuration without a reference of its own falls to the
    flat reference, which refuses it before any data is made."""
    root = pb_tiny.make_tree(tmp_path)
    cfg = _conv_config()
    del cfg["reference"]
    cell, = pb_tiny.add_config(root, cfg)

    def no_data(*a, **k):
        raise AssertionError("data made for a model the run cannot judge")
    monkeypatch.setattr(data, "make_bool_dataset", no_data)
    with pytest.raises(ValueError, match=r"portbench/tm_reference\.py .*"
                                         r"kind 'conv'"):
        _run(root, cell)


def test_a_conv_serving_configuration_is_files(tmp_path):
    """The conv configuration under the closed serving mix: its pool is
    images, its firing program lies on the conv reference's literals and
    fires on its class, and the run is judged correct by that reference,
    with no file that was there changed."""
    root = pb_tiny.make_tree(tmp_path)
    before = _files(root)
    cfg = _conv_config()
    cell, = pb_tiny.add_config(root, cfg, ("tclosed",))
    c, res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert res["attempted"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
    m, task = cfg["models"]["c"], cfg["data"]["c"]
    ta, w = data.firing_program(m, task, np.random.default_rng(1), c.ref)
    f = c.ref.bool_features(m)
    inc = ta >= 128
    assert ta.shape == (64, 2 * f) and w.shape == (4, 64)
    # three pixels a row, two on one literal where the window wraps
    assert set(inc.sum(axis=1)) <= {1, 2, 3} and not inc[:, 25:].any()
    x, y = data.make_bool_dataset(task, 256, 3)
    pred = c.ref.predict(m, ta, w, data.shaped(task, x), "cpu").numpy()
    assert (pred == y).mean() > 0.4                  # 4 classes


def test_a_reference_without_the_interface_stops_the_run(tmp_path):
    root = pb_tiny.make_tree(tmp_path)
    src = (root / "portbench/tm_reference.py").read_text()
    (root / "portbench/short_reference.py").write_text(
        src + "\n\ndel motif_literals\n")
    cfg = dict(pb_tiny.CONFIGS["tiny_t"], name="tiny_q",
               reference="portbench/short_reference.py")
    cell, = pb_tiny.add_config(root, cfg)
    with pytest.raises(ValueError, match=r"portbench/short_reference\.py "
                                         r"lacks \['motif_literals'\]"):
        _run(root, cell)


def test_a_shape_that_does_not_hold_the_features_fails(tmp_path):
    root = pb_tiny.make_tree(tmp_path)
    cfg = _conv_config()
    cfg["data"]["c"]["shape"] = [12, 11]
    cell, = pb_tiny.add_config(root, cfg)
    with pytest.raises(ValueError, match="shape \\[12, 11\\] holds 132 "
                                         "features, the task states 144"):
        _run(root, cell)


def _spec_before(api, model: dict):
    """``spec_of`` as it was before a configuration gave the spec whole:
    13 keys copied."""
    return api.TMSpec(kind=model["kind"], features=model["features"],
                      clauses=model["clauses"], classes=model["classes"],
                      T=model["T"], s=model["s"], ta_bits=model["ta_bits"],
                      weight_bits=model["weight_bits"],
                      rand_bits=model["rand_bits"],
                      prng_backend=model["prng_backend"],
                      lfsr_bits=model["lfsr_bits"],
                      seed_refresh=model["seed_refresh"],
                      boost_true_positive=model["boost_true_positive"])


def _initial_before(model: dict, rng):
    """``data.initial_program`` as it was, sized by ``features``."""
    j = 1 << (model["ta_bits"] - 1)
    rows = model["clauses"] * (model["classes"] if model["kind"] == "vanilla"
                               else 1)
    ta = (j - 1 + rng.integers(0, 2, (rows, 2 * model["features"]))).astype(
        np.int32)
    weights = None
    if model["kind"] == "coalesced":
        weights = (1 - 2 * rng.integers(0, 2, (model["classes"],
                                               model["clauses"]))
                   ).astype(np.int32)
    return ta, weights


def _firing_before(model: dict, task: dict, rng, n_inc: int = 3):
    """``data.firing_program`` as it was: sized by ``features``, motif
    features as literal columns, weights for the CoTM alone."""
    j = 1 << (model["ta_bits"] - 1)
    rows = model["clauses"] * (model["classes"] if model["kind"] == "vanilla"
                               else 1)
    h, c = model["classes"], model["clauses"]
    mot = data.motifs(task)
    bits = np.argsort(-mot, axis=-1, kind="stable")[..., :task["motif_bits"]]
    ta = rng.integers(0, j, (rows, 2 * model["features"])).astype(np.int32)
    r = np.arange(rows)
    if model["kind"] == "vanilla":
        cls = (r // c + (r % c) % 2) % h
    else:
        cls = r % h
    picks = rng.integers(0, task["motifs_per_class"], rows)
    order = np.argsort(rng.random((rows, task["motif_bits"])), axis=1)
    on = bits[cls, picks][r[:, None], order[:, :n_inc]]
    ta[r[:, None], on] = rng.integers(j, 2 * j, (rows, n_inc))
    weights = None
    if model["kind"] == "coalesced":
        clip = (1 << (model["weight_bits"] - 1)) - 1
        weights = -rng.integers(1, clip + 1, (h, c))
        weights[cls, r] = rng.integers(1, clip + 1, rows)
        weights = weights.astype(np.int32)
    return ta, weights


ROSTER = [("mnist_cotm", "mnist_cotm")] + [
    ("paper_roster4", n) for n in ("mnist_cotm", "mnist_vanilla",
                                   "kws6_cotm", "kws6_vanilla")]


@pytest.mark.parametrize("conf,name", ROSTER)
def test_the_configurations_give_what_they_gave(conf, name):
    """The committed configurations' specs, data and programs are what
    they were before the configuration named its reference and shape."""
    from repro_torch import api
    cfg = json.loads((REPO / f"portbench/configs/{conf}.json").read_text())
    model, task = cfg["models"][name], cfg["data"][name]
    assert drivers.spec_of(api, model).to_dict() == \
        _spec_before(api, model).to_dict()
    ref = bench.reference(cfg)
    assert ref.KINDS == ("coalesced", "vanilla")
    x, _ = data.make_bool_dataset(task, 500, 9)
    assert data.shaped(task, x) is x
    got = data.initial_program(model, np.random.default_rng(5), ref)
    want = _initial_before(model, np.random.default_rng(5))
    assert np.array_equal(got[0], want[0])
    assert (got[1] is None and want[1] is None) or np.array_equal(
        got[1], want[1])
    fire = data.firing_program(model, task, np.random.default_rng(6), ref)
    fire_before = _firing_before(model, task, np.random.default_rng(6))
    assert all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(fire, fire_before))
    assert fire[0].shape == (ref.rows_of(model), 2 * model["features"])
