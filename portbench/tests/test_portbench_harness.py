"""CPU tests of the benchmark harness: generators, work counts, the
reference against the program, the data-driven lookup and the import
closure of a run."""
from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import data, drivers, run as bench, tm_reference as ref, work  # noqa: E402
from portbench.tests import pb_tiny  # noqa: E402


def test_vectorised_generator_equals_the_programs():
    from repro_torch.data import datasets
    for spec in (datasets.MNIST_LIKE, datasets.KWS6_LIKE):
        task = {k: getattr(spec, k) for k in (
            "name", "features", "classes", "motifs_per_class", "motif_bits",
            "active_motifs", "background_p", "flip_p", "seed")}
        for seed in (0, 5, 4_000_000_001):
            x, y = data.make_bool_dataset(task, 9000, seed)
            xo, yo = datasets.make_bool_dataset(spec, 9000, seed)
            assert np.array_equal(x, xo) and np.array_equal(y, yo)
            assert x.dtype == xo.dtype and y.dtype == yo.dtype


@pytest.mark.parametrize("what", ["data", "initial", "firing"])
def test_generators_follow_the_seed(what):
    m = pb_tiny.CONFIGS["tiny_s"]["models"]["a"]
    t = pb_tiny.CONFIGS["tiny_s"]["data"]["a"]

    def gen(seed):
        rng = np.random.default_rng(seed)
        if what == "data":
            return data.make_bool_dataset(t, 300, seed)
        if what == "initial":
            return data.initial_program(m, rng, ref)
        return data.firing_program(m, t, rng, ref)

    def same(a, b):
        return all(np.array_equal(u, v) for u, v in zip(a, b))
    assert same(gen(3), gen(3))
    assert not same(gen(3), gen(4))


def test_firing_program_fires_on_its_class():
    m = pb_tiny.CONFIGS["tiny_s"]["models"]["a"]
    t = pb_tiny.CONFIGS["tiny_s"]["data"]["a"]
    ta, w = data.firing_program(m, t, np.random.default_rng(0), ref)
    inc = ta >= 128
    assert inc.sum(axis=1).tolist() == [3] * 50
    assert not inc[:, 40:].any()                     # x-literals only
    assert w.min() >= -2047 and w.max() <= 2047 and (w != 0).all()
    assert ((w > 0).sum(axis=0) == 1).all()


def test_work_counts_by_hand():
    cotm = dict(kind="coalesced", features=784, clauses=2000, classes=10)
    van = dict(kind="vanilla", features=1600, clauses=700, classes=6)
    assert work.words(cotm) == 49 and work.words(van) == 100
    assert work.clause_products(cotm, 32) == 32 * 2000 * 1568 == 100_352_000
    assert work.class_sum_ops(cotm, 32) == 2 * 32 * 10 * 2000 == 1_280_000
    assert work.class_sum_ops(van, 1) == 4200
    assert work.ta_update_ops(cotm, 100) == 6 * 1568 * 100 == 940_800
    pk = {"int_ops_per_s": 1e12, "bit_products_per_s": 1e14,
          "bytes_per_s": 1e9}
    # one step of 32 rows with 1,000 pairs of feedback: int32 operations
    # at 1e12/s, the clause's bit products at 1e14/s
    ops = 1_280_000 + 2 * 4 * 32 * 2000 + 1000 * (9408 + 2)
    assert work.train_s(cotm, 32, 1, 1000, pk) == \
        ops / 1e12 + 100_352_000 / 1e14
    assert work.inference_s(van, 2, pk) == \
        2 * 4200 / 1e12 + 2 * 4200 * 3200 / 1e14
    products, nbytes = work.clause_tile_cost([cotm, van], 32)
    assert products == 100_352_000 + 32 * 4200 * 3200
    assert nbytes == 4 * (2000 * 49 + 32 * 49 + 32 * 2000) + \
        4 * (4200 * 100 + 32 * 100 + 32 * 4200)
    assert work.bound_s(2.0, 1e9, pk) == (2.0, "operations")
    assert work.bound_s(1.0, 3e9, pk) == (3.0, "bytes")
    # the roster's tile at the H100's peaks: the bytes bind
    h100 = {"int_ops_per_s": 64 * 132 * 1.98e9, "bytes_per_s": 3.35e12,
            "bit_products_per_s": 1.5e11 * 16 * 8 * 256}
    roster = json.loads((REPO / "portbench/configs/paper_roster4.json")
                        .read_text())["models"].values()
    products, nbytes = work.clause_tile_cost(list(roster), 32)
    t, by = work.bound_s(work.least_s(h100, bit_products=products), nbytes,
                         h100)
    assert by == "bytes" and 1.3e-6 < t < 1.45e-6


@pytest.mark.parametrize("kind", ["coalesced", "vanilla"])
def test_reference_equals_the_program(kind):
    """Three ``TM.fit`` steps and the answers of the trained program on
    the CPU, against the reference."""
    from repro_torch import api
    m = dict(pb_tiny.model(kind, 40, 50, 4))
    t = pb_tiny.task(40, 4, 7)
    spec = drivers.spec_of(api, m)
    eng = api.compile(api.tile_for(spec), device="cpu")
    tm = api.TM(spec, engine=eng, seed=11)
    ta0, w0 = data.initial_program(m, np.random.default_rng(3), ref)
    tm.program = eng.lower(spec, ta=ta0, weights=w0)
    x, y = data.make_bool_dataset(t, 96, 5)
    hist = tm.fit(x, y, epochs=1, batch=32, rng=np.random.default_rng(9))
    idx = np.random.default_rng(9).permutation(96).reshape(3, 32)
    engine = dict(L=eng.L, R=eng.R, group=128, stream_tile=256)
    cl = ref.Cluster.create(12, 8192, 24, "cpu")
    ta, w, tot = ref.held_ta(m, ta0, "cpu"), w0, {}
    for s in range(3):
        ta, w, st = ref.train_step(m, engine, ta, w, cl, x[idx[s]],
                                   y[idx[s]])
        for k, v in st.items():
            tot[k] = tot.get(k, 0) + v
    half = eng.L // 2
    pta = tm.program.ta.to(torch.int64)[:ref.rows_of(m)]
    pta = torch.cat([pta[:, :40], pta[:, half:half + 40]], 1)
    assert torch.equal(pta, ta)
    assert int((ta != ref.held_ta(m, ta0, "cpu")).sum()) > 100
    if kind == "coalesced":
        assert torch.equal(tm.program.weights[:4, :50].to(torch.int64), w)
    assert hist[0]["selected_clauses"] == tot["selected"]
    assert hist[0]["active_groups"] == tot["active_groups"]
    assert round(hist[0]["train_acc"] * 96) == tot["correct"]
    lanes, master, cycles = tm.prng.leaves()
    assert torch.equal(lanes, cl.lanes)
    assert (int(master), int(cycles)) == (cl.master, cl.cycles)
    xt, _ = data.make_bool_dataset(t, 200, 6)
    ans = ref.predict(m, pta.numpy(), None if w is None else w.numpy(), xt,
                      "cpu")
    assert torch.equal(tm.predict(xt).to(torch.int64), ans)


def test_a_new_config_mix_and_metric_are_files(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as files and manifest entries to a copy of the benchmark, run without
    an edit to any file that was there."""
    root = pb_tiny.make_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*.py")}
    cfg = dict(pb_tiny.CONFIGS["tiny_t"], name="extra_cfg",
               models={"z": pb_tiny.model("vanilla", 30, 10, 3)},
               data={"z": pb_tiny.task(30, 3, 9)}, train_rows=64)
    (root / "portbench/configs/extra_cfg.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/extra_mix.json").write_text(json.dumps(
        dict(driver="fit", epochs=1, batch=16)))
    (root / "portbench/metrics/extra.rows_seen.train.py").write_text(
        "def read(ctx):\n    return ctx['counters']['rows']\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name="extra_cfg", source="x", reduced=[],
                               file="portbench/configs/extra_cfg.json",
                               why="x"))
    man["workloads"].append(dict(name="extra_cfg.extra_mix",
                                 config="extra_cfg", traffic="extra_mix",
                                 chips=1, why="x"))
    for m in man["end_to_end"]:
        if m["name"] == "train_rows_per_s":
            m["workloads"].append("extra_cfg.extra_mix")
    man["per_layer"].append(dict(name="extra.rows_seen.train",
                                 unit="rows", better="higher",
                                 source="program_counter", layer="api",
                                 moves="train_rows_per_s",
                                 workloads=["extra_cfg.extra_mix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = bench.load_cell("extra_cfg.extra_mix", 77, "cpu", root=root)
    out, err = io.StringIO(), io.StringIO()
    res = bench.run(cell, 0.2, True, out=out, err=err)
    assert res["correct"] and res["metrics"]["extra.rows_seen.train"][
        "value"] > 0
    assert json.loads(out.getvalue().splitlines()[-1]) == res
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pathlib; sys.path[:0] = [%r, %r]\n"
        "import portbench.run as r\n"
        "from portbench import drivers, data, readers, trace, work, "
        "tm_reference, control\n"
        "from repro_torch import api\n"
        "from repro_torch.launch import scheduler, serve_tm\n"
        "for p in sorted(pathlib.Path(%r).glob('*.py')):\n"
        "    r.reader(p.stem)\n"
        "bad = r.forbidden_modules()\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n") % (str(REPO), str(REPO / "src"),
                                           str(REPO / "portbench/metrics"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert bench.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def test_no_card_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", "mnist_cotm.fit_b32", "--seed", "1",
                     "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "card" in out.err
