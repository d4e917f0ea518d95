"""CPU tests of the conv configuration of the port's benchmark: the plain
reference ``portbench/conv_reference.py`` against ``TM.fit`` step by
step, its many-cycle LFSR draw against the flat reference's one cycle at
a time, the configuration ``portbench/configs/conv_mnist.json``, the
work counts of ``portbench/conv_work.py`` and the cell's metric
readers."""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import conv_reference as ref  # noqa: E402
from portbench import conv_work, data, drivers, run as bench  # noqa: E402
from portbench import tm_reference as flat, work  # noqa: E402
from portbench.tests import pb_tiny  # noqa: E402

CELL = "conv_mnist.fit_b32"
METRICS = ("step.mfu.conv", "clause_tile_roofline.conv",
           "conv_ta_stage.us_per_step.conv", "step.kernels_per_step.conv",
           "device.idle_share.conv")
SHARED = ("session.active_groups.train", "session.serial_ms_per_pass.train")


def _tiny_task():
    return dict(pb_tiny.task(144, 4, 7), shape=[12, 12])


def _model_layout(prog, model, L):
    """The program's padded leaves in the reference's layout: TA and
    include bits [rows, 2f], weights [classes, clauses]."""
    rows, f = ref.rows_of(model), ref.bool_features(model)
    ta = prog.ta.to(torch.int64)[:rows]
    ta = torch.cat([ta[:, :f], ta[:, L // 2:L // 2 + f]], dim=1)
    shifts = torch.arange(32, dtype=torch.int32)
    bits = ((prog.inc[:rows, :, None] >> shifts) & 1).reshape(rows, -1)
    inc = torch.cat([bits[:, :f], bits[:, L // 2:L // 2 + f]], dim=1)
    w = prog.weights[:model["classes"], :model["clauses"]].to(torch.int64)
    return ta, inc.to(torch.int64), w


@pytest.mark.parametrize("lfsr_bits,start", [(8, "initial"), (8, "firing"),
                                             (24, "initial"),
                                             (24, "firing")])
def test_fit_follows_the_reference_step_by_step(lfsr_bits, start):
    """``TM.fit`` of the conv kind, one step a call through the CPU
    engine, against the reference after every step: TA states, include
    bits, weights, the PRNG's lanes, master and cycles, and the step's
    stats.  At 8 LFSR bits a seed refresh falls inside the steps."""
    from repro_torch import api
    model = dict(pb_tiny.conv_model(), lfsr_bits=lfsr_bits)
    task = _tiny_task()
    spec = drivers.spec_of(api, model)
    engine = api.compile(api.tile_for(spec), device="cpu")
    eng = {"L": engine.L, "R": engine.R, "P": engine.P, "group": 128}
    rng = np.random.default_rng(11)
    if start == "initial":
        ta0, w0 = data.initial_program(model, rng, ref)
    else:
        ta0, w0 = data.firing_program(model, task, rng, ref)
    tm = api.TM(spec, engine=engine, seed=5)
    tm.program = engine.lower(spec, ta=ta0, weights=w0)
    x, y = data.make_bool_dataset(task, 6 * 32, 3)
    x = data.shaped(task, x)
    ta, w = ref.held_ta(model, ta0, "cpu"), ref.weight_matrix(model, w0,
                                                              "cpu")
    prng = ref.Cluster.create(5 + 1, 8192, lfsr_bits, "cpu")
    masters, moved = {prng.master}, False
    for k in range(6):
        xb, yb = x[32 * k:32 * (k + 1)], y[32 * k:32 * (k + 1)]
        rec, = tm.fit(xb, yb, epochs=1, batch=32,
                      rng=np.random.default_rng(k))
        order = np.random.default_rng(k).permutation(32)
        w_before = w
        ta, w, stats = ref.train_step(model, eng, ta, w, prng,
                                      torch.as_tensor(xb[order]),
                                      torch.as_tensor(yb[order]))
        moved |= bool((w != w_before).any())
        masters.add(prng.master)
        got_ta, got_inc, got_w = _model_layout(tm.program, model, engine.L)
        assert torch.equal(got_ta, ta), k
        assert torch.equal(got_inc, (ta >= 128).to(torch.int64)), k
        assert torch.equal(got_w, w), k
        lanes, master, cycles = tm.prng.leaves()
        assert torch.equal(lanes.to(torch.int64).reshape(-1), prng.lanes), k
        assert int(master) == prng.master and int(cycles) == prng.cycles, k
        assert rec["selected_clauses"] == int(stats["selected"]), k
        assert rec["active_groups"] == int(stats["active_groups"]), k
        assert rec["total_groups"] == int(stats["total_groups"]), k
        assert round(rec["train_acc"] * 32) == int(stats["correct"]), k
    assert (len(masters) > 1) == (lfsr_bits == 8)      # a refresh, or none
    if start == "firing":
        assert moved                                  # the clauses fired


@pytest.mark.parametrize("bits,lanes", [(4, 7), (8, 100), (12, 8192),
                                        (24, 100), (32, 33)])
def test_the_draw_equals_one_cycle_at_a_time(bits, lanes):
    """The many-cycle draw gives the flat cluster's words, lanes, master
    and cycles word for word, across seed refreshes (at 4 and 8 bits
    several in one draw), at draw sizes that are not multiples of the
    lane count, and without refresh."""
    for refresh in (True, False):
        m = {"lfsr_bits": bits, "rand_bits": 16, "seed_refresh": refresh}
        one = flat.Cluster.create(987654321, lanes, bits, "cpu")
        many = ref.Cluster.create(987654321, lanes, bits, "cpu")
        assert isinstance(many, ref.Cluster)
        for size in (1, lanes - 1, lanes + 1, 5 * lanes + 3, 1000, 3001,
                     ref.BLOCK * lanes + 17, 2):
            assert torch.equal(one.draw(size, m), many.draw(size, m)), size
            assert torch.equal(one.lanes, many.lanes)
            assert (one.master, one.cycles) == (many.master, many.cycles)


def test_the_patch_literals_are_the_windows():
    """Each patch's literals: its window's pixels row-major, the
    thermometer code of its row and column, then their negations;
    padded slots are all 0."""
    m = pb_tiny.conv_model(img=7, patch=3)
    x = torch.as_tensor(np.random.default_rng(1).integers(0, 2, (2, 7, 7)))
    lits = ref.patch_literals(m, x, 30)
    f = ref.bool_features(m)
    assert lits.shape == (2, 30, 2 * f) and f == 9 + 4 + 4
    for i in range(5):
        for j in range(5):
            p = i * 5 + j
            want = torch.cat([x[:, i:i + 3, j:j + 3].reshape(2, 9),
                              torch.tensor([int(i > t) for t in range(4)]
                                           + [int(j > t) for t in range(4)]
                                           ).expand(2, -1)], dim=1)
            assert torch.equal(lits[:, p, :f], want)
            assert torch.equal(lits[:, p, f:], 1 - want)
    assert not lits[:, 25:].any()


def test_the_configuration_loads_at_the_cells_geometry(tmp_path):
    """``configs/conv_mnist.json`` through ``run.load_cell``: the conv
    reference, the two fit metrics it shares and the five conv metrics,
    28x28 images; its spec on the CPU
    engine gives L=384, R=2048, H=16, W=12, P=361, and a clause sees 136
    Boolean features."""
    from repro_torch import api
    cell = bench.load_cell(CELL, 2**31 + 5, "cpu")
    assert cell.ref.KINDS == ("conv",)
    assert cell.ref.__file__ == str(REPO / "portbench/conv_reference.py")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "train_rows_per_s"]
    assert [m["name"] for m in cell.per_layer] == list(SHARED + METRICS)
    assert cell.traffic == json.loads(
        (REPO / "portbench/traffic/fit_b32.json").read_text())
    (model,) = cell.config["models"].values()
    (task,) = cell.config["data"].values()
    assert cell.ref.bool_features(model) == 136
    assert cell.ref.patches(model) == 361
    spec = drivers.spec_of(api, model)
    assert (spec.kind, spec.img_h, spec.img_w, spec.patch) == \
        ("conv", 28, 28, 10)
    assert spec.bool_features == 136 and spec.n_patches == 361
    eng = cell.config["engine"]
    engine = api.compile(api.tile_for(spec), device="cpu", skip=eng["skip"],
                         ta_prng=eng["ta_prng"], autotune=eng["autotune"],
                         autotune_cache=tmp_path / "autotune.json")
    drivers.check_geometry(engine, eng)
    assert (engine.L, engine.R, engine.H, engine.tile.packed_words(),
            engine.P) == (384, 2048, 16, 12, 361)
    x, y = data.make_bool_dataset(task, 40, 9)
    assert data.shaped(task, x).shape == (40, 28, 28)
    ta, w = data.initial_program(model, np.random.default_rng(0), cell.ref)
    assert ta.shape == (2000, 272) and w.shape == (10, 2000)
    assert cell.config["train_rows"] == 8192


def test_the_work_counts_at_the_cells_sizes():
    """``conv_work`` at the cell's sizes: B=32 images, P=361 patches,
    2000 clauses, 10 classes, 272 literals, R=2048, W=12."""
    model = json.loads((REPO / "portbench/configs/conv_mnist.json")
                       .read_text())["models"]["conv_mnist"]
    B, P, C, H, lits = 32, 361, 2000, 10, 272
    assert conv_work.literals(model) == lits
    assert conv_work.clause_products(model, B) == B * P * C * lits \
        == 6_284_288_000
    assert conv_work.class_sum_ops(model, B) == 2 * B * H * C == 1_280_000
    assert conv_work.select_ops(model, B) == 2 * 4 * B * C == 512_000
    assert conv_work.pick_ops(model, B) == B * P * C == 23_104_000
    assert conv_work.ta_update_ops(model, 7) == 6 * lits * 7
    unit = {"int_ops_per_s": 1.0, "bit_products_per_s": 1.0}
    selected = 123_456
    assert conv_work.train_s(model, B, 3, selected, unit) == (
        3 * (1_280_000 + 512_000 + 23_104_000 + 6_284_288_000)
        + selected * (6 * lits + 2))
    products, nbytes = conv_work.clause_tile_cost(model, B)
    assert products == conv_work.clause_products(model, B) \
        == 11_552 * 2000 * 272
    assert nbytes == 2000 * 34 + 11_552 * 34 + 11_552 * 2000 // 8 \
        == 3_348_768
    pk = {"int_ops_per_s": 1e15, "bit_products_per_s": B1_RATE,
          "bytes_per_s": work.HBM_BYTES_PER_S}
    t, by = work.bound_s(work.least_s(pk, bit_products=products), nbytes, pk)
    assert by == "operations" and t == pytest.approx(products / B1_RATE)


B1_RATE = work.B1_MMA_PER_S * work.B1_BITS_PER_MMA


def _ctx(trace=None, steps=512):
    cfg = json.loads((REPO / "portbench/configs/conv_mnist.json").read_text())
    return {"counters": {"steps": 5120, "batch": 32, "selected": 10**8,
                         "window_s": 30.0},
            "trace": trace or {}, "notes": {"steps": steps} if trace else {},
            "config": cfg, "traffic": {},
            "peaks": {"int_ops_per_s": 1.67e13, "bit_products_per_s": B1_RATE,
                      "bytes_per_s": work.HBM_BYTES_PER_S}}


TRACE = {"busy_s": 1.5, "window_s": 2.0, "kernels": 512 * 40,
         "by_kernel": {
             "void (anonymous namespace)::packed_clause_tile<2>(unsigned "
             "int const*)": [0.04, 512],
             "(anonymous namespace)::class_sum_kernel(int const*)": [0.002,
                                                                     512],
             "void (anonymous namespace)::lfsr_cycles(long const*)": [0.2,
                                                                      2048],
             "void at::native::elementwise_kernel<128, 4>()": [1.0, 17408],
             "Memcpy DtoD (Device -> Device)": [0.3, 512]}}


@pytest.mark.parametrize("name", METRICS)
def test_the_readers_give_nothing_without_their_inputs(name):
    """Every conv reader returns ``None``, and does not raise, on a run
    that recorded nothing it reads (an untraced stretch, an empty
    trace)."""
    read = bench.reader(name)
    empty = dict(_ctx(), counters={})
    assert read(empty) is None
    if name != "step.mfu.conv":
        assert read(_ctx()) is None


def test_the_readers_read_a_conv_trace():
    """The readers' arithmetic on a made-up traced pass of 512 steps."""
    ctx = _ctx(TRACE)
    got = {n: bench.reader(n)(ctx) for n in METRICS}
    assert got["step.kernels_per_step.conv"] == 40
    assert got["device.idle_share.conv"] == pytest.approx(25.0)
    assert got["conv_ta_stage.us_per_step.conv"] == pytest.approx(
        1e6 * 1.2 / 512)
    t = 6_284_288_000 / B1_RATE
    assert got["clause_tile_roofline.conv"] == pytest.approx(
        100 * 512 * t / 0.04)
    model = ctx["config"]["models"]["conv_mnist"]
    assert got["step.mfu.conv"] == pytest.approx(
        100 * conv_work.train_s(model, 32, 5120, 10**8, ctx["peaks"]) / 30)
    assert 0 < got["step.mfu.conv"] < 100


# Clause-tile kernels at the conv train shape (B=32 images of P=361
# patches, 11,552 patch rows, 2000 clauses of 272 literals): (bytes
# written, whether it works on the engine's padded R=2048 clause rows and
# W=12 literal words).  The first is ``packed_clause_tile`` as it is.
N_ROWS = 32 * 361
TILE_OUTPUTS = {
    "int32_per_padded_row": (4 * N_ROWS * 2048, True),
    "byte_flags": (N_ROWS * 2000, False),
    "bit_flags": (N_ROWS * 2000 // 8, False),
    "or_and_pick": (32 * 2000 // 8 + 2 * 32 * 2000, False),
}


def _tile_trace(launch_s, launches=512):
    return {"by_kernel": {"void (anonymous namespace)::packed_clause_tile"
                          "<2>(unsigned int const*)": [launches * launch_s,
                                                        launches]}}


@pytest.mark.parametrize("output", TILE_OUTPUTS)
def test_the_clause_tile_roofline_stays_under_100(output):
    """``clause_tile_roofline.conv`` counts the algorithm's work, not one
    kernel's output format: a kernel that writes int32 flags, byte
    flags, bit flags or only the OR over patches and its pick, run at
    the fastest its own products and bytes allow at the peaks, reads at
    most 100 %; a kernel writing byte flags at the tile's measured
    0.0644 ms a launch (PERF.md §6 row 2, conv train step) reads ~2 %."""
    written, padded = TILE_OUTPUTS[output]
    rows, words = (2048, 12) if padded else (2000, 272 / 32)
    products = N_ROWS * rows * 32 * words
    read_bytes = 4 * words * (rows + N_ROWS)
    launch_s = max(products / B1_RATE,
                   (read_bytes + written) / work.HBM_BYTES_PER_S)
    read = bench.reader("clause_tile_roofline.conv")
    share = read(_ctx(_tile_trace(launch_s)))
    assert 0 < share <= 100 + 1e-9
    if output == "byte_flags":
        assert read(_ctx(_tile_trace(64.4e-6))) == pytest.approx(
            100 * 6_284_288_000 / B1_RATE / 64.4e-6)
        assert read(_ctx(_tile_trace(64.4e-6))) < 2.1


def _conv_tree(root: pathlib.Path) -> str:
    """A copy of the benchmark whose manifest runs one tiny conv cell
    (12x12 images, patch 5, 64 clauses, 4 classes) judged by
    ``portbench/conv_reference.py``, with the conv metrics."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(name="tiny_c", models={"c": pb_tiny.conv_model()},
               data={"c": _tiny_task()}, train_rows=128,
               engine=dict(pb_tiny.ENGINE, P=64),
               reference="portbench/conv_reference.py")
    (root / "portbench/configs/tiny_c.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/tfit.json").write_text(json.dumps(
        pb_tiny.TRAFFIC["tfit"]))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = "tiny_c.tfit"
    man["configs"] = [dict(name="tiny_c", source="tiny",
                           file="portbench/configs/tiny_c.json", reduced=[],
                           why="tiny")]
    man["workloads"] = [dict(name=cell, config="tiny_c", traffic="tfit",
                             chips=1, why="tiny")]
    man["end_to_end"] = [dict(m, workloads=[cell]) if "workloads" in m
                         else m for m in man["end_to_end"]
                         if m["name"] in ("setup_s", "train_rows_per_s")]
    man["per_layer"] = [dict(m, workloads=[cell]) for m in man["per_layer"]
                        if CELL in m.get("workloads", ())]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_conv_run_is_correct(tmp_path, trace):
    """A tiny conv ``fit`` cell, untraced and traced, on the CPU in a
    process of its own (a run refuses to start beside JAX, which other
    tests of a worker load): judged correct by the conv reference with
    every check 0; traced, the readers that read the device's trace find
    nothing on the CPU and are left out, and the window's share of the
    peak is there."""
    cell = _conv_tree(tmp_path)
    code = ("import io, json, pathlib, sys\n"
            f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]\n"
            "from portbench import run as bench\n"
            f"c = bench.load_cell({cell!r}, 4_000_000_007, 'cpu', "
            f"root=pathlib.Path({str(tmp_path)!r}))\n"
            f"res = bench.run(c, 0.2, {bool(trace)}, out=io.StringIO(), "
            "err=io.StringIO())\n"
            "print(json.dumps(res))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert res["attempted"] > 0
    if trace:
        assert set(res["metrics"]) <= set(SHARED + METRICS)
        assert {"step.mfu.conv", *SHARED} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"setup_s", "train_rows_per_s"}
