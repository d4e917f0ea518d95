"""CPU tests of what decides ``correct``: the control (the reference one
bit narrower, in the program's place) and every fault a cell can have,
planted in the program underneath a whole run of a tiny cell, come out as
not correct; and the cells themselves on the card."""
from __future__ import annotations

import io
import json
import os
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

from portbench import control, run as bench  # noqa: E402
from portbench.tests import pb_tiny  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return pb_tiny.make_tree(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell", sorted(pb_tiny.CELLS.values()))
def test_control_and_faults_fail_the_sound_run_passes(tree, cell):
    c = bench.load_cell(cell, 31, "cpu", root=tree)
    r = control.readings(c, 0.3)
    assert all(v == 0 for v in r["program"].values()), r
    for what in ("control",) + control.FAULTS[c.traffic["driver"]]:
        assert any(v > 0 for v in r[what].values()), (what, r)


def _unchanged(monkeypatch):
    from repro_torch.core import dtm
    step = dtm.DTMEngine.train_step

    def broken(self, prog, prng, lits, labels, donate=False):
        new, new_prng, stats = step(self, prog.map(torch.clone), prng, lits,
                                    labels)
        return prog, new_prng, stats
    monkeypatch.setattr(dtm.DTMEngine, "train_step", broken)


def _half_batch(monkeypatch):
    from repro_torch.core import dtm
    step = dtm.DTMEngine.train_step

    def broken(self, prog, prng, lits, labels, donate=False):
        h = max(lits.shape[0] // 2, 1)
        return step(self, prog, prng, torch.cat([lits[:h], lits[:h]])[
            :lits.shape[0]], torch.cat([labels[:h], labels[:h]])[
            :labels.shape[0]], donate)
    monkeypatch.setattr(dtm.DTMEngine, "train_step", broken)


def _later_steps_read_the_first_batch(monkeypatch):
    """Every step of an epoch after the first trains on the first step's
    batch, as a plan gather that always read row 0 would."""
    from repro_torch.core import dtm
    epoch = dtm.DTMEngine._fit_epoch_impl

    def broken(self, prog, prng, lits, labels, idx, sync_guard=False):
        idx = np.array(idx)
        idx[1:] = idx[0]
        return epoch(self, prog, prng, lits, labels, idx, sync_guard)
    monkeypatch.setattr(dtm.DTMEngine, "_fit_epoch_impl", broken)


def _keeps_its_last_state(monkeypatch):
    """``TM.fit`` trains on from the state its last call left, whatever
    program it is handed, as a session that kept its state would."""
    from repro_torch import api
    fit = api.TM.fit
    last = []

    def broken(self, x, y, **kw):
        if last:
            self.program, self.prng = last[-1]
        out = fit(self, x, y, **kw)
        last.append((self.program, self.prng))
        return out
    monkeypatch.setattr(api.TM, "fit", broken)


def _altered(monkeypatch):
    from repro_torch import api
    predict = api.ProgramBank.predict

    def broken(self, lits):
        preds, votes = predict(self, lits)
        return (preds + 1) % 3, votes
    monkeypatch.setattr(api.ProgramBank, "predict", broken)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_t.tfit", _unchanged), ("tiny_t.tfit", _half_batch),
    ("tiny_t.tfit", _later_steps_read_the_first_batch),
    ("tiny_t.tfit", _keeps_its_last_state),
    ("tiny_t.tonline", _unchanged), ("tiny_s.tclosed", _altered)])
def test_a_run_over_a_broken_program_is_not_correct(tree, monkeypatch, cell,
                                                   fault):
    """The whole run past the look for a card, with the timed path broken
    underneath: ``correct`` comes out false."""
    fault(monkeypatch)
    c = bench.load_cell(cell, 41, "cpu", root=tree)
    out, err = io.StringIO(), io.StringIO()
    res = bench.run(c, 0.3, False, out=out, err=err)
    assert res["correct"] is False, res["checks"]
    assert "limit 0" in err.getvalue().splitlines()[-1]


def test_a_fit_window_takes_its_programs_in_turn(tree):
    """The fit window trains its programs in turn, each pass from its
    program's own initial state, PRNG and epoch order: the passes of one
    program agree, the programs' trajectories differ, and the first is
    the program that every training driver draws and the check judges."""
    from repro_torch import api
    from portbench import drivers
    c = bench.load_cell("tiny_t.tfit", 43, "cpu", root=tree)
    n = c.traffic["programs"]
    drv = drivers.Fit(c)
    drv.setup(api)
    assert drv.slots[0] == (drv.prog0, drv.prng0, drv.seeds[4])
    drv.window(4.0, None)
    ks = [k for k, _ in drv.pass_recs]
    assert len(ks) > n and ks == [i % n for i in range(len(ks))]
    assert drv.counters["programs"] == n
    firsts = {}
    for k, recs in drv.pass_recs:
        assert recs == firsts.setdefault(k, recs)
    assert len({firsts[k][0]["selected_clauses"] for k in range(n)}) == n
    drv.release()
    assert all(v == 0 for v in drv.judge().values())


MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_the_cells_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "2",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"correct": true' in r.stdout.splitlines()[-1]
