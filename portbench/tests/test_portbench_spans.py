"""CPU tests of the per-layer metrics that read the program's span table
(``portbench/program_spans.py``): a traced run of each tiny training cell
reads them all, and tracing leaves what the run is judged on as it was."""
from __future__ import annotations

import io
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import program_spans, run as bench  # noqa: E402
from portbench.tests import pb_tiny  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402

ONLINE = ("session.host_us_per_step.online",
          "session.encode_us_per_step.online", "step.copy_us_per_step.online")
TRAIN = ("session.serial_ms_per_pass.train",)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return pb_tiny.make_tree(tmp_path_factory.mktemp("pbspans"))


def _run(tree, cell, trace):
    spans.reset()
    c = bench.load_cell(cell, 4_000_000_007, "cpu", root=tree)
    return bench.run(c, 0.3, trace, out=io.StringIO(), err=io.StringIO())


@pytest.mark.parametrize("cell, names", [("tiny_t.tonline", ONLINE),
                                         ("tiny_t.tfit", TRAIN)])
def test_a_traced_run_reads_every_span_metric(tree, cell, names):
    traced = _run(tree, cell, True)
    assert traced["correct"]
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert all(got.get(n, 0) > 0 for n in names), got
    assert not set(got) & (set(ONLINE + TRAIN) - set(names))
    if cell == "tiny_t.tonline":
        host, enc, copy = (got[n] for n in ONLINE)
        assert host >= enc + copy
    plain = _run(tree, cell, False)
    assert plain["checks"] == traced["checks"]


def test_no_table_or_no_calls_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "totals", lambda: {})
    for f in (program_spans.host_us_per_step,
              program_spans.encode_us_per_step,
              program_spans.copy_us_per_step,
              program_spans.serial_ms_per_pass):
        assert f({}) is None
