"""The port's analysis layer (``python -m repro_torch.analysis``), on the CPU.

* the launch checker finds no violation of the H100's limits over its
  audit space, catches each seeded violation and reports the
  ``fused_step`` balance finding at R = 4224;
* the trace audit passes on the CPU against the port's golden, and its
  ``autotune=off`` and forced ``packed_vpu`` legs (every CPU leg, in
  fact) equal the JAX package's golden under the one documented rename;
* the port's lint is clean on ``repro_torch/``, with a fixture per rule.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import kernel_check, lint, trace_audit
from repro_torch.launch.mesh import H100, HardwareModel

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU_LEGS = {
    "cpu|force=auto|skip=1|prng=inkernel|autotune=seed": {},
    "cpu|force=auto|skip=1|prng=inkernel|autotune=off": {"autotune": "off"},
    "cpu|force=packed_vpu|skip=1|prng=inkernel|autotune=seed":
        {"kernel_path": "packed_vpu"},
    "cpu|force=auto|skip=0|prng=inkernel|autotune=seed": {"skip": False},
}


# --------------------------------------------------------------------------- #
# launch checker                                                              #
# --------------------------------------------------------------------------- #

def test_no_violation_at_the_h100_limits():
    n, violations, findings = kernel_check.check_all()
    assert not violations, "\n".join(v.render() for v in violations)
    assert n >= 700
    kernels = {p.kernel for p in kernel_check.build_plans()}
    assert kernels == {"packed_clause_eval", "packed_clause_tile",
                       "class_sum", "fused_step", "ta_update",
                       "ta_update_sparse", "ta_update_streamed",
                       "clause_eval", "tm_infer", "lfsr_bits",
                       "threefry_bits"}


def test_balance_finding_for_fused_step_at_the_roster_tile():
    _, _, findings = kernel_check.check_all()
    assert findings and {f.kernel for f in findings} == {"fused_step"}
    assert all("R4224" in f.desc and f.max_work == 2 for f in findings)
    plan = kernel_check.plan_fused(1, 32, 4224, 100, 16)
    assert plan.cluster == 16 and plan.work == (2,) + (1,) * 15
    assert kernel_check.balance(plan).mean_work == 17 / 16
    assert kernel_check.balance(kernel_check.plan_fused(1, 32, 2048, 52,
                                                        16)) is None


def _kinds(plan, hw=H100):
    return [v.kind for v in kernel_check.check_plan(plan, hw)]


def test_catches_shared_memory_over_the_block_limit():
    plan = kernel_check.plan_tile(1, 32, 4224, 100, 132)
    assert _kinds(plan) == []
    assert _kinds(dataclasses.replace(plan, smem=300 * 1024)) == ["smem"]
    # a kernel that never opts in is held to 48 KB
    ta = kernel_check.plan_ta("ta_update", 1, 64, 3200, 4224, 132)
    assert _kinds(dataclasses.replace(ta, smem=49 * 1024)) == ["smem"]
    small = HardwareModel(smem_per_block_optin=32 * 1024)
    wide = kernel_check.plan_tile(4, 32, 4224, 100, 132)   # 4 warps
    assert wide.smem > 48 * 1024 and _kinds(wide) == []
    assert _kinds(wide, small) == ["smem"]


def test_catches_a_cluster_over_its_limit():
    fused = kernel_check.plan_fused(1, 32, 4224, 100, 16)
    bad = dataclasses.replace(fused, cluster=17,
                              grid=(17,) + fused.grid[1:])
    assert _kinds(bad) == ["cluster"]
    portable = kernel_check.plan_clause_eval(1, 1, 3200, 4224, 132)
    assert _kinds(dataclasses.replace(
        portable, cluster=16, grid=(16 * 33,) + portable.grid[1:])) == [
            "cluster"]
    # a grid that is not a multiple of the cluster
    assert _kinds(dataclasses.replace(
        fused, grid=(fused.grid[0] + 1,) + fused.grid[1:])) == ["cluster"]


def test_catches_grid_y_and_z_over_65535():
    plan = kernel_check.plan_edge(1, 4, 4224, 100, 132)
    assert _kinds(dataclasses.replace(plan, grid=(plan.grid[0], 70000,
                                                  1))) == ["grid"]
    assert _kinds(dataclasses.replace(plan, grid=(plan.grid[0], 1,
                                                  70000))) == ["grid"]
    assert _kinds(dataclasses.replace(plan, threads=2048)) == ["threads"]


def test_catches_a_tile_left_uncovered_or_covered_twice():
    plan = kernel_check.plan_tile(1, 32, 4224, 100, 132)
    rows = plan.covers[0]
    gap = dataclasses.replace(rows, spans=rows.spans[:-1])
    twice = dataclasses.replace(rows, spans=rows.spans + rows.spans[:1])
    for cover, word in ((gap, "no block"), (twice, "2 times")):
        bad = dataclasses.replace(plan, covers=(cover,) + plan.covers[1:])
        (v,) = kernel_check.check_plan(bad)
        assert v.kind == "coverage" and word in v.detail
    # a cluster whose blocks leave clause rows of the reduction out
    cs = kernel_check.plan_class_sum(1, 32, 2048, 16, 132)
    red = cs.covers[0]
    assert _kinds(dataclasses.replace(cs, covers=(dataclasses.replace(
        red, spans=red.spans[1:]),) + cs.covers[1:])) == ["coverage"]


def test_plans_use_the_wrappers_geometry():
    from repro_torch.kernels.clause_eval import clause_split
    from repro_torch.kernels.fused_step import fused_split
    from repro_torch.kernels.packed_clause import edge_geometry, tile_warps
    assert kernel_check.plan_tile(4, 32, 4224, 100, 132).threads == \
        32 * tile_warps(4, 32, 4224, 132)
    lanes, _, warps, grid = edge_geometry(1, 4224, 100, 132)
    plan = kernel_check.plan_edge(1, 1, 4224, 100, 132)
    assert plan.grid[:2] == grid and plan.threads == 32 * warps
    splits, _ = clause_split(1, 32, 2048, 1664, 132)
    assert kernel_check.plan_clause_eval(1, 32, 1664, 2048,
                                         132).cluster == splits
    assert kernel_check.plan_fused(1, 32, 2048, 52, 16).cluster == \
        fused_split(2048)
    # fused_step's shared memory (the csrc Layout) at the serving tile
    assert kernel_check.fused_smem(16, 100, True) == 4 * (
        256 * 100 + 104 * 4 + 16 * 260 + 2 * 4 * 256 + 256 + 16 + 4 * 16)


def test_kernels_cli_exits_zero():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "kernels"], capture_output=True, text=True,
                       cwd=REPO, env={"PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout


# --------------------------------------------------------------------------- #
# trace audit                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("leg", sorted(CPU_LEGS))
def test_cpu_audit_matches_the_ports_golden(leg, tmp_path):
    report = trace_audit.run_audit(device="cpu",
                                   autotune_cache=tmp_path / "plans.json",
                                   **CPU_LEGS[leg])
    assert report.leg == leg
    assert all(v <= 1 for v in report.session_caches.values())
    assert all(v <= 1 for v in report.serving_caches.values())


def test_golden_legs_equal_jax_under_the_rename():
    """JAX's golden was recorded on its ``ref`` backend: there every clause
    path other than packed_vpu and mxu_popcount reads ``ref``."""
    port = json.loads(trace_audit.default_baseline_path().read_text())
    jax = json.loads((REPO / "ANALYSIS_baseline.json").read_text())
    for leg in CPU_LEGS:
        jleg = "ref" + leg[len("cpu"):]
        assert trace_audit.jax_equivalent(port["legs"][leg]) == \
            jax["legs"][jleg], leg
    # the port's own names for the off leg: the dense clause kernel
    off = port["legs"]["cpu|force=auto|skip=1|prng=inkernel|autotune=off"]
    assert off["session_paths"]["infer"] == "mxu"
    assert off["session_paths"]["train"] == "fused"


def test_audit_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Like every entry point, the audit resolves its device through
    ``core.device.resolve_device``: without a device it asks for CUDA, and
    raises when there is no card (no fallback to the CPU)."""
    import inspect
    import torch
    assert inspect.signature(trace_audit.run_audit).parameters[
        "device"].default is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trace_audit.run_audit(baseline=tmp_path / "g.json")
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "audit", "--baseline", str(tmp_path / "g.json")],
                       capture_output=True, text=True, cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src")})
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "g.json").exists()


def test_audit_golden_roundtrip_and_divergence(tmp_path):
    baseline = tmp_path / "golden.json"
    report = trace_audit.run_audit(device="cpu", update=True,
                                   baseline=baseline,
                                   autotune_cache=tmp_path / "p.json")
    trace_audit.compare_to_golden(report, baseline)
    golden = json.loads(baseline.read_text())
    golden["legs"][report.leg]["session_paths"]["infer"] = "not-a-path"
    baseline.write_text(json.dumps(golden))
    with pytest.raises(trace_audit.AuditError, match="diverged"):
        trace_audit.compare_to_golden(report, baseline)
    with pytest.raises(trace_audit.AuditError, match="no golden entry"):
        trace_audit.compare_to_golden(report, tmp_path / "empty.json")


# --------------------------------------------------------------------------- #
# lint                                                                        #
# --------------------------------------------------------------------------- #

CORE = "src/repro_torch/core/dtm.py"
LAUNCH = "src/repro_torch/launch/somelaunch.py"
OTHER = "src/repro_torch/convert.py"


def codes(src, relpath=CORE):
    return [f.code for f in lint.lint_source(src, relpath)]


def test_the_ports_tree_is_clean():
    assert lint.lint_paths(lint.default_paths()) == []
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "lint"], capture_output=True, text=True, cwd=REPO,
                       env={"PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stdout


def test_rule_table_names_the_ported_rules():
    assert [r.code for r in lint.RULES] == ["DTM002", "DTM003", "DTM007",
                                            "DTM009", "DTM010", "DTM011"]
    for code in ("DTM001", "DTM004", "DTM005", "DTM006", "DTM008"):
        assert code in lint.__doc__


def test_dtm002_env_read():
    assert codes("import os\nv = os.environ.get('X')\n", OTHER) == ["DTM002"]
    assert codes("import os\nv = os.getenv('X')\n",
                 "src/repro_torch/kernels/autotune.py") == ["DTM002"]
    assert codes("v = cfg.environ\n", OTHER) == []


def test_dtm003_hot_path_sync():
    assert codes("def f(x):\n    return x.item()\n") == ["DTM003"]
    assert codes("def f(x):\n    return x.cpu()\n", LAUNCH) == ["DTM003"]
    assert codes("def f():\n    torch.cuda.synchronize()\n",
                 "src/repro_torch/kernels/k.py") == ["DTM003"]
    assert codes("def f(e):\n    e.synchronize()\n") == ["DTM003"]
    assert codes("def collect(x):\n    return x.numpy()\n", LAUNCH) == []
    assert codes("def f(x):\n    return x.tolist()\n", OTHER) == []
    assert codes("def f(x):\n    return x.item()  "
                 "# dtmlint: disable=DTM003 (the fetch)\n") == []


def test_dtm007_mutable_default():
    assert codes("def f(a=[]):\n    pass\n", OTHER) == ["DTM007"]
    assert codes("def f(*, a=dict()):\n    pass\n", OTHER) == ["DTM007"]
    assert codes("def f(a=None, b=()):\n    pass\n", OTHER) == []


def test_dtm009_bare_except():
    bad = "try:\n    f()\nexcept:\n    pass\n"
    assert codes(bad, OTHER) == ["DTM009"]
    assert codes(bad.replace("except:", "except OSError:"), OTHER) == []


def test_dtm010_unlocked_stats_read():
    sched = "src/repro_torch/launch/scheduler.py"
    bad = ("class S:\n    def stats(self):\n        return self.n\n")
    good = ("class S:\n    def stats(self):\n        with self._work:\n"
            "            return self.n\n")
    assert codes(bad, sched) == ["DTM010"]
    assert codes(good, sched) == []
    assert codes(bad, LAUNCH) == []


def test_dtm011_non_atomic_publish():
    ck = "src/repro_torch/checkpoint/checkpoint.py"
    assert codes("open(path, 'w')\n", ck) == ["DTM011"]
    assert codes("np.savez(path, **a)\n", "src/repro_torch/runtime/d.py"
                 ) == ["DTM011"]
    assert codes("torch.save(t, final)\n", ck) == ["DTM011"]
    assert codes("open(tmp_path, 'w')\n", ck) == []
    assert codes("open(path)\n", ck) == []
    assert codes("open(path, 'w')\n", OTHER) == []


def test_rules_are_scoped_to_the_port():
    src = "import os\ndef f(a=[]):\n    os.environ\n    x.item()\n"
    assert codes(src, "src/repro/launch/serve_tm.py") == []
    assert sorted(codes(src, LAUNCH)) == ["DTM002", "DTM003", "DTM007"]
