"""The port's reconfiguration benchmark against the JAX package's (CPU).

``reconfig_benchmark`` serves and trains the five ``demo_specs`` kinds
round-robin off one engine; its report has the JAX report's keys (with
``device`` for ``backend``), the same request and swap counts, and it
passes its own check that no stage holds more than one graph.
"""
import json

import pytest

from repro.launch import serve_tm as jserve
from repro_torch.launch import serve_tm as tserve


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("reconfig")
    port = tserve.reconfig_benchmark(device="cpu", rounds=1,
                                     out=str(d / "port.json"),
                                     autotune_cache=d / "plans.json")
    jax = jserve.reconfig_benchmark(backend="ref", rounds=1,
                                    out=str(d / "jax.json"))
    return port, jax, d


def test_report_has_jax_keys_with_device_for_backend(reports):
    port, jax, _ = reports
    assert set(port) == (set(jax) - {"backend"}) | {"device"}
    assert set(port["server"]) == set(jax["server"])
    assert port["device"] == "cpu"
    assert port["tile"] == jax["tile"]


def test_counts_and_cache_check_match_jax(reports):
    port, jax, _ = reports
    for key in ("requests", "swaps", "tenants", "program_nbytes",
                "resident"):
        assert port["server"][key] == jax["server"][key], key
    cache = port["server"]["cache"]
    assert all(v <= 1 for v in cache.values() if isinstance(v, int))
    assert port["n_models"] == 5 and port["rounds"] == 1
    assert port["resynthesis_baseline_s"] > 0
    assert set(port["steady_us"]) == set(jax["steady_us"])


def test_report_is_written(reports):
    port, _, d = reports
    on_disk = json.loads((d / "port.json").read_text())
    assert on_disk["swap_us"] == port["swap_us"]


def test_main_smoke_writes_its_report(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert tserve.main(["--smoke", "--device", "cpu", "--rounds", "1",
                        "--out", str(out), "--autotune", "off"]) == 0
    assert json.loads(out.read_text())["n_models"] == 5
    assert "resynthesis baseline" in capsys.readouterr().out
