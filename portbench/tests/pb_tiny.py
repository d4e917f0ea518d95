"""A benchmark tree of tiny cells, on the CPU, for the harness's tests:
a copy of ``portbench/`` with small configurations and mixes added as
files, and a manifest that names them instead of the real cells."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

CELLS = {"mnist_cotm.fit_b32": "tiny_t.tfit",
         "mnist_cotm.online_b1": "tiny_t.tonline",
         "paper_roster4.serve_closed": "tiny_s.tclosed"}


def model(kind, f, c, h):
    return dict(kind=kind, features=f, clauses=c, classes=h, T=20, s=4.0,
                ta_bits=8, weight_bits=12, rand_bits=16,
                prng_backend="lfsr", lfsr_bits=24, seed_refresh=True,
                boost_true_positive=True)


def task(f, h, seed):
    return dict(name="t", features=f, classes=h, motifs_per_class=3,
                motif_bits=5, active_motifs=2, background_p=0.05,
                flip_p=0.02, seed=seed)


ENGINE = dict(L=128, R=128, H=8, W=4, group=128, stream_tile=256,
              prng_lanes=8192, batch_slot=8, autotune="seed", skip=True,
              ta_prng="inkernel")
CONFIGS = {
    "tiny_t": dict(name="tiny_t", models={"a": model("coalesced", 40, 50, 4)},
                   data={"a": task(40, 4, 7)}, train_rows=256,
                   engine=ENGINE),
    "tiny_s": dict(name="tiny_s",
                   models={"a": model("coalesced", 40, 50, 4),
                           "b": model("vanilla", 60, 20, 3)},
                   data={"a": task(40, 4, 7), "b": task(60, 3, 8)},
                   engine=ENGINE),
}
TRAFFIC = {
    "tfit": dict(driver="fit", epochs=1, batch=32, programs=3),
    "tonline": dict(driver="partial_fit", rate="online_rows_per_s", batch=1,
                    pass_rows=64, check_steps=3, trace_steps=16),
    "tclosed": dict(driver="serve", outstanding=2,
                    rows=dict(one_p=0.0, min=8, max=8), sla={},
                    pool_rows=256, trace_seconds=0.3),
}


def conv_model(img: int = 12, patch: int = 5, c: int = 64, h: int = 4):
    """A conv model over ``img`` x ``img`` images; it states no
    ``features``: its clauses see patch² + 2(img - patch) Boolean ones."""
    m = dict(model("conv", 0, c, h), img_h=img, img_w=img, patch=patch)
    del m["features"]
    return m


RATE = {"fit": "train_rows_per_s", "partial_fit": "online_rows_per_s"}


def add_config(root: pathlib.Path, cfg: dict, mixes=("tfit",)) -> list:
    """``cfg`` as a new configuration file of the tree at ``root``, with a
    cell of it under each traffic mix of ``mixes`` that reports the mix's
    rate (a serving mix: none in the manifest); returns the cells'
    names."""
    name = cfg["name"]
    (root / "portbench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name=name, source="tiny",
                               file=f"portbench/configs/{name}.json",
                               reduced=[], why="tiny"))
    cells = [f"{name}.{mix}" for mix in mixes]
    for cell, mix in zip(cells, mixes):
        man["workloads"].append(dict(name=cell, config=name, traffic=mix,
                                     chips=1, why="tiny"))
        rate = RATE.get(TRAFFIC[mix]["driver"])
        for m in man["end_to_end"]:
            if m["name"] == rate:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return cells


def make_tree(root: pathlib.Path) -> pathlib.Path:
    """``root`` holds a copy of the benchmark whose manifest runs the tiny
    cells in place of the real ones, with the real metrics."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, c in CONFIGS.items():
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(c))
        man["configs"].append(dict(name=name, source="tiny",
                                   file=f"portbench/configs/{name}.json",
                                   reduced=[], why="tiny"))
    for name, t in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    man["workloads"] = [dict(name=w, config=w.split(".")[0],
                             traffic=w.split(".")[1], chips=1, why="tiny")
                        for w in CELLS.values()]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
