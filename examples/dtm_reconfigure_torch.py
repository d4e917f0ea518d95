"""The paper's headline demo on the PyTorch port: ONE compiled DTM engine,
FIVE TM variants (Coalesced, Vanilla, Convolutional, Regression and a
booleanized feature head), each lowered to a DTMProgram and trained and
evaluated on the same stage graphs.

The mirror of ``examples/dtm_reconfigure.py`` on ``repro_torch``.  At
the end it shows that nothing was recaptured: on the card every engine
stage holds at most one CUDA graph (the JAX script's one jit cache entry
a stage), i.e. run-time reconfiguration without "resynthesis" (paper
§IV-A, Table II) across the whole model family.  The CPU runs the same
bodies eagerly and captures nothing (every count 0).

    python examples/dtm_reconfigure_torch.py                  # on the card
    python examples/dtm_reconfigure_torch.py --device cpu     # plain versions

``main(argv)`` returns ``{"device", "scores", "cache"}``: each model's
accuracy (or -MAE) and ``engine.cache_report()``.  ``--n`` scales the
data sets, ``--scale`` divides the clause counts and ``--epochs`` sets
every model's epochs (default: the JAX script's per model).
"""
import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.api import TM, TMSpec  # noqa: E402
from repro_torch.data import (KWS6_LIKE, MNIST_LIKE,  # noqa: E402
                              make_bool_dataset)

B = 32
TRAIN = 512


def flat_task(spec_like, n, train):
    x, y = make_bool_dataset(spec_like, n)
    return x[:train], y[:train], x[train:], y[train:]


def conv_task(rng, n, train):
    """Translated 3x3 motifs: flat TMs cannot solve this one."""
    motifs = np.array([[[1, 1, 1], [0, 0, 0], [1, 1, 1]],
                       [[1, 0, 1], [1, 0, 1], [1, 0, 1]],
                       [[0, 1, 0], [1, 1, 1], [0, 1, 0]]], np.int8)
    y = rng.integers(0, 3, n).astype(np.int32)
    x = (rng.random((n, 8, 8)) < 0.05).astype(np.int8)
    for i in range(n):
        r, c = rng.integers(0, 6, 2)
        x[i, r:r + 3, c:c + 3] = motifs[y[i]]
    return x[:train], y[:train], x[train:], y[train:]


def regression_task(rng, n, train):
    x = (rng.random((n, 12)) < 0.5).astype(np.int8)
    y = (0.6 * x[:, 0] + 0.3 * (x[:, 1] & x[:, 2])
         + 0.1 * x[:, 3]).astype(np.float32)
    return x[:train], y[:train], x[train:], y[train:]


def head_task(rng, n, train):
    protos = rng.standard_normal((3, 16))
    y = rng.integers(0, 3, n).astype(np.int32)
    feats = (protos[y] + 0.3 * rng.standard_normal((n, 16))
             ).astype(np.float32)
    return feats[:train], y[:train], feats[train:], y[train:]


def models(n_scale: float = 1.0, scale: int = 1, features=None) -> dict:
    """name: (spec, (x_train, y_train, x_test, y_test), epochs), the data
    drawn in the JAX script's order from one generator; ``n_scale``
    scales every data set (and the training split), ``scale`` divides the
    clause counts, ``features`` caps the two flat tasks' widths."""
    rng = np.random.default_rng(0)

    def n(k):
        return max(int(k * n_scale), 2)
    train = n(TRAIN)
    mnist = (MNIST_LIKE if features is None
             else dataclasses.replace(MNIST_LIKE, features=features))
    kws = (KWS6_LIKE if features is None
           else dataclasses.replace(KWS6_LIKE, features=features))
    xh, yh, xh_te, yh_te = head_task(rng, n(640), train)
    return {
        "mnist-like/CoTM": (TMSpec.coalesced(
            features=mnist.features, classes=10, clauses=256 // scale,
            T=48, s=6.0), flat_task(mnist, n(768), train), 4),
        "kws6-like/Vanilla": (TMSpec.vanilla(
            features=kws.features, classes=6, clauses=32 // scale, T=16,
            s=4.0), flat_task(kws, n(768), train), 4),
        "motifs/Conv": (TMSpec.conv(
            img_h=8, img_w=8, patch=3, classes=3, clauses=48 // scale,
            T=12, s=3.0), conv_task(rng, n(640), train), 4),
        "votes/Regression": (TMSpec.regression(
            features=12, clauses=128 // scale, T=128, s=3.0),
            regression_task(rng, n(768), train), 6),
        "features/Head": (TMSpec.head(
            xh[:min(128, train)], classes=3, therm_bits=4,
            clauses=32 // scale, T=16, s=4.0), (xh, yh, xh_te, yh_te), 3),
    }


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--n", type=float, default=1.0,
                    help="scale of every data set (1: the JAX script's)")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every clause count by this")
    ap.add_argument("--features", type=int, default=None,
                    help="width of the two flat tasks (default: theirs)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="epochs of every model (default: the JAX "
                         "script's per model)")
    ap.add_argument("--batch", type=int, default=B)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    roster = models(ns.n, ns.scale, ns.features)
    # the 'synthesised' accelerator: ONE engine sized for the whole roster
    tile = api.tile_for(*(spec for spec, _, _ in roster.values()))
    engine = api.compile(tile, device=ns.device)
    print(f"engine buffers: literals={engine.L} clauses={engine.R} "
          f"classes={engine.H} patches={engine.P}  device={engine.device}")

    scores = {}
    for name, (spec, (xtr, ytr, xte, yte), epochs) in roster.items():
        tm = TM(spec, engine=engine, seed=0)      # lower = data, not code
        t0 = time.time()
        tm.fit(xtr, ytr, epochs=epochs if ns.epochs is None else ns.epochs,
               batch=ns.batch)
        score = tm.score(xte, yte, batch=64)
        scores[name] = score
        metric = "acc" if spec.kind != "regression" else "-mae"
        print(f"{name:20s} {metric}={score:+.3f}  "
              f"({time.time() - t0:.1f}s)")

    report = engine.cache_report()
    print(f"captured stage graphs: {report}")
    print("(every stage <= 1 graph: five TM variants, ZERO recaptures; the "
          "session epoch graphs stay at one too because the roster "
          "standardises dataset slots, 512 samples x batch 32, the same "
          "fixed-slot discipline serve_tm uses for requests)")
    assert all(v <= 1 for v in report.values() if isinstance(v, int)), report
    # TM.fit is session-backed: training replays the epoch step graphs,
    # inference the per-batch infer graph (none captured on the CPU)
    one = int(engine.graphed)
    assert report["infer"] == one and report["fit_epoch"] == one
    assert report["fit_epoch_conv"] == one
    print(f"kernel path per stage: {report['path_per_stage']}")
    return {"device": str(engine.device), "scores": scores, "cache": report}


if __name__ == "__main__":
    main()
