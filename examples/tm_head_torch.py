"""TM readout head over frozen backbone features, on the PyTorch port.

The mirror of ``examples/tm_head.py`` on ``repro_torch``: pooled float
features of a frozen feature extractor are thermometer-Booleanised and a
CoTM learns the classification with integer-only training.  The head is
``TMSpec.head(calib, ...)`` on the same compiled-once engine as every
other TM variant; the backbone is a stand-in (fixed random projections of
a synthetic 3-class signal).

    python examples/tm_head_torch.py                  # on the card
    python examples/tm_head_torch.py --device cpu     # plain versions

``main(argv)`` returns ``{"device", "history", "accuracy"}``.  The
accuracy assertion holds at the default sizes (the JAX script's).
"""
import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import TM, TMSpec  # noqa: E402

SIZES = dict(n=600, d_raw=24, d_feat=8, calib=128, train=448, clauses=128,
             epochs=5, batch=32)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    for k, v in SIZES.items():
        ap.add_argument("--" + k.replace("_", "-"), type=int, default=v)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    full = all(getattr(ns, k) == v for k, v in SIZES.items())
    # synthetic 3-way "sensor" task behind a frozen random-projection
    # backbone: class-dependent means, fixed mixing matrix, pooled features
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, ns.n).astype(np.int32)
    means = rng.standard_normal((3, ns.d_raw)).astype(np.float32) * 1.5
    raw = means[y] + rng.standard_normal((ns.n, ns.d_raw)).astype(np.float32)
    backbone = rng.standard_normal((ns.d_raw, ns.d_feat)).astype(np.float32)
    feats = np.tanh(raw @ backbone)                 # pooled "embeddings"

    spec = TMSpec.head(feats[:ns.calib], classes=3, therm_bits=6,
                       clauses=ns.clauses, T=32, s=4.0)
    head = TM(spec, seed=0, device=ns.device)
    history = head.fit(feats[:ns.train], y[:ns.train], epochs=ns.epochs,
                       batch=ns.batch)
    acc = head.score(feats[ns.train:], y[ns.train:], batch=64)
    print(f"TM-head accuracy on backbone features: {acc:.3f}")
    if full:
        assert acc > 0.7
    return {"device": str(head.engine.device), "history": history,
            "accuracy": acc}


if __name__ == "__main__":
    main()
