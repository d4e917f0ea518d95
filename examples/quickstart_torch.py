"""Quickstart on the PyTorch port: the unified compile/program/run API.

The mirror of ``examples/quickstart.py`` on ``repro_torch``: a TMSpec
describes the model; the TM estimator lowers it onto a compiled-once DTM
engine and drives training and evaluation (fit/predict/score).  The same
calls and seed train the same model as the JAX script, bit for bit.

    python examples/quickstart_torch.py                  # on the card
    python examples/quickstart_torch.py --device cpu     # plain versions

``main(argv)`` returns ``{"device", "history", "accuracy"}``.  The
accuracy assertion holds at the default sizes (the JAX script's).
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import TM, TMSpec  # noqa: E402
from repro_torch.data import MNIST_LIKE, make_bool_dataset  # noqa: E402

SIZES = dict(n=1024, train=768, features=MNIST_LIKE.features, clauses=256,
             epochs=5, batch=32)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    for k, v in SIZES.items():
        ap.add_argument("--" + k, type=int, default=v)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    ns = parse(argv)
    full = all(getattr(ns, k) == v for k, v in SIZES.items())
    # 784 Boolean features, 10 classes: MNIST geometry (synthetic surrogate)
    task = dataclasses.replace(MNIST_LIKE, features=ns.features)
    x, y = make_bool_dataset(task, ns.n)
    xtr, ytr = x[:ns.train], y[:ns.train]
    xte, yte = x[ns.train:], y[ns.train:]

    spec = TMSpec.coalesced(
        features=task.features,
        classes=task.classes,
        clauses=ns.clauses,    # shared clause pool (Fig 1e)
        T=48, s=6.0,           # threshold + sensitivity hyper-parameters
    )
    tm = TM(spec, seed=0, device=ns.device)
    history = tm.fit(xtr, ytr, epochs=ns.epochs, batch=ns.batch,
                     x_test=xte, y_test=yte)
    for h in history:
        print(h)
    acc = tm.score(xte, yte)
    print(f"final test accuracy: {acc:.3f}")
    if full:
        assert acc > 0.8, acc
    return {"device": str(tm.engine.device), "history": history,
            "accuracy": acc}


if __name__ == "__main__":
    main()
