"""Host-side train/eval loops shared by the estimator and its callers.

``fit_loop`` drives a step function batch by batch; the engine's
``TMSession.fit_epochs`` stages the data on the device instead.  Both
build their per-epoch records through :func:`epoch_record`, so their
histories compare exactly.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def batched_predict(predict_fn: Callable, x, batch: int = 256) -> np.ndarray:
    """Run ``predict_fn`` over ``x`` in batches of ``batch`` rows and
    concatenate the results as numpy."""
    x = np.asarray(x)
    return np.concatenate([_host(predict_fn(x[i:i + batch]))
                           for i in range(0, x.shape[0], batch)])


def accuracy(predict_fn: Callable, x, y, batch: int = 256) -> float:
    pred = batched_predict(predict_fn, x, batch=batch)
    return float((pred == np.asarray(y)).mean())


def epoch_record(ep: int, agg: dict, n: int,
                 extra_metrics: Optional[Callable] = None) -> dict:
    """Per-epoch record from the summed step stats ``agg`` (plain ints:
    ``selected``, ``active_groups``, ``total_groups``, ``correct``, ...)
    over ``n`` datapoints."""
    tot = agg.get("total_groups", 0)
    rec = {"epoch": ep,
           "train_acc": agg.get("correct", 0) / max(n, 1),
           "selected_clauses": agg.get("selected", 0),
           "active_groups": agg.get("active_groups", 0),
           "total_groups": tot,
           "group_skip_frac": ((tot - agg.get("active_groups", 0))
                               / max(tot, 1))}
    if extra_metrics is not None:
        rec.update(extra_metrics(agg, n))
    return rec


def fit_loop(step_fn: Callable, x, y, epochs: int = 1, batch: int = 32,
             rng: Optional[np.random.Generator] = None, log_every: int = 0,
             score_fn: Optional[Callable] = None, x_test=None, y_test=None,
             extra_metrics: Optional[Callable] = None) -> list:
    """Epoch loop: shuffle, ``step_fn(xb, yb)`` per batch (a mapping of
    scalar stats), sum the stats, one :func:`epoch_record` per epoch."""
    x, y = np.asarray(x), np.asarray(y)
    rng = rng or np.random.default_rng(0)
    n = x.shape[0] - x.shape[0] % batch
    history = []
    for ep in range(epochs):
        perm = rng.permutation(x.shape[0])[:n]
        agg: dict = {}
        for i in range(0, n, batch):
            idx = perm[i:i + batch]
            for k, v in dict(step_fn(x[idx], y[idx])).items():
                agg[k] = agg.get(k, 0) + int(v)
        rec = epoch_record(ep, agg, n, extra_metrics)
        if score_fn is not None and x_test is not None:
            rec["test_acc"] = score_fn(x_test, y_test)
        history.append(rec)
        if log_every and ep % log_every == 0:
            print(rec)
    return history
