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
    concatenate the results as numpy.  The last batch is padded up to
    ``batch`` rows (its last row repeated) and the padding stripped, as
    the JAX package does, so the engine's inference sees one batch shape
    (one graph)."""
    x = np.asarray(x)
    outs = []
    for i in range(0, x.shape[0], batch):
        xb = x[i:i + batch]
        pad = batch - xb.shape[0]
        if pad:
            xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
        out = _host(predict_fn(xb))
        outs.append(out[:batch - pad] if pad else out)
    return np.concatenate(outs)


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


def feedback_fit(cfg, x, y, epochs: int = 1, batch: int = 32,
                 seed: int = 0, mode: str = "sequential", chunk: int = 8,
                 rng: Optional[np.random.Generator] = None,
                 log_every: int = 0, device=None):
    """Train on the legacy core (:func:`repro_torch.core.feedback.
    train_step`), the paper-faithful driver and the only one with the
    ``sequential`` mode (one datapoint a step, Fig 9c).  The state and
    PRNG a seed gives are the JAX package's (``PRNGKey(seed)``, ``seed +
    1``); they live on ``device`` (default CUDA).  With
    ``cfg.compute_backend == "pallas"`` the clause stage runs the
    kernels.  Returns ``(state, prng, history)``."""
    from . import threefry
    from .booleanize import to_literals
    from .device import resolve_device
    from .feedback import train_step
    from .prng import PRNG
    from .types import init_state

    dev = resolve_device(device)
    box = {"state": init_state(cfg, threefry.key(seed, dev), device=dev),
           "prng": PRNG.create(cfg, seed + 1,
                               n_lanes=max(1024, cfg.clauses * 2),
                               device=dev)}

    def step(xb, yb):
        lits = to_literals(torch.from_numpy(xb)).to(dev)
        box["state"], box["prng"], st = train_step(
            cfg, box["state"], box["prng"],
            (lits, torch.from_numpy(yb).to(dev)), mode, chunk)
        return {"selected": st.selected_clauses,
                "active_groups": st.active_groups,
                "total_groups": st.total_groups, "correct": st.correct}

    history = fit_loop(step, x, y, epochs=epochs, batch=batch, rng=rng,
                       log_every=log_every)
    return box["state"], box["prng"], history
