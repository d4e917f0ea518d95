"""Batched prediction and accuracy over a dataset (host-side loops)."""
from __future__ import annotations

from typing import Callable

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
