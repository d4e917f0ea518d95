"""Tiny stand-ins for the cells that ``pb_tiny``'s tables do not name.

``pb_tiny.make_tree`` maps every cell of the real manifest to a tiny
cell (``CELLS``), so each cell added to ``BENCHMARK.json`` needs a tiny
twin there.  ``conv_mnist.fit_b32``'s is a conv cell of 12x12 images,
patch 5, 64 clauses and 4 classes, judged by the benchmark's conv
reference under the tiny fit mix."""
from __future__ import annotations

from portbench.tests import pb_tiny

pb_tiny.CONFIGS.setdefault("tiny_cm", dict(
    name="tiny_cm", models={"c": pb_tiny.conv_model()},
    data={"c": dict(pb_tiny.task(144, 4, 7), shape=[12, 12])},
    train_rows=64, engine=dict(pb_tiny.ENGINE, P=64),
    reference="portbench/conv_reference.py"))
pb_tiny.CELLS.setdefault("conv_mnist.fit_b32", "tiny_cm.tfit")
