"""Kernels launched a training step in the traced stretch
(``portbench.readers.kernels_per_step``)."""
from portbench.readers import kernels_per_step as read  # noqa: F401
