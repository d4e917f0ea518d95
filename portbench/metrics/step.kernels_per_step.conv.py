"""Kernels launched a conv training step in the traced pass
(``portbench.readers.kernels_per_step``)."""
from portbench.readers import kernels_per_step as read  # noqa: F401
