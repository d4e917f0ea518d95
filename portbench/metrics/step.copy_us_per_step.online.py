"""Microseconds a partial_fit copies state into and out of the step graph,
from the program's spans (``portbench.program_spans.copy_us_per_step``)."""
from portbench.program_spans import copy_us_per_step as read  # noqa: F401
