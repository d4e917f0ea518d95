"""Microseconds a partial_fit encodes its rows and labels, from the
program's spans (``portbench.program_spans.encode_us_per_step``)."""
from portbench.program_spans import encode_us_per_step as read  # noqa: F401
