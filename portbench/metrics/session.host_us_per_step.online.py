"""Host microseconds a partial_fit outside the replay, from the program's
spans (``portbench.program_spans.host_us_per_step``)."""
from portbench.program_spans import host_us_per_step as read  # noqa: F401
