"""Host milliseconds a TM.fit pass that no queued device work overlaps,
from the program's spans (``portbench.program_spans.serial_ms_per_pass``)."""
from portbench.program_spans import serial_ms_per_pass as read  # noqa: F401
