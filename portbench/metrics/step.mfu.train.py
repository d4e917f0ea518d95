"""The whole training step's share of the chip's peak over the window
(``portbench.readers.step_mfu``)."""
from portbench.readers import step_mfu as read  # noqa: F401
