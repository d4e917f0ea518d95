"""Alg 6's active share of the window's clause groups
(``portbench.readers.active_groups``)."""
from portbench.readers import active_groups as read  # noqa: F401
