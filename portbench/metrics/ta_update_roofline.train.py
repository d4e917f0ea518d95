"""The TA update kernels' share of their roofline in the traced stretch
(``portbench.readers.ta_update_roofline``)."""
from portbench.readers import ta_update_roofline as read  # noqa: F401
