"""The conv training step's share of the chip's peak: the least time of
the work of every step of the window at the chip's peaks
(``portbench.conv_work.train_s``, with the pairs with feedback that the
step stats count) over the window."""
from portbench import conv_work


def read(ctx):
    c = ctx["counters"]
    if not c.get("steps") or not c.get("window_s"):
        return None
    (model,) = ctx["config"]["models"].values()
    t = conv_work.train_s(model, c["batch"], c["steps"], c["selected"],
                          ctx["peaks"])
    return 100.0 * t / c["window_s"]
