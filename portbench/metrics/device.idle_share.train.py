"""Per cent of the traced stretch in which no operation (kernel, copy or
fill) ran on the device."""
from portbench import trace


def read(ctx):
    return trace.idle_share(ctx)
