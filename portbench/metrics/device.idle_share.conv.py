"""Per cent of the conv fit's traced pass in which no operation (kernel,
copy or fill) ran on the device."""
from portbench import trace


def read(ctx):
    return trace.idle_share(ctx)
