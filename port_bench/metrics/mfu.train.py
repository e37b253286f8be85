"""mfu.train: the whole step's model FLOPs over the traced window, as a
share of the chip's peak in the configuration's compute dtype."""

from port_bench.readers import mfu


def read(ctx):
    return mfu(ctx)
