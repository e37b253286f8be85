"""idle_share.eval: the share of the traced window in which no operation
ran on the device (the union of the device's activity intervals)."""

from port_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
