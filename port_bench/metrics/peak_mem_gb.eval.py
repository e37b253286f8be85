"""peak_mem_gb.eval: the device's peak allocation over set-up and window,
in GB (1e9 bytes)."""

from port_bench.readers import peak_mem_gb


def read(ctx):
    return peak_mem_gb(ctx)
