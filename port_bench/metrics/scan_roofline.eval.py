"""scan_roofline.eval: the fused d_state=1 selective-scan forward's least
time at the cell's shapes over its device time in the window."""

from port_bench import bounds
from port_bench.readers import roofline

KERNELS = {"fwd": ["fused_scan_n1_fwd_kernel"]}


def least(cfg, traffic):
    return {"fwd": sum(bounds.fused_scan_fwd(L, M)
                       for L, M in bounds.scan_shapes(cfg, traffic))}


def read(ctx):
    return roofline(ctx, KERNELS, least)
