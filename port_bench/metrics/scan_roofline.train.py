"""scan_roofline.train: the fused d_state=1 selective-scan kernels' least
time at the cell's shapes over their device time in the window, forward
(which keeps h for the backward) and backward."""

from port_bench import bounds
from port_bench.readers import roofline

KERNELS = {"fwd": ["fused_scan_n1_fwd_kernel"],
           "bwd": ["fused_scan_n1_bwd_kernel"]}


def least(cfg, traffic):
    shapes = bounds.scan_shapes(cfg, traffic)
    return {"fwd": sum(bounds.fused_scan_fwd(L, M, with_h=True)
                       for L, M in shapes),
            "bwd": sum(bounds.fused_scan_bwd(L, M) for L, M in shapes)}


def read(ctx):
    return roofline(ctx, KERNELS, least)
