"""attn_roofline.train: the window-attention kernels' least time at the
cell's shapes over their device time in the window, forward and backward;
the backward's dbias sum is counted with the backward, whose bound
already holds the dbias output."""

from port_bench import bounds
from port_bench.readers import roofline

KERNELS = {
    "float32": {"fwd": ["attn_fwd_kernel"],
                "bwd": ["attn_bwd_kernel", "dbias_sum_kernel"]},
    "bfloat16": {"fwd": ["attn_fwd_bf16_kernel"],
                 "bwd": ["attn_bwd_bf16_kernel", "dbias_sum_kernel"]},
}


def least(cfg, traffic):
    shapes = bounds.attention_shapes(cfg, traffic)
    dt = cfg["dtype"]
    return {"fwd": sum(bounds.window_attention_fwd(*s, dt) for s in shapes),
            "bwd": sum(bounds.window_attention_bwd(*s, dt) for s in shapes)}


def read(ctx):
    return roofline(ctx, KERNELS[ctx.cfg["dtype"]], least)
