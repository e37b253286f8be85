"""attn_roofline.eval: the window-attention forward's least time at the
cell's shapes over its device time in the window."""

from port_bench import bounds
from port_bench.readers import roofline

KERNELS = {"float32": {"fwd": ["attn_fwd_kernel"]},
           "bfloat16": {"fwd": ["attn_fwd_bf16_kernel"]}}


def least(cfg, traffic):
    dt = cfg["dtype"]
    return {"fwd": sum(bounds.window_attention_fwd(*s, dt)
                       for s in bounds.attention_shapes(cfg, traffic))}


def read(ctx):
    return roofline(ctx, KERNELS[ctx.cfg["dtype"]], least)
