# ------------------------------------------------------------------
"""Least time one H100 SXM could take for each kernel's work: the larger
of the bytes it must move (each input read once, each output written
once) over the HBM rate and its operations over the peak rate for their
type: float32 outside the tensor cores, and for the bf16 attention kernels
the dense bf16 tensor-core rate (NVIDIA's H100 SXM data sheet, 700 W).

    python -m idee_tpu_torch.kernels.bounds

prints the bounds at the shapes of the bench configuration (batch 1,
200x200, 6 variables; Mamba and Swin_3D defaults of config.py) for every
kernel of the port, ported or still to port.
"""
# ------------------------------------------------------------------

import json
from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

# bytes per element of q, k, v, o and their gradients, and the peak rate of
# the attention's products on such inputs
ATTN_TYPES = {"float32": (4, PEAK_FP32_PER_S),
              "bfloat16": (2, PEAK_BF16_PER_S)}

# float32 operations per element of the fused scan: 8 mul, 3 add, 1 div,
# 2 exp (recurrence, skip term and silu gating)
SCAN_OPS_PER_ELEMENT = 14


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_FP32_PER_S) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fused_scan_fwd(L: int, M: int, with_h: bool = False):
    """fused_selective_scan_n1 forward: reads delta, u, B, C, z [L, M] and
    A, D [M]; writes y (and h)."""
    n_bytes = 4 * (5 * L * M + 2 * M + (2 if with_h else 1) * L * M)
    return bound_ms(n_bytes, SCAN_OPS_PER_ELEMENT * L * M)


def fused_scan_bwd(L: int, M: int):
    """The fused scan's whole backward, as one pass could do it: reads
    delta, u, B, C, z, h and the output gradient [L, M] and A, D [M];
    writes ddelta, du, dB, dC, dz [L, M] and dA, dD [M]. About 30 float32
    operations per element (the recomputed exp, the sigmoid, the reverse
    recurrence and the products of JAX's _fused_bwd)."""
    return bound_ms(4 * (12 * L * M + 4 * M), 30 * L * M)


def linear_scan(L: int, M: int):
    """h_t = a_t h_{t-1} + b_t: reads a, b, writes h; 2 ops per element."""
    return bound_ms(4 * 3 * L * M, 2 * L * M)


def window_attention_fwd(BW: int, n: int, G: int, hd: int,
                         dtype: str = "float32"):
    """softmax(q k^T scale + bias + mask) v over BW windows of n tokens and
    G heads of width hd, q, k, v and o of ``dtype``: reads q, k, v, writes
    o (the [G, n, n] bias and the small mask bank are negligible); 4 n^2
    hd flops per window-head for the two products."""
    size, peak = ATTN_TYPES[dtype]
    qkvo = 4 * size * BW * n * G * hd
    return bound_ms(qkvo, 4 * n * n * hd * BW * G, peak)


def window_attention_bwd(BW: int, n: int, G: int, hd: int,
                         dtype: str = "float32"):
    """Reads q, k, v, g [BW, n, G, hd] of ``dtype`` and bias [G, n, n]
    float32; writes dq, dk, dv [BW, n, G, hd] of ``dtype`` and dbias [G,
    n, n] float32 (summed over the windows); recomputes the scores, then
    four products: 10 n^2 hd flops per window-head."""
    size, peak = ATTN_TYPES[dtype]
    n_bytes = 7 * size * BW * n * G * hd + 2 * 4 * G * n * n
    return bound_ms(n_bytes, 10 * n * n * hd * BW * G, peak)


def window_attention_dbias_sum(n_blocks: int, G: int, n: int):
    """The backward's second launch: reads the per-block partials [n_blocks,
    G, n, n], writes dbias [G, n, n]; one add per partial element."""
    return bound_ms(4 * (n_blocks + 1) * G * n * n, n_blocks * G * n * n)


# bench shapes, batch 1, 200x200, 6 variables x 16 channels:
# stage 0 window (2,4,4): 10,000 windows of 32 tokens;
# stage 1 window (8,1,1): 40,000 windows of 8 tokens;
# Swin_3D: 2 heads per variable of width 8 -> G = 12
BENCH = {
    "selective_scan_fused_n1_fwd": [("stage0", fused_scan_fwd, (32, 960_000)),
                                    ("stage1", fused_scan_fwd, (8, 3_840_000))],
    "selective_scan_fused_n1_bwd": [("stage0", fused_scan_bwd,
                                     (32, 960_000)),
                                    ("stage1", fused_scan_bwd,
                                     (8, 3_840_000))],
    # the d_state=2 encoder's scans (the same folds with a state axis of 2),
    # forward and reverse; L=200 is no model window, the long-sequence
    # check of the kernel (the TPU's two-level _scan_pallas_2d shape)
    "linear_scan": [("stage0", linear_scan, (32, 1_920_000)),
                    ("stage1", linear_scan, (8, 7_680_000)),
                    ("long", linear_scan, (200, 1_000_000))],
    "window_attention_fwd": [("stage0", window_attention_fwd,
                              (10_000, 32, 12, 8)),
                             ("stage1", window_attention_fwd,
                              (40_000, 8, 12, 8))],
    "window_attention_bwd": [("stage0", window_attention_bwd,
                              (10_000, 32, 12, 8)),
                             ("stage1", window_attention_bwd,
                              (40_000, 8, 12, 8))],
    # the bf16 instantiations at the same shapes (compute dtype
    # "bfloat16": 2 bytes per q, k, v, o, g, dq, dk, dv element)
    "window_attention_fwd_bf16": [("stage0", window_attention_fwd,
                                   (10_000, 32, 12, 8, "bfloat16")),
                                  ("stage1", window_attention_fwd,
                                   (40_000, 8, 12, 8, "bfloat16"))],
    "window_attention_bwd_bf16": [("stage0", window_attention_bwd,
                                   (10_000, 32, 12, 8, "bfloat16")),
                                  ("stage1", window_attention_bwd,
                                   (40_000, 8, 12, 8, "bfloat16"))],
    # 171 blocks per head (kernels/window_attention.py: 2048 / G, fewer
    # than the 2,500 window groups of either stage)
    "window_attention_dbias_sum": [("stage0", window_attention_dbias_sum,
                                    (171, 12, 32)),
                                   ("stage1", window_attention_dbias_sum,
                                    (171, 12, 8))],
}


def main():
    for name, rows in BENCH.items():
        for stage, fn, shape in rows:
            ms, by = fn(*shape)
            print(json.dumps({"kernel": name, "stage": stage,
                              "shape": shape, "bound_ms": ms,
                              "bound_by": by}))


if __name__ == "__main__":
    main()
