"""The yardstick's arithmetic: the published peaks of one H100 SXM and the
least time each hand-written kernel's work could take on it, at the
shapes a cell runs.

A frozen copy of the port's ``kernels/bounds.py``: the larger of the
bytes a kernel must move (each input read once, each output written once)
over the HBM rate and its operations over the peak rate of their type.
Two changes: the shapes come from the cell (``scan_shapes``,
``attention_shapes``) rather than the 200x200 bench width, and the
attention backward's dbias sum is no work of its own: its partial sums
are an artefact of the implementation, so the backward's bound (which
counts the dbias output) is set against the time of both launches.
"""

import math
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_FLOPS = {"float32": PEAK_FP32_PER_S, "bfloat16": PEAK_BF16_PER_S}

# bytes per element of q, k, v, o and their gradients, and the peak rate of
# the attention's products on such inputs
ATTN_TYPES = {"float32": (4, PEAK_FP32_PER_S),
              "bfloat16": (2, PEAK_BF16_PER_S)}

# float32 operations per element of the fused scan: 8 mul, 3 add, 1 div,
# 2 exp (recurrence, skip term and silu gating)
SCAN_OPS_PER_ELEMENT = 14


def bound_s(n_bytes: float, n_ops: float,
            peak_ops: float = PEAK_FP32_PER_S) -> float:
    """The least seconds: the larger of the bytes' and the operations'
    time."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops)


def fused_scan_fwd(L: int, M: int, with_h: bool = False) -> float:
    """The d_state=1 fused scan forward: reads delta, u, B, C, z [L, M] and
    A, D [M]; writes y (and, for a backward, h)."""
    n_bytes = 4 * (5 * L * M + 2 * M + (2 if with_h else 1) * L * M)
    return bound_s(n_bytes, SCAN_OPS_PER_ELEMENT * L * M)


def fused_scan_bwd(L: int, M: int) -> float:
    """The fused scan's backward: reads delta, u, B, C, z, h and the output
    gradient [L, M] and A, D [M]; writes ddelta, du, dB, dC, dz [L, M] and
    dA, dD [M]; about 30 float32 operations per element."""
    return bound_s(4 * (12 * L * M + 4 * M), 30 * L * M)


def window_attention_fwd(BW: int, n: int, G: int, hd: int,
                         dtype: str = "float32") -> float:
    """softmax(q k^T scale + bias + mask) v over BW windows of n tokens and
    G heads of width hd: reads q, k, v, writes o; 4 n^2 hd flops per
    window-head."""
    size, peak = ATTN_TYPES[dtype]
    return bound_s(4 * size * BW * n * G * hd, 4 * n * n * hd * BW * G, peak)


def window_attention_bwd(BW: int, n: int, G: int, hd: int,
                         dtype: str = "float32") -> float:
    """Reads q, k, v, g and the float32 bias [G, n, n]; writes dq, dk, dv
    and the float32 dbias [G, n, n] summed over the windows; recomputes
    the scores, then four products: 10 n^2 hd flops per window-head."""
    size, peak = ATTN_TYPES[dtype]
    n_bytes = 7 * size * BW * n * G * hd + 2 * 4 * G * n * n
    return bound_s(n_bytes, 10 * n * n * hd * BW * G, peak)


def shrink(size: Sequence[int], window: Sequence[int]) -> Tuple[int, ...]:
    """The window cut to an input no larger than it."""
    return tuple(s if s <= w else w for s, w in zip(size, window))


def windows(cfg: dict, traffic: dict) -> List[Tuple[int, int, int]]:
    """(stage, windows in the batch, tokens a window) of every encoder
    block in forward order, at the traffic's input size."""
    size = (cfg["delta_t"], traffic["height"], traffic["width"])
    out = []
    for i, window in enumerate(cfg["en_window_size"]):
        if i == 0:
            size = tuple(-(-s // p) for s, p in zip(size, cfg["en_patch_size"]))
        ws = shrink(size, window)
        nw = traffic["batch_size"] * math.prod(-(-s // w)
                                               for s, w in zip(size, ws))
        out += [(i, nw, math.prod(ws))] * cfg["en_depths"][i]
    return out


def scan_shapes(cfg: dict, traffic: dict) -> List[Tuple[int, int]]:
    """(L, M) of the fused scan of every Mamba block: L tokens a window,
    M = windows x variables x inner channels."""
    V = cfg["in_channels_dynamic"]
    return [(L, nw * V * cfg["expand"][i] * cfg["en_embed_dim"][i])
            for i, nw, L in windows(cfg, traffic)]


def attention_shapes(cfg: dict, traffic: dict
                     ) -> List[Tuple[int, int, int, int]]:
    """(BW, n, G, hd) of the window attention of every Swin_3D block."""
    V = cfg["in_channels_dynamic"]
    return [(nw, L, V * cfg["en_n_heads"][i],
             cfg["en_embed_dim"][i] // cfg["en_n_heads"][i])
            for i, nw, L in windows(cfg, traffic)]
