# ------------------------------------------------------------------
"""The Dense weight-gradient kernel (csrc/grouped_wgrad.cu) against the
cuBLAS weight gradient it replaces, timed in one process on one card.

    python -m idee_tpu_torch.kernels.bench_grouped_wgrad \
        [--out <result.json>]

At each Dense shape of the bench cells' steps (``kernels/bounds.py``:
Mamba's six layers in float32 and Swin_3D's four in bf16, 320,000 tokens,
three blocks a step) the script draws seeded x and dy; holds the kernel's
dW and db against a float64 sum (within ``float64_wgrad``'s limit, the
float32 sums' own rounding, and at bf16 half an ulp more) and two runs
bit for bit, the bf16 dW within one bf16 ulp of cuBLAS's plus cuBLAS's
own rounding (``cublas_allowance``), and, in float32, the control: the
kernel on TF32-rounded operands must miss the limit; then times, with
CUDA events, both launches of the kernel and the weight
gradient that autograd of the einsum runs (``torch.autograd.grad`` of
``grouped_dense_plain`` for the weight and bias; cuBLAS's batched GEMM
and, with a bias, its sum), in turns (cuBLAS, kernel, kernel, cuBLAS),
beside the bound. It prints ``nvcc -Xptxas -v``'s registers and spills
(a row's ``plan`` holds its shared memory a block), a line per shape and
one JSON line with each step's sums; exits 1 without a card.
"""
# ------------------------------------------------------------------

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from idee_tpu_torch.kernels import bounds, build
from idee_tpu_torch.kernels import grouped_dense as gd

V = 6
BLOCKS_A_STEP = 3
# the cells: layers (I, O, bias), compute dtype
CELLS = {"mamba-f32-train-200": (bounds.MAMBA_DENSE, torch.float32),
         "swin-bf16-train-200": (bounds.SWIN_DENSE, torch.bfloat16)}
# The float32 sums' rounding. Each add of a float32 sum rounds to
# nearest, off by up to EPS of the partial sum with either sign, so a sum
# misses by about EPS sqrt(sum of its partial sums squared). The kernel's
# sums run through at most n = chunk_len + groups + n_chunks + sum_runs
# adds (a token group's share of a chunk, the groups, the chunks' partials
# in ordered runs, the runs). For terms t over M tokens with the sum S the
# partial sums squared add up to about n |t|^2 / 2 from the spread and
# n^2 S^2 / (3 M) from the mean, so the miss is a few tenths of
# EPS (sqrt(n) |t| + n |S| / sqrt(M)); the limit is FP32_C times that.
# TF32 rounds each operand to 10 mantissa bits, a miss of about
# 2^-11 |t| before any add: 2^13 / (FP32_C sqrt(n)) times the limit's
# spread term, beyond it at every shape here (``tf32_rounded``).
EPS = 2.0 ** -24
FP32_C = 8
# cuBLAS's own rounding, in the comparison with its bf16 weight gradient:
# its split of the tokens is its own, and at 320,000 tokens its result
# lies up to ~2 bf16 ulps from float64, beyond its chain's limit; so that
# comparison allows CUBLAS_REL x the sum of |x||dy| besides one ulp
CUBLAS_REL = 1e-5
ITERS = 20  # launches a timing


def ptxas_report() -> str:
    out = build.BUILD_DIR / "ptxas_grouped_wgrad.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC / "grouped_wgrad.cu")],
        capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def cuda_ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(t):
    m, e = torch.frexp(t.float().abs())
    return torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def float64_wgrad(x, gy, I, O, has_bias, V=V):
    """(dW, db, dW's limit, db's limit) of x [..., V*I] and gy [..., V*O]:
    float64 sums over the leading axes, and the float32 sums' rounding
    (FP32_C above) along the kernel's chains at the plan of the shape; db
    and its limit None without a bias."""
    x3 = x.double().reshape(-1, V, I)
    g3 = gy.double().reshape(-1, V, O)
    M = x3.shape[0]
    p = gd.wgrad_plan(M, V, I, O, has_bias, x.element_size())
    n = p.chunk_len + p.groups + p.n_chunks + p.sum_runs

    def limit(total, squares):
        return FP32_C * EPS * (n ** 0.5 * squares.sqrt()
                               + n * total.abs() / M ** 0.5)

    dw = torch.einsum("mvi,mvo->vio", x3, g3)
    dw_limit = limit(dw, torch.einsum("mvi,mvo->vio", x3.square(),
                                      g3.square()))
    if not has_bias:
        return dw, None, dw_limit, None
    db = g3.sum(0).reshape(V * O)
    return dw, db, dw_limit, limit(db, g3.square().sum(0).reshape(V * O))


def tf32_rounded(t):
    """float32 t with each mantissa rounded to TF32's 10 bits (to nearest,
    ties to even): the operands a TF32 product takes."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).reshape(t.shape)


def cublas_allowance(x, gy, I, O, V=V):
    """CUBLAS_REL x the float64 sum of |x||dy| of each dW entry."""
    return CUBLAS_REL * torch.einsum(
        "mvi,mvo->vio", x.double().abs().reshape(-1, V, I),
        gy.double().abs().reshape(-1, V, O))


def beyond(got, want, limit, extra=0.0) -> int:
    """Entries of got more than limit + extra from the float64 want."""
    return int(((got.double() - want).abs() > limit + extra).sum())


def measure(I, O, has_bias, dtype, M, seed, iters):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, V * I, device="cuda", generator=g).to(dtype)
    gy = torch.randn(M, V * O, device="cuda", generator=g).to(dtype)
    dw, db = gd.grouped_wgrad(x, gy, V, has_bias)
    dw2, db2 = gd.grouped_wgrad(x, gy, V, has_bias)
    torch.cuda.synchronize()
    row = {"I": I, "O": O, "bias": has_bias, "M": M, "seed": seed,
           "plan": vars(gd.wgrad_plan(M, V, I, O, has_bias,
                                      x.element_size())),
           "bit_equal_reruns": bool(torch.equal(dw, dw2) and (
               not has_bias or torch.equal(db, db2)))}
    want, want_b, limit, limit_b = float64_wgrad(x, gy, I, O, has_bias)
    bf16 = dtype == torch.bfloat16

    def misses(w, b):
        # bf16: the float32 sum rounded once, within half an ulp more
        n = beyond(w, want, limit, bf16_ulp(want) / 2 if bf16 else 0.0)
        if has_bias:
            n += beyond(b, want_b, limit_b, bf16_ulp(want_b) / 2 if bf16
                        else 0.0)
        return n

    row["max_abs_err"] = (dw.double() - want).abs().max().item()
    row["beyond_tolerance"] = misses(dw, db)
    if has_bias:
        row["bias_max_abs_err"] = (db.double() - want_b).abs().max().item()
    if not bf16:
        # the control: the same sums of TF32 operands miss the limit
        row["tf32_control_beyond"] = misses(*gd.grouped_wgrad(
            tf32_rounded(x), tf32_rounded(gy), V, has_bias))
        row["tf32_control_entries"] = want.numel() + (
            want_b.numel() if has_bias else 0)

    # cuBLAS: the weight (and bias) gradient autograd of the einsum runs
    w = torch.randn(V, I, O, device="cuda", generator=g).to(dtype)
    w.requires_grad_(True)
    b = (torch.zeros(V * O, device="cuda", dtype=dtype, requires_grad=True)
         if has_bias else None)
    y = gd.grouped_dense_plain(x, w, b)
    params = [w] + ([b] if has_bias else [])

    def cublas():
        return torch.autograd.grad(y, params, gy, retain_graph=True)

    lib = cublas()
    torch.cuda.synchronize()
    if bf16:
        # within one bf16 ulp of cuBLAS's, plus cuBLAS's own rounding
        off = (dw.float() - lib[0].float()).abs()
        row["vs_cublas_beyond_1_ulp"] = int((off > bf16_ulp(lib[0])
            + cublas_allowance(x, gy, I, O).float()).sum())
        row["cublas_beyond_half_ulp_and_limit"] = beyond(
            lib[0], want, limit, bf16_ulp(want) / 2)
    row["vs_cublas_max_abs_diff"] = (dw.float() - lib[0].float()).abs().max(
    ).item()
    times = {"cublas": [], "kernel": []}
    for which in ("cublas", "kernel", "kernel", "cublas"):
        fn = (cublas if which == "cublas"
              else lambda: gd.grouped_wgrad(x, gy, V, has_bias))
        times[which].append(cuda_ms(fn, iters))
    bound, by = bounds.grouped_wgrad(M, V, I, O, has_bias,
                                     "bfloat16" if bf16 else "float32")
    row.update(kernel_ms=times["kernel"], cublas_ms=times["cublas"],
               bound_ms=bound, bound_by=by,
               share_of_bound=bound / min(times["kernel"]))
    return row


def row_ok(row) -> bool:
    """Within the limit of float64 (and, at bf16, of cuBLAS), bit-equal
    over two runs, and in float32 the TF32 control beyond it."""
    return (row["bit_equal_reruns"] and not row["beyond_tolerance"]
            and not row.get("vs_cublas_beyond_1_ulp", 0)
            and row.get("tf32_control_beyond", 1) > 0)


def per_step(rows):
    """A step's sums of the rows' times (the faster of each side's two)
    and bounds, three blocks of the layers."""
    step = {k: BLOCKS_A_STEP * sum(min(r[k]) if isinstance(r[k], list)
                                   else r[k] for r in rows.values())
            for k in ("kernel_ms", "cublas_ms", "bound_ms")}
    step["share_of_bound"] = step["bound_ms"] / step["kernel_ms"]
    step["speedup_over_cublas"] = step["cublas_ms"] / step["kernel_ms"]
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build(sorted(set(gd.SOURCES.values())))
    print(ptxas_report(), flush=True)
    result = {"card": card, "tokens": bounds.DENSE_TOKENS, "cells": {}}
    failed = []
    for cell, (layers, dtype) in CELLS.items():
        rows = {}
        for i, (name, (I, O, has_bias)) in enumerate(layers.items()):
            row = measure(I, O, has_bias, dtype, bounds.DENSE_TOKENS,
                          seed=70 + i, iters=ITERS)
            rows[name] = row
            print(json.dumps({cell: {name: row}}), flush=True)
            if not row_ok(row):
                failed.append(f"{cell} {name}")
            torch.cuda.empty_cache()
        step = per_step(rows)
        result["cells"][cell] = {"layers": rows, "per_step": step}
        print(json.dumps({cell: {"per_step": step}}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps({c: r["per_step"] for c, r in result["cells"].items()}))
    if failed:
        print(f"beyond tolerance or not bit-equal: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
