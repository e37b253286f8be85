# ------------------------------------------------------------------
"""The bf16 window-attention kernels against an earlier design of them,
timed in one process on one card.

    python -m idee_tpu_torch.kernels.bench_bf16_attention \
        --old_source <an earlier csrc/window_attention.cu> \
        [--out chiprun_out/bf16_attention.json]

The earlier source must export the same bf16 C entry points
(``idee_window_attention_{fwd,bwd}_bf16``; where it also has the float32
``idee_window_attention_{fwd,bwd}``, those are checked too); it is built with the flags of
``kernels/build.py`` into ``kernels/build/`` and used nowhere else. At each
shape chip_smoke.py drives the bf16 kernels at (the Swin_3D bench width's
three stage shapes, those of delta_t 4, and those of a rank of a [1, 2]
space mesh, on the same seeded inputs as chip_smoke.py's checks) the
script times the forward and the backward kernel launches alone (CUDA
events; old, new, new, old; the backward without the dbias sum), beside
their bounds (chip_smoke.py's kernel phase times SDPA beside them); holds
the new design against the plain bf16 versions (one bf16 ulp + 1e-5;
dbias at rtol 1e-4, atol 1e-5 x max |dbias|) and counts the old design's
entries beyond that bound (the hi + lo design misses it at a rank's
stage-1 shape); and checks that the float32 kernels of both sources, where the
earlier one has them, give the same bits. It prints
``nvcc -Xptxas -v``'s registers and spills of the new source and one JSON
line, and exits 1 without a card.
"""
# ------------------------------------------------------------------

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from idee_tpu_torch.kernels import bounds, build
from idee_tpu_torch.kernels import window_attention as wa

G, HD = 12, 8
# chip_smoke.py's ATTN_SHAPES, ATTN_SHAPES_DT4 and SPACE_ATTN_SHAPES: (BW,
# n, the shift mask's (D, H, W, window, shift[, the window rows kept]))
SHAPES = {
    "main": {"stage0": (10_000, 32, None),
             "stage0_shifted": (10_000, 32,
                                (8, 200, 200, (2, 4, 4), (1, 2, 2))),
             "stage1": (40_000, 8, None)},
    "delta_t_4": {"stage0": (5_000, 32, None),
                  "stage0_shifted": (5_000, 32,
                                     (4, 200, 200, (2, 4, 4), (1, 2, 2))),
                  "stage1": (40_000, 4, None)},
    "space_rank": {"stage0": (5_000, 32, None),
                   "stage0_shifted": (5_000, 32,
                                      (8, 200, 200, (2, 4, 4), (1, 2, 2),
                                       (25, 50))),
                   "stage1": (20_000, 8, None)}}
ATOL, DBIAS_REL, GRAD_RTOL = 1e-5, 1e-5, 1e-4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_ARGS = [_P] * 7 + [_I] * 5 + [_F, _P]
BWD_BF16_ARGS = [_P] * 11 + [_I] * 6 + [_F, _P]
BWD_ARGS = [_P] * 12 + [_I] * 6 + [_F, _P]


def build_old(source: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    out = build.BUILD_DIR / f"libold_window_attention-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(source)], check=True)
    return ctypes.CDLL(str(out))


def ptxas_report() -> str:
    """nvcc -Xptxas -v of the new source: registers, spills, shared
    memory per kernel."""
    out = build.BUILD_DIR / "ptxas_window_attention_bf16.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(build.CSRC / "window_attention_bf16.cu")],
        capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def symbol(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def call(fn, *args):
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")


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


def beyond_ulp(got, want):
    """(the largest |got - want|, the entries beyond one bf16 ulp of want
    + ATOL)."""
    m, e = torch.frexp(want.float().abs())
    ulp = torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))
    err = (got.float() - want.float()).abs()
    return err.max().item(), int((err > ulp + ATOL).sum())


def inputs(BW, n, geom, seed):
    """chip_smoke.py's attention_inputs: q, k, v, go, bias and the mask's
    bank and idx (or None)."""
    from idee_tpu_torch.nn.swin3d import shift_mask_on

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, go = (torch.randn(BW, n, G, HD, device="cuda", generator=g)
                   for _ in range(4))
    bias = 0.5 * torch.randn(G, n, n, device="cuda", generator=g)
    bank = idx = None
    if geom is not None:
        bank, idx = shift_mask_on(*geom[:5], "cuda", *geom[5:])
        if idx.shape[0] != BW:
            raise SystemExit(f"mask of {geom}: {idx.shape[0]} windows")
    return q, k, v, go, bias, bank, idx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old_source", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build(sorted(set(wa.SOURCES.values())))
    print(ptxas_report(), flush=True)
    old = build_old(args.old_source)
    new_f32 = build.load(wa.SOURCES[wa.ATTN_FWD])
    new_bf16 = build.load(wa.SOURCES[wa.ATTN_FWD_BF16])
    fns = {
        "old": (symbol(old, "idee_window_attention_fwd_bf16", FWD_ARGS),
                symbol(old, "idee_window_attention_bwd_bf16", BWD_BF16_ARGS)),
        "new": (symbol(new_bf16, "idee_window_attention_fwd_bf16", FWD_ARGS),
                symbol(new_bf16, "idee_window_attention_bwd_bf16",
                       BWD_BF16_ARGS))}
    # the float32 kernels of both sources, where the earlier one has them
    f32 = {d: (symbol(lib, "idee_window_attention_fwd", FWD_ARGS),
               symbol(lib, "idee_window_attention_bwd", BWD_ARGS))
           for d, lib in (("old", old), ("new", new_f32))
           if hasattr(old, "idee_window_attention_fwd")}
    result = {"card": card, "old_source": str(args.old_source), "shapes": {}}
    for group, shapes in SHAPES.items():
        result["shapes"][group] = {}
        for i, (stage, shape) in enumerate(shapes.items()):
            row = measure(fns, f32, *shape, seed=60 + i)
            result["shapes"][group][stage] = row
            print(json.dumps({group: {stage: row}}), flush=True)
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


def measure(fns, f32, BW, n, geom, seed):
    """One shape's row: both designs' errors against the plain bf16
    versions (the old design's entries beyond one ulp + 1e-5 counted, the
    new design's refused), their times and the new design's occupancy."""
    scale = HD ** -0.5
    q, k, v, go, bias, bank, idx = inputs(BW, n, geom, seed)
    nW = idx.shape[0] if idx is not None else 1
    nb = wa.bwd_blocks(BW, n, G)
    mask = (bank, idx) if bank is not None else None
    row = {"BW": BW, "n": n, "G": G, "hd": HD, "seed": seed}

    # float32: both sources' kernels, the same bits
    if f32:
        o32 = {d: torch.empty_like(q) for d in fns}
        g32 = {d: [torch.empty_like(q) for _ in range(3)]
               + [torch.empty(nb, G, n, n, device="cuda")] for d in fns}
        for d, (fwd, bwd) in f32.items():
            call(fwd, q, k, v, bias, bank, idx, o32[d], BW, n, G, HD, nW,
                 scale)
            call(bwd, q, k, v, bias, bank, idx, o32["old"], go, *g32[d],
                 BW, n, G, HD, nW, nb, scale)
        torch.cuda.synchronize()
        row["float32_bit_equal"] = bool(
            torch.equal(o32["old"], o32["new"])
            and all(torch.equal(a, b) for a, b in zip(g32["old"],
                                                      g32["new"])))
        if not row["float32_bit_equal"]:
            raise SystemExit(f"{row}: the float32 kernels' bits moved")
        del o32, g32

    q, k, v, go = (t.to(torch.bfloat16) for t in (q, k, v, go))
    o_p = wa.window_attention_fwd_plain(q, k, v, bias, mask, scale)
    want = (o_p,) + wa.window_attention_bwd_plain(q, k, v, bias, mask, scale,
                                                  o_p, go)
    outs = {}
    for d, (fwd, bwd) in fns.items():
        o = torch.empty_like(q)
        grads = [torch.empty_like(q) for _ in range(3)]
        part = torch.empty(nb, G, n, n, device="cuda")
        call(fwd, q, k, v, bias, bank, idx, o, BW, n, G, HD, nW, scale)
        call(bwd, q, k, v, bias, bank, idx, go, *grads, part, BW, n, G,
             HD, nW, nb, scale)
        torch.cuda.synchronize()
        errs = {name: beyond_ulp(a, b) for name, a, b in zip(
            ("o", "dq", "dk", "dv"), [o] + grads, want)}
        dbias = wa.dbias_sum_plain(part)
        torch.testing.assert_close(
            dbias, want[4], rtol=GRAD_RTOL,
            atol=DBIAS_REL * want[4].abs().max().item())
        outs[d] = (o, grads, part)
        row[d] = {"max_abs_err": max(e for e, _ in errs.values()),
                  "beyond_1_ulp": {k_: c for k_, (_, c) in errs.items()},
                  "dbias_max_abs_err": (dbias - want[4]).abs().max().item()}
        if d == "new" and any(c for _, c in errs.values()):
            raise SystemExit(f"{row}: the new design beyond one bf16 ulp + "
                             f"{ATOL}")

    def timer(d, which):
        fwd, bwd = fns[d]
        o, grads, part = outs[d]
        if which == "forward":
            return lambda: call(fwd, q, k, v, bias, bank, idx, o, BW, n,
                                G, HD, nW, scale)
        return lambda: call(bwd, q, k, v, bias, bank, idx, go, *grads,
                            part, BW, n, G, HD, nW, nb, scale)

    for which, iters in (("forward", 50), ("backward", 20)):
        times = {"old": [], "new": []}
        for d in ("old", "new", "new", "old"):
            times[d].append(cuda_ms(timer(d, which), iters))
        bound, by = (bounds.window_attention_fwd if which == "forward"
                     else bounds.window_attention_bwd)(
            BW, n, G, HD, "bfloat16")
        occupancy = (wa.fwd_occupancy if which == "forward"
                     else wa.bwd_occupancy)(n, HD, geom is not None,
                                            torch.bfloat16)
        regs = wa.bf16_registers(n, HD)[which == "backward"]
        row[which] = {"old_ms": times["old"], "new_ms": times["new"],
                      "bound_ms": bound, "bound_by": by,
                      "share_of_bound": bound / min(times["new"]),
                      "smem_bytes_per_block": occupancy[0],
                      "blocks_per_sm": occupancy[1], "registers": regs}
    return row


if __name__ == "__main__":
    sys.exit(main())
