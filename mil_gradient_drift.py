#!/usr/bin/env python3
# ------------------------------------------------------------------
"""DeepMIL over Swin_3D: the step gradients with the attention kernels
against the plain op's, at fixed and at trained weights, on one CUDA card,
for this checkout and, with ``--other``, a second checkout of the port.

    python3 mil_gradient_drift.py [--other DIR] [--runs 3] \
        [--weeks 40,24] [--out build/mil_gradient_drift.json]

Each checkout runs in a process of its own (``--worker``), importing its
own ``idee_tpu_torch`` and ``chip_smoke.py``, with cuDNN's deterministic
algorithms and torch's deterministic mode on for the whole process. Both
read one batch, written by this checkout's loader (the fourth of the
shuffled bench-width training set, as chip_smoke.py's phase
train_deepmil_swin draws it; ``--weeks N,T``: a cube of N weeks trained
on weeks 1-T, by default chip_smoke.py's 40 and 24) to ``--work`` (default
build/mil_gradient_drift, where the workers leave their tensors). A
worker:

  1. at the seeded weights (build_mil_model's generator seeded 0): the
     eval scores, and one train step's loss and gradients with the
     kernels;
  2. ``--runs`` times: trains 1 epoch through the checkout's MIL driver
     (chip_smoke.py's baseline config), then at the trained weights
     takes one step's gradients three ways on the kernel run's top-k
     selections: with the kernels, with the plain op in float32, and with
     the plain op in float64 (the model in float64, every float32 of the
     port's Python code read as float64 for that run).

The main process compares: the two checkouts' fixed-weight scores and
gradients, bit for bit; the trained weights across runs and checkouts;
each run's gradients as max |a - b| / max |b| per leaf, kernels against
plain float32 (chip_smoke.py's check, limit STEP_GRAD_REL), kernels and
plain float32 against float64, with the leaf
encoder.stage0.downsample.proj.kernel beside the worst leaf and every
leaf where the kernels lie farther from float64 than the plain float32
run. Prints one JSON line and writes it to ``--out``.
"""
# ------------------------------------------------------------------

import argparse
import contextlib
import json
import os
import subprocess
import sys

LEAF = "encoder.stage0.downsample.proj.kernel"


def _env():
    # cuBLAS's deterministic workspace must be set before CUDA starts
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.pop("PYTHONPATH", None)
    return env


@contextlib.contextmanager
def float64_run(model, torch):
    """The model in float64 for the duration: its modules' compute dtype,
    torch.float32 and Tensor.float read as float64, and the Swin shift
    masks (float32 constants) cast for the attention the encoder calls
    (the plain op, under chip_smoke.py's plain_ops)."""
    import idee_tpu_torch.nn.swin3d as swin3d

    saved = {m: m.dtype for m in model.modules()
             if getattr(m, "dtype", None) is torch.float32}
    f32, to_float = torch.float32, torch.Tensor.float
    attention = swin3d.window_attention

    def attention64(q, k, v, bias, mask, scale):
        if isinstance(mask, tuple):
            mask = (mask[0].double(), mask[1])
        return attention(q, k, v, bias, mask, scale)

    for m in saved:
        m.dtype = torch.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    swin3d.window_attention = attention64
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, to_float
        swin3d.window_attention = attention
        for m, dt in saved.items():
            m.dtype = dt


def cube_weeks(spec: str, c):
    """(cube length, train weeks, val weeks) of ``--weeks N,T``, or
    chip_smoke.py's without it."""
    if not spec:
        return c.N_WEEKS, c.TRAIN_WEEKS, c.VAL_WEEKS
    n, t = (int(v) for v in spec.split(","))
    return n, (1, t), (t + 1, n)


def worker(tree: str, batch_path: str, runs: int, out: str, weeks: str):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as c
    from idee_tpu_torch.baselines.mil.driver import mil_total_loss
    from idee_tpu_torch.baselines.mil.models import build_mil_model
    from idee_tpu_torch.data.fake import make_fake_cube

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    c.phase_build()
    batch = {k: v.cuda() for k, v in torch.load(batch_path).items()}
    cfg = c.baseline_config("mil", "drift", encoder="Swin_3D")

    def step(params, how, selections):
        """(grads, loss, scores) of one train step from ``params``: how is
        "kernels" (recording the top-k selections), "plain" or
        "plain64" (on the recorded selections)."""
        model = build_mil_model(cfg, "deepmil")
        model.load_state_dict(params)
        model.to("cuda").train()
        x = batch["x"]
        mask = batch["mask_extreme_loss"]
        ctx = contextlib.ExitStack()
        if how != "kernels":
            ctx.enter_context(c.plain_ops(cfg.encoder))
        ctx.enter_context(c.pinned_topk(selections, pin=how != "kernels"))
        if how == "plain64":
            model.double()
            x, mask = x.double(), mask.double()
            ctx.enter_context(float64_run(model, torch))
        g = torch.Generator(device="cuda").manual_seed(0)
        with ctx:
            out = model(x, train=True, generator=g)
            loss = mil_total_loss(cfg, "deepmil", out, mask, True, g)
            loss.backward()
        torch.cuda.synchronize()
        return ({k: p.grad.double().cpu() for k, p in
                 model.named_parameters()}, loss.item())

    result = {"tree": tree, "card": c.card_name_and_power()}
    seeded = build_mil_model(cfg, "deepmil",
                             torch.Generator().manual_seed(0)).state_dict()
    model = build_mil_model(cfg, "deepmil")
    model.load_state_dict(seeded)
    model.to("cuda").eval()
    with torch.inference_mode():
        scores = model(batch["x"]).scores.cpu()
    grads, loss = step(seeded, "kernels", [])
    result["fixed"] = {"scores": scores, "grads": grads, "loss": loss}

    n_weeks, train_weeks, val_weeks = cube_weeks(weeks, c)
    cube = make_fake_cube(n_vars=6, n_time=n_weeks, height=200,
                          width=200, seed=0)
    train, _, _ = c.baseline_drivers("mil", "deepmil")
    result["trained"] = []
    for r in range(runs):
        hist = train(cfg, cube.time_slice(*train_weeks),
                     cube.time_slice(*val_weeks))
        params = {k: v.detach().clone() for k, v in
                  hist["state"].model.state_dict().items()}
        del hist
        selections = []
        got = {how: step(params, how, selections)
               for how in ("kernels", "plain", "plain64")}
        result["trained"].append({
            "params": {k: v.cpu() for k, v in params.items()},
            "grads": {how: g for how, (g, _) in got.items()},
            "loss": {how: lo for how, (_, lo) in got.items()}})
        torch.cuda.empty_cache()
    torch.save(result, out)


def rel_errors(got, want, zero=()):
    """{leaf: max |got - want| / max |want|} over the leaves not in
    ``zero``."""
    out = {}
    for k, w in want.items():
        if k in zero:
            continue
        scale = float(w.abs().max())
        out[k] = float((got[k] - w).abs().max()) / scale if scale else 0.0
    return out


def summary(errs):
    worst = max(errs, key=errs.get)
    return {"worst_leaf": worst, "worst": errs[worst], LEAF: errs[LEAF]}


def max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--weeks", default="",
                    help="N,T: a cube of N weeks, trained on weeks 1-T")
    ap.add_argument("--out", default="build/mil_gradient_drift.json")
    # the batch and each worker's tensors (tens of MB)
    ap.add_argument("--work", default="build/mil_gradient_drift")
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("TREE", "BATCH", "RUNS", "OUT"))
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker[0], args.worker[1], int(args.worker[2]),
               args.worker[3], args.weeks)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("mil_gradient_drift: no CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as c
    from idee_tpu_torch.baselines import common
    from idee_tpu_torch.data.fake import make_fake_cube
    from idee_tpu_torch.data.loader import DataLoader

    out_dir = os.path.abspath(args.work)
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cfg = c.baseline_config("mil", "drift", encoder="Swin_3D")
    n_weeks, train_weeks, val_weeks = cube_weeks(args.weeks, c)
    cube = make_fake_cube(n_vars=6, n_time=n_weeks, height=200, width=200,
                          seed=0)
    train_ds, _ = common.make_datasets(cfg, cube.time_slice(*train_weeks),
                                       cube.time_slice(*val_weeks), False)
    loader = iter(DataLoader(train_ds, 1, device="cpu",
                             keys=["x", "mask_extreme_loss", "timestep"],
                             shuffle=True, seed=cfg.seed))
    batch = [next(loader) for _ in range(4)][-1]
    batch_path = os.path.join(out_dir, "mil_gradient_drift_batch.pt")
    torch.save({k: v.float() for k, v in batch.items()}, batch_path)

    trees = {"this": here}
    if args.other:
        trees["other"] = os.path.abspath(args.other)
    results = {}
    for name, tree in trees.items():
        path = os.path.join(out_dir, f"mil_gradient_drift_{name}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", tree, batch_path, str(args.runs), path,
                        "--weeks", args.weeks],
                       check=True, env=_env())
        results[name] = torch.load(path, weights_only=False)

    zero = [k for k in results["this"]["fixed"]["grads"]
            if k.startswith("agent.")
            and k.endswith("relative_position_bias_table")]
    report = {"card": results["this"]["card"], "trees": trees,
              "cube_weeks": cube_weeks(args.weeks, c),
              "limit": c.STEP_GRAD_REL, "leaf": LEAF, "zero": zero}
    for name, res in results.items():
        runs = []
        for r, t in enumerate(res["trained"]):
            g = t["grads"]
            kp = rel_errors(g["kernels"], g["plain"], zero)
            k64 = rel_errors(g["kernels"], g["plain64"], zero)
            p64 = rel_errors(g["plain"], g["plain64"], zero)
            runs.append({
                "loss": t["loss"],
                "params_max_diff_from_run_0": max_diff(
                    t["params"], res["trained"][0]["params"]),
                "kernels_vs_plain": summary(kp),
                "chip_check_passes": max(kp.values()) <= c.STEP_GRAD_REL,
                "kernels_vs_float64": summary(k64),
                "plain_vs_float64": summary(p64),
                "kernels_within_float64_limit":
                    max(k64.values()) <= c.STEP_GRAD_REL,
                # leaf: [kernels, plain float32] from float64, where the
                # kernels are the farther and beyond 1e-6
                "kernels_farther_from_float64": {
                    k: [k64[k], p64[k]] for k in sorted(k64)
                    if k64[k] > p64[k] and k64[k] > 1e-6},
            })
        report[name] = {"fixed_loss": res["fixed"]["loss"], "runs": runs}
    if "other" in results:
        a, b = results["this"], results["other"]
        report["between_trees"] = {
            "fixed_scores_max_diff": float(
                (a["fixed"]["scores"] - b["fixed"]["scores"]).abs().max()),
            "fixed_grads_max_diff": max_diff(a["fixed"]["grads"],
                                             b["fixed"]["grads"]),
            "fixed_loss": [a["fixed"]["loss"], b["fixed"]["loss"]],
            "trained_params_max_diff": [
                max_diff(x["params"], y["params"])
                for x, y in zip(a["trained"], b["trained"])],
        }
    line = json.dumps(report)
    print(line, flush=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
