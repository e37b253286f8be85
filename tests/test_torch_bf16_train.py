# ------------------------------------------------------------------
"""Training and evaluation at bf16 (cfg.dtype = "bfloat16") on the CPU:
one train step of each encoder against the JAX package's at bf16, and
the drivers (train_synthetic, test_synthetic, train_real, test_real) at
bf16, train_real against JAX's.

Tiny configs as in test_torch_train.py (synthetic) and
test_torch_real_train.py (real world), weights N(0, 0.1) from a numpy
seed carried across by ``load_flax_params``; the JAX Swin runs its Pallas
attention kernels in interpret mode. Parameters and their gradients stay
float32 (only the compute is bf16). Tolerances, written in the tests:
  * one step's loss within rtol 5e-2 of JAX's at bf16;
  * its gradients, per parameter, within 5e-2 x max |grad| of JAX's bf16
    gradient wherever JAX's bf16 gradient lies within 5e-2 x max of
    JAX's own float32 one; and every parameter's within 0.1 x max |grad|
    of JAX's float32 gradient. Why two: XLA on the CPU sums the bias,
    LayerNorm-scale and depthwise-tap gradients (reductions over every
    position) in bf16, which puts them 0.08-0.82 x max |grad| off its own
    float32 gradients (measured, all three encoders), so JAX's bf16
    gradient is no reference for them; torch sums them in float32 (the
    port's: 0.003-0.016 x max off JAX's float32). Where a parameter's
    gradient is sensitive to bf16 noise, both frameworks' bf16 gradients
    sit up to 0.06-0.07 x max from float32 (measured: CNN_3D block0.conv2
    0.060 for JAX, 0.073 for the port; Swin_3D's stage-0 relative-position
    table 0.074 and 0.056), hence the float32 cap of 0.1, which a zeroed
    gradient (1.0 x max off) or a wrong one does not pass;
  * train_real's epoch losses within rtol 5e-2 of JAX's.
"""
# ------------------------------------------------------------------

import math

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params, save_flax_npz)
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.driver_real import test_real as port_test_real
from idee_tpu_torch.train.driver_real import train_real
from idee_tpu_torch.train.evaluate import test_synthetic as port_test
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step
from test_torch_real_train import _cfg as _real_cfg
from test_torch_real_train import _random_params, jx, tree  # noqa: F401

torch.set_num_threads(1)

BF16 = torch.bfloat16
GRAD_REL = 5e-2
GRAD_REL_F32 = 0.1  # every parameter's, against JAX's float32 gradient
LOSS_RTOL = 5e-2
VARS = ["var_01", "var_02", "var_03"]


def _tiny(**kw):
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=10,
                lr_warmup_epochs=0, dtype="bfloat16", name="bf16_train")
    base.update(kw)
    return synthetic_config(**base)


def _step_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32),
        "mask_extreme": (rng.random((2, 16, 16)) < 0.1).astype(np.float32),
        "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.2).astype(
            np.float32),
        "timestep": np.array([[8.0], [9.0]], np.float32),
    }


def _synthetic_params(jx, cfg, seed=11):
    model = jx.build_model(jx.cfg(cfg))
    shapes = jx.jax.eval_shape(
        lambda a: model.init(jx.jax.random.PRNGKey(0), a, train=False),
        jx.jnp.zeros((1, 3, 1, 8, 16, 16), jx.jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jx.jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])


def _jax_step(jx, cfg, params, b):
    """(loss, gradients as a port state_dict) of JAX's train loss on batch
    ``b`` at cfg.dtype, the Swin attention through its Pallas kernels."""
    from idee_tpu import losses as jlosses
    from idee_tpu.kernels import runtime

    model_j = jx.build_model(jx.cfg(cfg))
    jb = {k: jx.jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        out = model_j.apply({"params": p}, jb["x"], train=True,
                            mask_extreme_loss=jb["mask_extreme_loss"])
        return jlosses.total_loss_synthetic(
            out, jb["mask_extreme"], jb["mask_extreme_loss"],
            cfg.lambda_anomaly)[0]

    runtime.set_force_pallas(True)
    try:
        loss, grads = jx.jax.jit(jx.jax.value_and_grad(loss_fn))(params)
    finally:
        runtime.set_force_pallas(False)
    return float(loss), flax_to_state_dict(grads,
                                           build_model(cfg).state_dict())


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D", "CNN_3D"])
def test_train_step_bf16_matches_jax(jx, encoder):
    cfg = _tiny(encoder=encoder)
    _, params = _synthetic_params(jx, cfg)
    b = _step_batch()
    want_loss, want = _jax_step(jx, cfg, params, b)
    _, want32 = _jax_step(jx, cfg.replace(dtype="float32"), params, b)

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
    metrics = init_epoch_metrics((3, 20, 16, 16), "cpu")
    state, metrics = step(state, metrics,
                          {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(metrics["loss_sums"]["loss"].item(),
                               want_loss, rtol=LOSS_RTOL)
    held = worst_bf16 = worst_f32 = 0
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        jax_dev = _rel(want[k], want32[k])
        if jax_dev <= GRAD_REL:
            held += 1
            err = _rel(p.grad, want[k])
            assert err <= GRAD_REL, f"{k}: {err} x max from JAX's bf16"
            worst_bf16 = max(worst_bf16, err)
        err = _rel(p.grad, want32[k])
        assert err <= GRAD_REL_F32, (
            f"{k}: {err} x max from JAX's float32 gradient; JAX's bf16 one "
            f"is {jax_dev} off it")
        worst_f32 = max(worst_f32, err)
    n = len(list(model.parameters()))
    print(f"{encoder}: {held} of {n} gradients within {worst_bf16:.3g} x "
          f"max of JAX's bf16; all within {worst_f32:.3g} x max of JAX's "
          "float32")
    assert held >= n // 2


def test_loader_casts_x_to_bf16_on_the_host():
    cube = make_fake_cube(n_vars=3, n_time=12, height=16, width=16, seed=2)
    from idee_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cube=cube, times=(1, 12), variables=VARS,
                          delta_t=8, x_max=16, y_max=16)
    cfg = _tiny()
    batch = next(iter(DataLoader(ds, 2, device="cpu",
                                 x_dtype=compute_dtype(cfg))))
    want = torch.from_numpy(np.stack([ds[0]["x"], ds[1]["x"]]))
    assert batch["x"].dtype == BF16
    assert torch.equal(batch["x"], want.to(BF16))
    assert batch["mask_extreme"].dtype == torch.float32
    batch32 = next(iter(DataLoader(ds, 2, device="cpu")))
    assert torch.equal(batch32["x"], want)


def test_train_and_test_synthetic_at_bf16(tmp_path):
    """train_synthetic for one epoch and test_synthetic at bf16: finite
    losses, float32 parameters in the checkpoint."""
    cube = make_fake_cube(n_vars=3, n_time=20, height=16, width=16, seed=3)
    cfg = _tiny(dir_log=str(tmp_path), times_train=(1, 12),
                times_val=(13, 20), times_test=(1, 20), n_epochs=1)
    hist = train_synthetic(cfg, train_cube=cube.time_slice(1, 12),
                           val_cube=cube.time_slice(13, 20), device="cpu")
    assert all(map(math.isfinite, hist["train_loss"] + hist["val_loss"]))
    sd = hist["state"].model.state_dict()
    assert {v.dtype for k, v in sd.items()
            if v.is_floating_point()} == {torch.float32}
    res = port_test(cfg, cube=cube, params=sd, device="cpu")
    assert math.isfinite(res["mean_loss"])


def test_train_real_bf16_matches_jax(jx, tree, tmp_path):
    """train_real for 2 epochs (Mamba) at bf16 against JAX's driver at
    bf16 from the same weights, then test_real."""
    import orbax.checkpoint as ocp

    cfg = _real_cfg(tree, tmp_path / "port", dtype="bfloat16")
    _, params = _random_params(jx, cfg)
    ocp.StandardCheckpointer().save(str(tmp_path / "init_orbax"), params)
    save_flax_npz(str(tmp_path / "init.npz"), params)
    want = jx.driver.train_real(jx.cfg(cfg.replace(
        dir_log=str(tmp_path / "jax"),
        en_de_pretrained=str(tmp_path / "init_orbax"))), "CERRA")
    got = train_real(cfg.replace(en_de_pretrained=str(tmp_path /
                                                      "init.npz")),
                     "CERRA", device="cpu")
    print("train_real bf16 losses", got["train_loss"], want["train_loss"],
          got["val_loss"], want["val_loss"])
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=LOSS_RTOL)
    res = port_test_real(cfg, "CERRA",
                         params=got["state"].model.state_dict(),
                         device="cpu")
    assert math.isfinite(res["mean_iou"])


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D", "CNN_3D"])
def test_bf16_train_step_on_card_launches_its_kernels(cuda, encoder):
    """One bf16 train step on the card: the Swin attention launches only
    its bf16 kernels (and the float32 dbias sum), 3 each; Mamba the float32
    scan kernels, 3 forward and 3 backward; CNN_3D none. The loss and every
    gradient against the same step on the CPU (LOSS_RTOL, GRAD_REL x max
    |grad|), parameters and gradients float32, every encoder gradient
    nonzero."""
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.kernels import window_attention as wa

    want_launches = {
        "Mamba": {ss.FUSED_FWD: 3, ss.FUSED_BWD: 3},
        "Swin_3D": {wa.ATTN_FWD_BF16: 3, wa.ATTN_BWD_BF16: 3,
                    wa.DBIAS_SUM: 3},
        "CNN_3D": {}}[encoder]
    cfg = _tiny(encoder=encoder)
    b = _step_batch(seed=6)
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    grads, loss = [], []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        model.load_state_dict(params)
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        metrics = init_epoch_metrics((3, 20, 16, 16), dev)
        before = {**ss.launches, **wa.launches}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        batch["x"] = batch["x"].to(BF16)  # as the drivers' loaders cast it
        state, metrics = step(state, metrics, batch)
        loss.append(metrics["loss_sums"]["loss"].item())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    launched = {k: v - before[k] for k, v in {**ss.launches,
                                              **wa.launches}.items()}
    assert launched == {k: want_launches.get(k, 0) for k in launched}
    np.testing.assert_allclose(loss[1], loss[0], rtol=LOSS_RTOL)
    for k, want in grads[0].items():
        got = grads[1][k]
        assert got.dtype == torch.float32, k
        assert _rel(got, want) <= GRAD_REL, k
        if k.startswith("encoder."):
            assert got.abs().max().item() > 0, k


def test_entry_points_keep_bf16_products_reducing_in_float32(monkeypatch):
    """resolve_device, which every entry point calls, turns off cuBLAS's
    reduced-precision bf16 reductions for a CUDA device, as JAX reduces
    bf16 products in float32."""
    import idee_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        assert idee_tpu_torch.resolve_device("cuda").type == "cuda"
        assert not matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


def test_entry_points_run_float32_without_tf32(monkeypatch):
    """resolve_device turns TF32 off for cuDNN's convolutions and cuBLAS's
    products on a CUDA device (cuDNN allows it by default), so the CLIs
    compute float32 at the precision chip_smoke.py and the card tests
    check; the CPU leaves the flags alone."""
    import idee_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    old = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        assert idee_tpu_torch.resolve_device("cpu").type == "cpu"
        assert all(f.allow_tf32 for f in flags)
        assert idee_tpu_torch.resolve_device(None).type == "cuda"
        assert not any(f.allow_tf32 for f in flags)
    finally:
        for f, o in zip(flags, old):
            f.allow_tf32 = o
