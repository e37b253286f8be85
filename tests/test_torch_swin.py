# ------------------------------------------------------------------
"""The port's Swin_3D encoder (nn/swin3d.py) against the JAX package, and
the blocks' recompute (``en_use_checkpoint``) of all three encoders.

CPU, float32, with the same numpy-made weights carried across by
``flax_to_state_dict`` / ``load_flax_params``; on CPU tensors the window
attention runs its plain version:
  * ``relative_position_index`` and ``compute_shift_mask`` bit-equal to
    JAX's;
  * ``PackedWindowAttention3D`` (no mask, a shift mask), ``PackedSwinBlock3D``
    (unshifted, shifted, a grid the window does not divide), a stage with
    its patch-embed downsample and the whole encoder at atol 1e-5 / rtol
    1e-4 (the grouped einsums sum in another order than the JAX package's
    block-diagonal forms);
  * the Swin VQModel forward: logits within 1e-4, anomaly bits equal where
    the LFQ latent |s| > 1e-4; ``test_synthetic`` with identical metrics;
  * ``use_checkpoint=True`` gives the same values and gradients as False
    (exactly: the recompute runs the same ops on the same inputs), for
    Swin_3D, Mamba and CNN_3D, dropout and drop-path on.
The attention-dropout path (``attn_drop > 0`` under train) runs the
explicit chain; its random bits cannot match JAX's (the frameworks draw
different numbers from one seed), so it is checked against the kernel
path at a rate that keeps every element, and for reproducibility.
The 3-step train trajectory against JAX is a case of
tests/test_torch_train.py::test_train_step_trajectory_matches_jax.
Card (``gpu`` marker): one Swin train step on the card against the CPU.

JAX is imported inside fixtures, so the card-only test also collects where
JAX is not installed
(``python -m pytest --noconftest tests/test_torch_swin.py -m gpu``).
"""
# ------------------------------------------------------------------

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.kernels import window_attention as wa
from idee_tpu_torch.models.interop import flax_to_state_dict, load_flax_params
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.nn import swin3d
from idee_tpu_torch.train.evaluate import test_synthetic as port_test
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
VARS = ["var_01", "var_02", "var_03"]
N_TIME = 20


def _tiny_config(**kw):
    base = dict(encoder="Swin_3D", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, times_test=(1, N_TIME),
                batch_size=2, name="swin")
    base.update(kw)
    return synthetic_config(**base)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.nn import swin3d as jsw
    from idee_tpu.train.evaluate import test_synthetic as jax_test

    return SimpleNamespace(jax=jax, jnp=jnp, sw=jsw,
                           build_model=jax_build_model, test=jax_test,
                           cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _flax(jx, module, *args, seed=0, std=0.1, **kw):
    """The flax tree's shapes (abstract init) filled with N(0.02, std)
    from a numpy seed."""
    shapes = jx.jax.eval_shape(
        lambda *a: module.init(jx.jax.random.PRNGKey(0), *a, **kw),
        *[jx.jnp.asarray(a) for a in args])
    rng = np.random.default_rng(seed + 100)
    return jx.jax.tree_util.tree_map(
        lambda s: (0.02 + std * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])


def _apply(jx, module, params, *args, **kw):
    fn = jx.jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))
    return np.asarray(fn(params, *[jx.jnp.asarray(a) for a in args]))


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params,
                                               module.state_dict()),
                          strict=True)
    return module.eval()


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------- constants

@pytest.mark.parametrize("ws", [(2, 4, 4), (8, 1, 1), (2, 3, 3), (1, 7, 7)])
def test_relative_position_index_is_jax_s(jx, ws):
    got = swin3d.relative_position_index(ws)
    want = jx.sw.relative_position_index(ws)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", [
    (8, 200, 200, (2, 4, 4), (1, 2, 2)),     # the bench's shifted block
    (4, 8, 12, (2, 4, 4), (1, 2, 2)),
    (8, 6, 6, (2, 3, 3), (0, 1, 1)),
    (8, 4, 4, (8, 1, 1), (4, 0, 0)),
    (8, 8, 8, (2, 4, 4), (0, 0, 0)),         # nothing shifted: None
])
def test_compute_shift_mask_is_jax_s(jx, geom):
    got = swin3d.compute_shift_mask(*geom)
    want = jx.sw.compute_shift_mask(*geom)
    if want is None:
        assert got is None
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mask_and_index_are_made_once_per_geometry():
    # the first call under inference mode (evaluation) must leave tensors
    # that a later training step can save for its backward
    with torch.inference_mode():
        a = swin3d.shift_mask_on(4, 12, 12, (2, 4, 4), (1, 2, 2), "cpu")
        rpi = swin3d.relative_position_index_on((2, 4, 2), 16, "cpu")
    b = swin3d.shift_mask_on(4, 12, 12, (2, 4, 4), (1, 2, 2), "cpu")
    assert a[0] is b[0] and a[1] is b[1] and a[1].dtype == torch.int32
    assert rpi is swin3d.relative_position_index_on((2, 4, 2), 16, "cpu")
    assert not any(t.is_inference() for t in (*a, rpi))

    V, C, h, ws = 3, 8, 2, (2, 4, 4)
    attn = swin3d.PackedWindowAttention3D(V, C, ws, h)
    x = torch.from_numpy(_x((18, 32, V * C)))
    with torch.inference_mode():
        attn(x, a)
    attn(x, a).sum().backward()
    assert attn.relative_position_bias_table.grad.abs().sum() > 0


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("shifted", [False, True])
def test_packed_window_attention3d(jx, shifted):
    V, C, h, ws = 3, 8, 2, (2, 4, 4)
    mask = (swin3d.compute_shift_mask(4, 8, 8, ws, (1, 2, 2)) if shifted
            else None)
    x = _x((16, 32, V * C))                  # batch 2 of 8 windows
    jmod = jx.sw.PackedWindowAttention3D(n_groups=V, dim=C, window_size=ws,
                                         num_heads=h)
    p = _flax(jx, jmod, x, mask=mask)
    want = _apply(jx, jmod, p, x, mask=mask)
    port = _port(swin3d.PackedWindowAttention3D(V, C, ws, h), p)
    tmask = None if mask is None else tuple(map(torch.from_numpy, mask))
    _close(port(torch.from_numpy(x), tmask), want)


@pytest.mark.parametrize("shift,shape", [
    ((0, 0, 0), (2, 4, 8, 8)),
    ((1, 2, 2), (2, 4, 8, 8)),
    ((1, 2, 2), (1, 5, 10, 6)),   # D, H and W padded to the window
])
def test_packed_swin_block3d(jx, shift, shape):
    V, dim = 3, 8
    kw = dict(num_heads=2, window_size=(2, 4, 4), shift_size=shift)
    x = _x(shape + (V * dim,))
    jmod = jx.sw.PackedSwinBlock3D(n_groups=V, dim=dim, **kw)
    p = _flax(jx, jmod, x)
    port = _port(swin3d.PackedSwinBlock3D(V, dim, **kw), p)
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))


def test_packed_swin_stage_with_downsample(jx):
    V = 3
    kw = dict(in_dim=1, dim=8, depth=2, num_heads=2, window_size=(2, 4, 4))
    x = _x((1, 4, 8, 8, V))
    jmod = jx.sw.PackedSwinStage(n_groups=V, **kw)
    p = _flax(jx, jmod, x, std=0.05)
    port = _port(swin3d.PackedSwinStage(V, **kw), p)
    assert port.downsample is not None
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))


def test_swin_encoder(jx):
    kw = dict(in_vars=3, in_chans=1, embed_dim=[8, 8], depths=[2, 1])
    x = _x((1, 3, 1, 8, 16, 16))
    jmod = jx.sw.Swin_3D(**kw)
    p = _flax(jx, jmod, x, std=0.05)
    port = _port(swin3d.Swin_3D(**kw), p)
    _close(port(torch.from_numpy(x)), _apply(jx, jmod, p, x))
    _close(port(torch.from_numpy(x), packed_out=True),
           _apply(jx, jmod, p, x, packed_out=True))


def test_attention_dropout_runs_the_explicit_chain():
    V, C, h, ws = 3, 8, 2, (2, 4, 4)
    mask = tuple(map(torch.from_numpy,
                     swin3d.compute_shift_mask(4, 8, 8, ws, (1, 2, 2))))
    x = torch.from_numpy(_x((8, 32, V * C), seed=1))
    g = torch.Generator().manual_seed(0)
    fused = swin3d.PackedWindowAttention3D(V, C, ws, h, generator=g)
    # a rate at which float32 keeps every element: the chain's math alone
    chain = swin3d.PackedWindowAttention3D(V, C, ws, h, attn_drop=1e-9)
    chain.load_state_dict(fused.state_dict())
    _close(chain(x, mask, train=True, generator=g),
           fused(x, mask).detach().numpy(), atol=1e-6, rtol=1e-6)
    drop = swin3d.PackedWindowAttention3D(V, C, ws, h, attn_drop=0.3)
    drop.load_state_dict(fused.state_dict())
    runs = [drop(x, mask, train=True,
                 generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], fused(x, mask))


@pytest.mark.parametrize("encoder", ["Swin_3D", "Mamba", "CNN_3D"])
def test_use_checkpoint_gives_the_same_values_and_gradients(encoder):
    """JAX's ``nn.remat`` of the encoders' blocks as
    ``torch.utils.checkpoint``: the same loss and gradients, and with
    dropout and drop-path on, the recompute draws the same masks."""
    x = torch.from_numpy(_x((2, 3, 1, 8, 8, 8), seed=2))
    runs = []
    for flag in (False, True):
        cfg = _tiny_config(encoder=encoder, en_use_checkpoint=flag,
                           en_drop_rate=0.2, en_drop_path_rate=0.3)
        model = build_model(cfg, torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        out = model.encoder(x, train=True, generator=gen)
        loss = (out * out).mean()
        loss.backward()
        runs.append((loss.item(), gen.get_state(),
                     {k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None}))
    (l0, s0, g0), (l1, s1, g1) = runs
    assert l0 == l1
    # the recompute left the generator where the forward had left it
    assert torch.equal(s0, s1)
    assert sorted(g0) == sorted(g1) and len(g0) > 0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0,
                                   msg=lambda m: f"{k}: {m}")


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def jax_side(jx):
    """The JAX Swin VQModel of the tiny config and its parameters: the
    flax tree's shapes filled with N(0, 0.1) from a numpy seed."""
    jcfg = jx.cfg(_tiny_config())
    model = jx.build_model(jcfg)
    x = jx.jnp.zeros((1, 3, 1, 8, 16, 16), jx.jnp.float32)
    shapes = jx.jax.eval_shape(
        lambda a: model.init(jx.jax.random.PRNGKey(0), a, train=False), x)
    rng = np.random.default_rng(11)
    params = jx.jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])
    return SimpleNamespace(cfg=jcfg, model=model, params=params)


def test_load_flax_params_is_strict_for_swin(jax_side):
    cfg = _tiny_config()
    sd = load_flax_params(cfg, jax_side.params)
    assert any(k.endswith("attn.relative_position_bias_table") for k in sd)
    tree = jax_side.params
    enc = dict(tree["encoder"])
    stage = dict(enc["stage0"])
    block = dict(stage["block0"])
    attn = dict(block["attn"])
    del attn["relative_position_bias_table"]
    block["attn"], stage["block0"], enc["stage0"] = attn, block, stage
    with pytest.raises(ValueError, match="relative_position_bias_table"):
        load_flax_params(cfg, dict(tree, encoder=enc))


def test_vq_model_forward_matches_jax(jx, jax_side):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32)
    mel = (rng.random((2, 16, 16)) < 0.2).astype(np.float32)
    jnp = jx.jnp
    want = jx.jax.jit(lambda p, a, m: jax_side.model.apply(
        {"params": p}, a, train=False, mask_extreme_loss=m))(
            jax_side.params, jnp.asarray(x), jnp.asarray(mel))

    cfg = _tiny_config()
    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, jax_side.params))
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x),
                    mask_extreme_loss=torch.from_numpy(mel))
        zp = model.encoder(torch.from_numpy(x), packed_out=True)
        k_in, b_in = model.vq.in_proj_params()
        s = (zp.reshape(*zp.shape[:-1], 3, 8) @ k_in + b_in).numpy()

    for name in ("z", "y", "z_q", "vq0", "loss_anomaly", "loss_z_q"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    bits, wbits = got.anomaly.numpy(), np.asarray(want.anomaly)
    clear = np.abs(s).transpose(0, 4, 1, 2, 3) > 1e-4
    np.testing.assert_array_equal(bits[clear], wbits[clear])
    flips = int((bits[~clear] != wbits[~clear]).sum())
    assert flips <= max(1, bits.size // 1000), flips
    assert 0 < bits.mean() < 1  # both codes occur, so the bits are tested


def test_test_synthetic_matches_jax(jx, jax_side, tmp_path):
    from idee_tpu.data.fake import make_fake_cube as jax_make_fake_cube

    jcube = jax_make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                               seed=3)
    want = jx.test(jax_side.cfg.replace(dir_log=str(tmp_path / "jax")),
                   cube=jcube, params=jax_side.params)
    cube = make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)
    got = port_test(_tiny_config(dir_log=str(tmp_path / "port")), cube=cube,
                    params=jax_side.params, device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("extreme_f1", "extreme_iou", "driver_f1_pos",
              "driver_iou_pos"):
        assert (got[k] == want[k]
                or (math.isnan(got[k]) and math.isnan(want[k]))), k
    assert got["mean_loss"] == pytest.approx(want["mean_loss"], rel=1e-5)
    assert 0.0 < got["driver_f1_pos"] < 1.0


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the window-attention kernels have "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_swin_train_step_on_card_matches_cpu(cuda):
    """One Swin train step on the card (3 attention forwards, 3 backwards
    and 3 dbias sums; no scan) against the same step on the CPU: loss and
    every gradient within 1e-4 x max |grad|, every encoder parameter with
    a nonzero gradient."""
    cfg = _tiny_config()
    rng = np.random.default_rng(6)
    b = {"x": rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32),
         "mask_extreme": (rng.random((2, 16, 16)) < 0.1).astype(np.float32),
         "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.2).astype(
             np.float32),
         "timestep": np.array([[8.0], [9.0]], np.float32)}
    grads, loss = [], []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        metrics = init_epoch_metrics((3, N_TIME, 16, 16), dev)
        before = {**wa.launches, **ss.launches}
        state, metrics = step(state, metrics, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        loss.append(metrics["loss_sums"]["loss"].item())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    after = {**wa.launches, **ss.launches}
    # every other kernel, the bf16 attention's included, 0
    want = {wa.ATTN_FWD: 3, wa.ATTN_BWD: 3, wa.DBIAS_SUM: 3}
    assert {k: after[k] - before[k] for k in after} == {
        k: want.get(k, 0) for k in after}
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-4)
    for k, want in grads[0].items():
        got = grads[1][k]
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (got - want).abs().max().item() <= tol, k
        if k.startswith("encoder."):
            assert got.abs().max().item() > 0, k
