# ------------------------------------------------------------------
"""Port modules against their JAX counterparts, on the CPU.

Each test builds the flax module, carries its parameters into the port
module through ``flax_to_state_dict`` (the leaf rules behind
``load_flax_params``), feeds both the same numpy input and compares in
float32 at atol 1e-5 / rtol 1e-4: the port's grouped conv / batched einsum
forms sum in another order than the JAX package's block-diagonal dense
forms, which moves results by a few float32 ulps per layer.
"""
# ------------------------------------------------------------------

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idee_tpu import losses as jlosses
from idee_tpu.config import Config as JConfig
from idee_tpu.config import save_options
from idee_tpu.data.fake import make_fake_cube as jax_make_fake_cube
from idee_tpu.data.synthetic import SyntheticDataset as JDataset
from idee_tpu.models.vq_model import VQOutput as JVQOutput
from idee_tpu.nn import classifier as jcls
from idee_tpu.nn import cnn3d as jcnn
from idee_tpu.nn import layers as jl
from idee_tpu.nn import mamba as jm
from idee_tpu.nn import swin3d as jsw
from idee_tpu.quant.lfq import LFQ as JLFQ
from idee_tpu.train import metrics as jmetrics
from idee_tpu.train import steps as jsteps
from idee_tpu_torch import losses
from idee_tpu_torch.config import load_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.models.interop import flax_to_state_dict
from idee_tpu_torch.models.vq_model import VQOutput
from idee_tpu_torch.nn import classifier, cnn3d, layers, mamba, swin3d
from idee_tpu_torch.quant.lfq import LFQ
from idee_tpu_torch.train import metrics, steps

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4


def _flax(module, *args, seed=0, std=0.1, method=None, **kw):
    """Parameters for ``module`` on ``args``: the flax tree's shapes (from
    an abstract init) filled with N(0.02, std) from a numpy seed."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, method=method,
                               **kw), *[jnp.asarray(a) for a in args])
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda s: (0.02 + std * rng.normal(size=s.shape)).astype(np.float32),
        shapes.get("params", {}))


def _apply(module, params, *args, method=None, **kw):
    """module.apply, jitted (one XLA compile is quicker on this CPU than
    the eager per-op dispatch); ``args`` are arrays, ``kw`` static."""
    fn = jax.jit(lambda p, *a: module.apply({"params": p}, *a,
                                            method=method, **kw))
    out = fn(params, *[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params,
                                               module.state_dict()),
                          strict=True)
    return module.eval()


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- layers

CONV_CASES = {
    "replicate_3x3x3": dict(in_features=4, features=5, kernel_size=(3, 3, 3),
                            padding_mode="replicate", use_bias=False,
                            shape=(2, 4, 6, 6)),
    "classifier_2x3x3_stride2": dict(in_features=4, features=3,
                                     kernel_size=(2, 3, 3),
                                     strides=(2, 1, 1),
                                     padding=((0, 0), (1, 1), (1, 1)),
                                     use_bias=True, shape=(1, 8, 5, 5)),
    "pointwise_1x1x1": dict(in_features=1, features=8, kernel_size=(1, 1, 1),
                            padding=((0, 0), (0, 0), (0, 0)), use_bias=False,
                            shape=(2, 3, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_grouped_conv3d(case):
    kw = dict(CONV_CASES[case])
    shape = kw.pop("shape")
    V = 3
    x = _x(shape + (V * kw["in_features"],))
    jmod = jl.GroupedConv3d(n_groups=V, **kw)
    p = _flax(jmod, x, std=0.1)
    got = _port(layers.GroupedConv3d(V, **kw), p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


@pytest.mark.parametrize("use_bias", [False, True])
def test_grouped_dense(use_bias):
    V, fin, fout = 3, 8, 12
    x = _x((2, 5, V * fin))
    jmod = jl.GroupedDense(V, fin, fout, use_bias=use_bias)
    p = _flax(jmod, x, std=0.1)
    got = _port(layers.GroupedDense(V, fin, fout, use_bias=use_bias),
                p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


@pytest.mark.parametrize("affine", [False, True])
def test_grouped_layernorm3d(affine):
    V, C = 3, 8
    x = _x((2, 2, 4, 4, V * C)) * 3.0 + 1.0
    jmod = jl.GroupedLayerNorm3d(V, C, affine=affine)
    p = _flax(jmod, x, std=0.3)
    got = _port(layers.GroupedLayerNorm3d(V, C, affine=affine),
                p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


# ---------------------------------------------------------------- windows

@pytest.mark.parametrize("ws", [(2, 4, 4), (8, 1, 1)])
def test_window_partition_and_reverse(ws):
    B, D, H, W, C = 2, 8, 8, 12, 5
    x = _x((B, D, H, W, C))
    win = swin3d.window_partition(torch.from_numpy(x), ws)
    _close(win, jsw.window_partition(jnp.asarray(x), ws), atol=0, rtol=0)
    back = swin3d.window_reverse(win, ws, B, D, H, W)
    assert torch.equal(back, torch.from_numpy(x))
    assert swin3d.get_window_size((8, 2, 2), ws, (1, 2, 2)) == \
        jsw.get_window_size((8, 2, 2), ws, (1, 2, 2))


@pytest.mark.parametrize("patch,cin,shape,norm", [
    ((1, 1, 1), 1, (1, 8, 8, 8), True),
    ((2, 4, 4), 2, (1, 7, 10, 9), False),  # pads to a multiple of the patch
])
def test_packed_patch_embed3d(patch, cin, shape, norm):
    V, E = 3, 8
    x = _x(shape + (V * cin,))
    jmod = jsw.PackedPatchEmbed3D(V, cin, patch_size=patch, embed_dim=E,
                                  patch_norm=norm)
    p = _flax(jmod, x, std=0.1)
    got = _port(swin3d.PackedPatchEmbed3D(V, cin, patch_size=patch,
                                          embed_dim=E, patch_norm=norm),
                p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


# ---------------------------------------------------------------- mamba

def test_packed_mamba_ssm():
    V, dm = 3, 8
    x = _x((6, 32, V * dm))
    jmod = jm.PackedMambaSSM(n_groups=V, d_model=dm)
    p = _flax(jmod, x, std=0.1)
    got = _port(mamba.PackedMambaSSM(V, dm), p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


def test_packed_mamba_ssm_dstate_2_matches_jax():
    """The d_state > 1 branch runs through the linear-scan op and matches
    the JAX module."""
    V, dm = 3, 8
    x = _x((6, 32, V * dm))
    jmod = jm.PackedMambaSSM(n_groups=V, d_model=dm, d_state=2)
    p = _flax(jmod, x, std=0.1)
    got = _port(mamba.PackedMambaSSM(V, dm, d_state=2), p)(
        torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


@pytest.mark.parametrize("shift,shape", [
    ((0, 0, 0), (1, 4, 8, 8)),
    ((1, 2, 2), (1, 4, 10, 8)),   # shifted, and H padded to the window
])
def test_packed_mamba_block(shift, shape):
    V, dim = 3, 8
    x = _x(shape + (V * dim,))
    kw = dict(window_size=(2, 4, 4), shift_size=shift)
    jmod = jm.PackedMambaBlock(n_groups=V, dim=dim, **kw)
    p = _flax(jmod, x, std=0.1)
    got = _port(mamba.PackedMambaBlock(V, dim, **kw), p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


def test_mamba_encoder():
    kw = dict(in_vars=3, in_chans=1, embed_dim=[8, 8], depths=[2, 1])
    x = _x((1, 3, 1, 8, 16, 16))
    jmod = jm.Mamba(**kw)
    p = _flax(jmod, x, std=0.05)
    port = _port(mamba.Mamba(**kw), p)
    _close(port(torch.from_numpy(x)), _apply(jmod, p, x))
    _close(port(torch.from_numpy(x), packed_out=True),
           _apply(jmod, p, x, packed_out=True))


def test_cnn3d_encoder():
    kw = dict(in_vars=3, out_channels=[8, 8])
    x = _x((1, 3, 1, 8, 8, 8))
    jmod = jcnn.CNN_3D(**kw)
    p = _flax(jmod, x, std=0.05)
    got = _port(cnn3d.CNN_3D(**kw), p)(torch.from_numpy(x))
    _close(got, _apply(jmod, p, x))


# ---------------------------------------------------------------- quantizer

@pytest.mark.parametrize("train", [False, True])
def test_lfq_quantize_packed(train):
    V, d = 3, 8
    zp = _x((2, 4, 6, 6, V * d)) * 0.5
    jmod = JLFQ(dim=d, diversity_gamma=0.1, commitment_loss_weight=3.0)
    p = _flax(jmod, zp, std=0.2,
              method=lambda m, z: (m.quantize_packed(z, V),
                                   m.out_proj_params()))
    want = _apply(jmod, p, zp, train=train,
                  method=lambda m, z, train: m.quantize_packed(z, V, train=train))
    port = _port(LFQ(dim=d, diversity_gamma=0.1, commitment_loss_weight=3.0),
                 p)
    got = port.quantize_packed(torch.from_numpy(zp), V, train=train)
    # bits agree wherever the latent s is not within rounding of zero
    k_in, b_in = port.in_proj_params()
    s = torch.from_numpy(zp).reshape(2, 4, 6, 6, V, d) @ k_in + b_in
    clear = np.abs(s.detach().numpy()) > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got.indices.numpy()[clear],
                                  want.indices[clear])
    _close(got.s_q[torch.from_numpy(clear)], want.s_q[clear])
    _close(got.aux_loss, want.aux_loss)
    w, b = port.out_proj_params()
    _close(b - w, p["project_out"]["bias"] - p["project_out"]["kernel"][0])


# ---------------------------------------------------------------- classifier

@pytest.mark.parametrize("packed", [True, False])
def test_cnn3d_classifier(packed):
    V, C = 3, 8
    x = _x((2, 8, 6, 6, V * C)) if packed else _x((2, V, C, 8, 6, 6))
    jmod = jcls.CNN_3D_Classifier(in_var=V, embed_dim=C, dim=8)
    p = _flax(jmod, x, packed=packed, std=0.05)
    z, y = _port(classifier.CNN_3D_Classifier(in_var=V, embed_dim=C, dim=8),
                 p)(torch.from_numpy(x), packed=packed)
    zj, yj = _apply(jmod, p, x, packed=packed)
    assert tuple(z.shape) == (2, 1, 6, 6) and tuple(y.shape) == (2, V, 1, 6, 6)
    _close(z, zj)
    _close(y, yj)


# ---------------------------------------------------------------- losses

def _fake_outputs(rng, fused: bool):
    N, V, C, T, H, W = 2, 3, 4, 8, 6, 6
    s_q = np.where(rng.normal(size=(N, T, H, W, V)) > 0, 1.0, -1.0).astype(
        np.float32)
    w_out = rng.normal(size=(C,)).astype(np.float32)
    b_out = rng.normal(size=(C,)).astype(np.float32)
    zq = (s_q[..., None] * w_out + b_out).transpose(0, 4, 5, 1, 2, 3)
    mel = (rng.random((N, H, W)) < 0.3).astype(np.float32)
    loss_anom = None
    if fused:
        loss_anom = np.asarray(jlosses.anomaly_l1_lfq(
            jnp.asarray(s_q), jnp.asarray(1.0 - mel), jnp.asarray(w_out),
            jnp.asarray(b_out)))
    fields = dict(z=rng.normal(size=(N, 1, H, W)).astype(np.float32),
                  y=rng.normal(size=(N, V, 1, H, W)).astype(np.float32),
                  anomaly=(s_q > 0).astype(np.int32), z_q=zq,
                  loss_z_q=np.float32(0.25), vq0=b_out - w_out,
                  loss_anomaly=loss_anom)
    return fields, mel, (s_q, w_out, b_out)


@pytest.mark.parametrize("weighting,fused,all_negative", [
    ("reference", False, False), ("reference", True, False),
    ("capped", True, False), ("focal", True, False),
    ("reference", True, True),   # zero-count class guard
])
def test_total_loss_synthetic(weighting, fused, all_negative):
    rng = np.random.default_rng(5)
    fields, mel, _ = _fake_outputs(rng, fused)
    me = (rng.random(mel.shape) < 0.2).astype(np.float32)
    if all_negative:
        me[:] = 0
    jout = JVQOutput(**{k: None if v is None else jnp.asarray(v)
                        for k, v in fields.items()})
    pout = VQOutput(**{k: None if v is None else torch.tensor(np.array(v))
                       for k, v in fields.items()})
    kw = dict(weighting=weighting, weight_cap=50.0, focal_gamma=2.0)
    want, wcomps = jlosses.total_loss_synthetic(
        jout, jnp.asarray(me), jnp.asarray(mel), 100.0, **kw)
    got, comps = losses.total_loss_synthetic(
        pout, torch.from_numpy(me), torch.from_numpy(mel), 100.0, **kw)
    for k in wcomps:
        _close(comps[k], wcomps[k])


def test_anomaly_l1_lfq_equals_dense_form():
    rng = np.random.default_rng(6)
    fields, mel, (s_q, w_out, b_out) = _fake_outputs(rng, fused=False)
    got = losses.anomaly_l1_lfq(torch.from_numpy(s_q),
                                torch.from_numpy(1.0 - mel),
                                torch.from_numpy(w_out),
                                torch.from_numpy(b_out))
    dense = jlosses.anomaly_l1_loss_synthetic(
        jnp.asarray(fields["z_q"]), jnp.asarray(mel),
        jnp.asarray(fields["vq0"]))
    _close(got, dense)


# ---------------------------------------------------------------- steps

def test_epoch_counters_and_votes():
    rng = np.random.default_rng(8)
    N, V, dt, H, W, T = 2, 3, 8, 5, 5, 20
    anomaly = (rng.random((N, V, dt, H, W)) < 0.4).astype(np.int32)
    t_index = np.array([7, 12])
    vs, vc = jsteps._scatter_votes(jnp.zeros((V, T, H, W), jnp.uint8),
                                   jnp.zeros((T,), jnp.int32),
                                   jnp.asarray(anomaly),
                                   jnp.asarray(t_index), dt)
    m = steps.init_epoch_metrics((V, T, H, W), "cpu")
    steps._scatter_votes(m["vote_sum"], m["vote_cnt"],
                         torch.from_numpy(anomaly), torch.from_numpy(t_index),
                         dt)
    np.testing.assert_array_equal(m["vote_sum"].numpy(), np.asarray(vs))
    np.testing.assert_array_equal(m["vote_cnt"].numpy(), np.asarray(vc))
    np.testing.assert_array_equal(
        metrics.majority_vote_from_device(m["vote_sum"].numpy(),
                                          m["vote_cnt"].numpy()),
        jmetrics.majority_vote_from_device(np.asarray(vs), np.asarray(vc)))

    pred_c = (rng.random((N, 1, H, W)) < 0.5).astype(np.float32)
    gt = (rng.random((N, 1, H, W)) < 0.3).astype(np.float32)
    want = jsteps.extreme_counts(jnp.asarray(pred_c), jnp.asarray(gt))
    got = steps.extreme_counts(torch.from_numpy(pred_c), torch.from_numpy(gt))
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}


# ---------------------------------------------------------------- config, data

def test_config_json_snapshot_loads_unchanged(tmp_path):
    cfg = JConfig(name="snap", dir_log=str(tmp_path), encoder="Mamba",
                  en_embed_dim=[8, 8], times_test=(3, 40))
    save_options(cfg)
    port = load_config(str(tmp_path / "snap" / "config.json"))
    assert port.to_dict() == JConfig.from_dict(port.to_dict()).to_dict()
    for k, v in cfg.to_dict().items():
        assert list(np.ravel(getattr(port, k))) == list(np.ravel(v)), k


def test_fake_cube_and_dataset_items_match_jax():
    kw = dict(n_vars=3, n_time=24, height=12, width=12, seed=4)
    cube, jcube = make_fake_cube(**kw), jax_make_fake_cube(**kw)
    for f in ("dynamic", "anomaly", "extreme", "static", "clima_median",
              "clima_std"):
        np.testing.assert_array_equal(getattr(cube, f), getattr(jcube, f))
    assert cube.stats == jcube.stats
    dkw = dict(times=(1, 24), variables=cube.variables, delta_t=8,
               is_aug=True, is_clima_scale=True, x_max=12, y_max=12, seed=2)
    ds, jds = SyntheticDataset(cube=cube, **dkw), JDataset(cube=jcube, **dkw)
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
