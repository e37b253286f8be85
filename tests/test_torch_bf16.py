# ------------------------------------------------------------------
"""bf16 compute (cfg.dtype = "bfloat16") against the JAX package at
bfloat16, on the CPU: the shared layers, PackedMambaSSM, the 1-bit LFQ's
float32 island, and the VQModel forward of the three encoders (packed
1-bit LFQ) and of the generic path (VQ-EMA). The train steps are in
test_torch_bf16_train.py, the attention kernels' bf16 instantiations in
test_torch_bf16_attention.py.

Both sides get the same bf16-rounded inputs and the same float32 weights
(N(0.02, 0.1) or N(0, 0.1) from a numpy seed, carried across by
``flax_to_state_dict`` / ``load_flax_params``). The JAX Swin runs its
Pallas attention kernels in interpret mode (``set_force_pallas``), whose
roundings the port's attention follows. Tolerances, written in the tests:
  * module outputs within 2e-2 x max |ref| (the JAX package's own bf16
    LayerNorm bound, tests/test_backbones.py:150-165): XLA on the CPU
    keeps some bf16 intermediates in float32 that torch rounds, and the
    two sum in other orders, so last-bit differences of bf16 (2^-8)
    compound over a few layers;
  * anomaly bits >= 99 % equal (bits flip where the LFQ latent lies
    within bf16 noise of 0; the share is printed and asserted); model
    logits within 5e-2 x max |logit| on the pixels whose receptive field
    (7x7, every week; z: every variable, y: its own) holds no flipped
    code, and for the port's classifier fed JAX's codes everywhere. A
    flipped +-1 code moves every logit in view of it: measured, 8-34 of
    12,288 bits flipped (0.07-0.28 %) put the largest logit error at
    0.08-0.19 x max |logit| in all, 0.005-0.011 x max where no flip is in
    view; each framework's bf16 logits differ from its own float32 ones
    by as much (0.08-0.13 x max, Mamba and CNN_3D);
  * GroupedLayerNorm3d at float32 bit-identical to its float32 formula
    before bf16 was added.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.models.interop import flax_to_state_dict, load_flax_params
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.nn import classifier, layers, mamba
from idee_tpu_torch.quant.lfq import LFQ

torch.set_num_threads(1)

BF16 = torch.bfloat16
MODULE_REL = 2e-2
LOGIT_REL = 5e-2
BITS_AGREE = 0.99
VARS = ["var_01", "var_02", "var_03"]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.kernels import runtime
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.models.vq_model import build_quantizer as jax_quantizer
    from idee_tpu.nn import classifier as jcls
    from idee_tpu.nn import layers as jl
    from idee_tpu.nn import mamba as jm

    return SimpleNamespace(
        jax=jax, jnp=jnp, bf16=jnp.bfloat16, runtime=runtime, jl=jl, jm=jm,
        jcls=jcls,
        build_model=jax_build_model, build_quantizer=jax_quantizer,
        cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _bf16_input(shape, seed=0, offset=0.0):
    """(torch bf16 tensor, the same values as float32 numpy)."""
    x = np.random.default_rng(seed).normal(size=shape) + offset
    t = torch.from_numpy(x.astype(np.float32)).to(BF16)
    return t, t.float().numpy()


def _flax(jx, module, x, seed=0, std=0.1):
    shapes = jx.jax.eval_shape(
        lambda a: module.init(jx.jax.random.PRNGKey(0), a), x)
    rng = np.random.default_rng(seed + 100)
    return jx.jax.tree_util.tree_map(
        lambda s: (0.02 + std * rng.normal(size=s.shape)).astype(np.float32),
        shapes.get("params", {}))


def _apply(jx, module, params, x):
    return np.asarray(jx.jax.jit(lambda p, a: module.apply(
        {"params": p}, a))(params, x))


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params,
                                               module.state_dict()),
                          strict=True)
    return module.eval()


def _close_scaled(got, want, rel, what):
    """max |got - want| <= rel x max |want|; returns that max error over
    max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"{what}: max error {err} x max |ref| > {rel}"
    return err


def _run(jx, jmod, port_mod, shape, seed=0, offset=0.0):
    x, xn = _bf16_input(shape, seed, offset)
    jxb = jx.jnp.asarray(xn).astype(jx.bf16)
    params = _flax(jx, jmod, jxb, seed=seed)
    want = _apply(jx, jmod, params, jxb)
    assert want.dtype == jx.bf16
    with torch.no_grad():
        got = _port(port_mod, params)(x)
    assert got.dtype == BF16
    return got, want.astype(np.float32)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_grouped_layernorm3d_bf16_matches_jax(jx, affine):
    """A mean offset of 3: the mean rounded to bf16 before d = x - mu is
    where JAX's bf16 LayerNorm loses precision."""
    V, C = 3, 8
    got, want = _run(jx, jx.jl.GroupedLayerNorm3d(V, C, affine=affine,
                                                  dtype=jx.bf16),
                     layers.GroupedLayerNorm3d(V, C, affine=affine,
                                               dtype=BF16),
                     (2, 4, 5, 5, V * C), seed=1, offset=3.0)
    _close_scaled(got, want, MODULE_REL, "layernorm")


def test_grouped_layernorm3d_float32_is_bit_identical():
    """At float32 every cast is the identity: the float32 formula before
    bf16 was added, bit for bit."""
    V, C, eps = 3, 16, 1e-5
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 4, 6, 6, V * C)).astype(np.float32) * 3 + 1)
    ln = layers.GroupedLayerNorm3d(V, C, affine=True)
    with torch.no_grad():
        ln.scale.normal_(generator=torch.Generator().manual_seed(0))
        ln.bias.normal_(generator=torch.Generator().manual_seed(1))
        xv = x.reshape(2, 4, 6, 6, V, C)
        mu = xv.mean(-1, keepdim=True)
        d = xv - mu
        var = (d * d).mean(-1, keepdim=True)
        want = (d * torch.rsqrt(var + eps) * ln.scale + ln.bias).reshape(
            x.shape)
        got = ln(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("use_bias", [False, True])
def test_grouped_dense_bf16_matches_jax(jx, use_bias):
    V, fin, fout = 3, 8, 12
    got, want = _run(jx, jx.jl.GroupedDense(V, fin, fout, use_bias=use_bias,
                                            dtype=jx.bf16),
                     layers.GroupedDense(V, fin, fout, use_bias=use_bias,
                                         dtype=BF16),
                     (2, 5, V * fin), seed=3)
    _close_scaled(got, want, MODULE_REL, "dense")


CONV = dict(in_features=4, features=5, kernel_size=(3, 3, 3),
            padding_mode="replicate")


@pytest.mark.parametrize("use_bias", [False, True])
def test_grouped_conv3d_bf16_matches_jax(jx, use_bias):
    V = 3
    got, want = _run(jx, jx.jl.GroupedConv3d(n_groups=V, use_bias=use_bias,
                                             dtype=jx.bf16, **CONV),
                     layers.GroupedConv3d(V, use_bias=use_bias, dtype=BF16,
                                          **CONV),
                     (2, 4, 6, 6, V * 4), seed=4)
    _close_scaled(got, want, MODULE_REL, "grouped conv")


def test_classifier_bf16_matches_jax(jx):
    """The joint head's plain convs (flax nn.Conv with dtype=bf16) and the
    grouped per-variable heads, on packed bf16 codes."""
    V, C = 3, 8
    x, xn = _bf16_input((2, 8, 6, 6, V * C), seed=5)
    jxb = jx.jnp.asarray(xn).astype(jx.bf16)
    jmod = jx.jcls.CNN_3D_Classifier(in_var=V, embed_dim=C, dim=8,
                                     dtype=jx.bf16)
    shapes = jx.jax.eval_shape(lambda a: jmod.init(
        jx.jax.random.PRNGKey(0), a, packed=True), jxb)
    rng = np.random.default_rng(105)
    params = jx.jax.tree_util.tree_map(
        lambda s: (0.02 + 0.1 * rng.normal(size=s.shape)).astype(
            np.float32), shapes["params"])
    want = jx.jax.jit(lambda p, a: jmod.apply({"params": p}, a,
                                              packed=True))(params, jxb)
    with torch.no_grad():
        got = _port(classifier.CNN_3D_Classifier(in_var=V, embed_dim=C,
                                                 dim=8, dtype=BF16),
                    params)(x, packed=True)
    for name, a, b in zip(("z", "y"), got, want):
        assert a.dtype == BF16 and b.dtype == jx.bf16, name
        _close_scaled(a, np.asarray(b).astype(np.float32), MODULE_REL, name)


# ---------------------------------------------------------------- Mamba

@pytest.mark.parametrize("d_state", [1, 2])
def test_packed_mamba_ssm_bf16_matches_jax_and_scans_in_float32(
        jx, monkeypatch, d_state):
    V, d = 3, 8
    seen = []

    def spy(fn):
        def call(*args, **kw):
            seen.append({a.dtype for a in args
                         if isinstance(a, torch.Tensor)})
            return fn(*args, **kw)
        return call

    for name in ("fused_selective_scan_n1", "linear_scan"):
        monkeypatch.setattr(mamba, name, spy(getattr(mamba, name)))
    got, want = _run(jx, jx.jm.PackedMambaSSM(n_groups=V, d_model=d,
                                              d_state=d_state,
                                              dtype=jx.bf16),
                     mamba.PackedMambaSSM(V, d, d_state=d_state, dtype=BF16),
                     (6, 32, V * d), seed=6)
    _close_scaled(got, want, MODULE_REL, "mamba ssm")
    assert len(seen) == 1 and seen[0] == {torch.float32}, seen


# ---------------------------------------------------------------- LFQ

def test_lfq_takes_bf16_and_works_in_float32():
    """The 1-bit quantizer's packed and generic forms give on bf16 input
    exactly what they give on the same values upcast: a float32 island."""
    lfq = LFQ(dim=8, codebook_size=2,
              generator=torch.Generator().manual_seed(0))
    zp, _ = _bf16_input((2, 4, 5, 5, 3 * 8), seed=7)
    a = lfq.quantize_packed(zp, 3, train=True)
    b = lfq.quantize_packed(zp.float(), 3, train=True)
    assert a.s_q.dtype == torch.float32
    assert torch.equal(a.s_q, b.s_q) and torch.equal(a.indices, b.indices)
    assert torch.equal(a.aux_loss, b.aux_loss)
    tok = zp.reshape(2, -1, 8)
    x, y = lfq(tok, train=True), lfq(tok.float(), train=True)
    assert x.quantized.dtype == torch.float32
    for u, v in zip(x, y):
        assert torch.equal(u, v)


# ---------------------------------------------------------------- VQModel

def _tiny(**kw):
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, dtype="bfloat16", name="bf16")
    base.update(kw)
    return synthetic_config(**base)


def _jax_variables(jx, cfg):
    """The JAX model of ``cfg`` and its variables: parameters N(0, 0.1)
    from a numpy seed; a "codebook" collection, where the quantizer has
    one, as the JAX quantizer initialises it."""
    jax, jnp = jx.jax, jx.jnp
    model = jx.build_model(jx.cfg(cfg))
    shapes = jax.eval_shape(lambda a: model.init(
        jax.random.PRNGKey(1), a, train=False),
        jnp.zeros((1, 3, 1, 8, 16, 16), jnp.float32))
    rng = np.random.default_rng(11)
    out = {"params": jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])}
    quant = jx.build_quantizer(jx.cfg(cfg)).init(
        {"params": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, cfg.codebook_dim)), train=False)
    if "codebook" in quant:
        out["codebook"] = {"vq": jax.tree_util.tree_map(
            np.asarray, quant["codebook"])}
    return model, out


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32),
            (rng.random((2, 16, 16)) < 0.2).astype(np.float32))


def _clean(flipped, radius=3):
    """Pixels [..., H, W] whose (2 radius + 1)^2 neighbourhood holds no
    flipped code: the classifier's three 3x3 convs see that far."""
    t = torch.from_numpy(flipped.astype(np.float32))
    lead = t.shape[:-2]
    t = t.reshape(-1, 1, *t.shape[-2:])
    hit = torch.nn.functional.max_pool2d(t, 2 * radius + 1, 1, radius)
    return hit.reshape(*lead, *t.shape[-2:]).numpy() == 0


def _compare_forward(jx, cfg, train=False):
    """The VQModel forward at bf16 against JAX's. Asserted: anomaly bits
    >= 99 % equal; z and y within LOGIT_REL x max |logit| on the pixels
    whose receptive field holds no flipped code (z: any variable's, y: its
    own variable's); the port's classifier fed JAX's codes within
    LOGIT_REL x max everywhere; loss_anomaly likewise. Returns the share of
    equal bits."""
    model_j, variables = _jax_variables(jx, cfg)
    x, m = _batch()
    mutable = [k for k in variables if k != "params"] if train else False

    def apply(v, a, b):
        return model_j.apply(v, a, train=train, mask_extreme_loss=b,
                             mutable=mutable)

    jx.runtime.set_force_pallas(True)
    try:
        want = jx.jax.jit(apply)(variables, jx.jnp.asarray(x),
                                 jx.jnp.asarray(m))
    finally:
        jx.runtime.set_force_pallas(False)
    if train:
        want = want[0]
    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, variables))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.inference_mode():
        got = model(torch.from_numpy(x), train=train,
                    mask_extreme_loss=torch.from_numpy(m))
        same_codes = model.cls(torch.from_numpy(np.asarray(want.z_q)).to(
            BF16))
    for k in ("z", "y", "z_q", "loss_anomaly"):
        assert getattr(got, k).dtype == torch.float32, k
    flipped = got.anomaly.numpy() != np.asarray(want.anomaly)  # N,V,T,H,W
    bits = 1.0 - flipped.mean()
    clean_z = _clean(flipped.any(axis=(1, 2)))[:, None]      # [N, 1, H, W]
    clean_y = _clean(flipped.any(axis=2))[:, :, None]       # [N, V, 1, H, W]
    wz, wy = np.asarray(want.z), np.asarray(want.y)
    err_z = np.abs(got.z.numpy() - wz) / np.abs(wz).max()
    err_y = np.abs(got.y.numpy() - wy) / np.abs(wy).max()
    print(f"{cfg.encoder} {cfg.codebook}: anomaly bits equal {bits:.5f}; "
          f"logit error over max |logit| {err_z.max():.3g} in all, "
          f"{err_z[clean_z].max():.3g} on the {clean_z.mean():.3f} of "
          "pixels without a flipped code in view")
    assert bits >= BITS_AGREE, bits
    assert clean_z.any() and clean_y.any()
    assert err_z[clean_z].max() <= LOGIT_REL
    assert err_y[clean_y].max() <= LOGIT_REL
    _close_scaled(same_codes[0], wz, LOGIT_REL, "z on JAX's codes")
    _close_scaled(same_codes[1], wy, LOGIT_REL, "y on JAX's codes")
    _close_scaled(got.loss_anomaly, want.loss_anomaly, LOGIT_REL,
                  "loss_anomaly")
    assert 0 < got.anomaly.float().mean() < 1
    return bits


@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D", "CNN_3D"])
def test_vq_model_forward_bf16_matches_jax(jx, encoder):
    _compare_forward(jx, _tiny(encoder=encoder))


def test_generic_path_vq_ema_forward_bf16_matches_jax(jx):
    """The generic path follows JAX with the same casts: bf16 tokens into
    the float32 VQ, z_q float32, cast to bf16 at the classifier. The
    training forward (EMA update of the codebook) as well as the eval
    one."""
    cfg = _tiny(codebook="VQ", vq_ema_update=True)
    _compare_forward(jx, cfg, train=False)
    _compare_forward(jx, cfg, train=True)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_grouped_layernorm3d_float32_is_bit_identical_on_card(cuda):
    """cuda's float32 reductions with dtype=float32 are the ones without
    it: the float32 formula before bf16 was added, bit for bit."""
    V, C, eps = 6, 16, 1e-5
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 8, 50, 50, V * C)).astype(np.float32) * 3 + 1).to(cuda)
    ln = layers.GroupedLayerNorm3d(V, C, affine=False).to(cuda)
    with torch.no_grad():
        xv = x.reshape(1, 8, 50, 50, V, C)
        mu = xv.mean(-1, keepdim=True)
        d = xv - mu
        var = (d * d).mean(-1, keepdim=True)
        want = (d * torch.rsqrt(var + eps)).reshape(x.shape)
        assert torch.equal(ln(x), want)
