# ------------------------------------------------------------------
"""The generic VQModel path (every codebook but the 1-bit LFQ) against the
JAX package: the forward of each codebook at eval and in training (its aux
loss and the updated "codebook" collection), the interop of that
collection, and the codebook state through checkpoint, restore and resume.
The train steps are in test_torch_codebook_train.py, which shares this
file's helpers.

Tiny config: 3 variables, 16x16, delta_t=8, the Mamba encoder
(en_embed_dim=[8, 8], en_depths=[2, 1]), codebook_dim=8, codebook_size 2
(4 for LFQ), batch 2. Parameters N(0, 0.1) from a numpy seed, but for
LatentQuantize's level values and the "codebook" collection, which are
the JAX quantizer's own initial ones; carried across by
``load_flax_params`` with the collection. Tolerances, float32: logits,
z_q and losses rtol 1e-4 / atol 1e-4 (~15 layers whose sums run in
another order); code indices >= 99.9 % equal; the updated collection
rtol 1e-4 / atol 1e-5 (sums of ~12,000 encoder outputs per code).
The JAX side is imported inside fixtures.
"""
# ------------------------------------------------------------------

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import Config, synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_npz, load_flax_params,
                                           save_flax_npz)
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.quant.vq import VQ
from idee_tpu_torch.train.checkpoint import CheckpointManager
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
T_LINE = 20
EMA = dict(codebook="VQ", vq_ema_update=True)
CODEBOOKS = {
    "VQ": dict(codebook="VQ"),
    "VQ_EMA": EMA,
    "VQ_EMA_kmeans": dict(EMA, vq_kmeans_init=True,
                          vq_threshold_ema_dead_code=2.0),
    "FSQ": dict(codebook="FSQ"),
    "LatentQuantize": dict(codebook="LatentQuantize"),
    "Random_VQ": dict(codebook="Random_VQ"),
    "LFQ_4": dict(codebook="LFQ", codebook_size=4),
}


def _tiny_config(**kw) -> Config:
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=10,
                lr_warmup_epochs=0, name="codebook")
    base.update(kw)
    return synthetic_config(**base)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.kernels import runtime
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.models.vq_model import build_quantizer as jax_quantizer
    from idee_tpu.train import state as jstate
    from idee_tpu.train import steps as jsteps
    from idee_tpu.train import steps_real as jsteps_real

    return SimpleNamespace(
        jax=jax, jnp=jnp, runtime=runtime, state=jstate, steps=jsteps,
        steps_real=jsteps_real, build_model=jax_build_model,
        build_quantizer=jax_quantizer,
        cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _jax_variables(jx, cfg, in_channels=1, seed=11):
    """The JAX model of ``cfg`` and its variables: the parameters N(0, 0.1)
    from a numpy seed, but for LatentQuantize's level values and the
    "codebook" collection, which are the JAX quantizer's own initial ones
    (PRNGKey(1)). The model's shapes come from eval_shape: nothing
    compiles."""
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.cfg(cfg)
    model = jx.build_model(jcfg)
    x = jnp.zeros((1, 3, in_channels, 8, 16, 16), jnp.float32)
    shapes = jax.eval_shape(lambda a: model.init(
        {"params": jax.random.PRNGKey(1)}, a, train=False), x)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])
    quant = jax.tree_util.tree_map(np.asarray, jx.build_quantizer(
        jcfg).init({"params": jax.random.PRNGKey(1)},
                   jnp.zeros((1, 4, cfg.codebook_dim)), train=False))
    for k, v in quant.get("params", {}).items():
        if k.startswith("values"):
            params["vq"][k] = v
    out = {"params": params}
    if "codebook" in quant:
        out["codebook"] = {"vq": quant["codebook"]}
    return model, out


def _port_model(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, variables))
    return model


def _buffers(model):
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in model.state_dict().items() if k not in names}


def _close(got, want, what, rtol=1e-4, atol=1e-4):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _batches(n, seed, in_channels=1):
    rng = np.random.default_rng(seed)
    return [{
        "x": rng.normal(size=(2, 3, in_channels, 8, 16, 16)).astype(
            np.float32),
        "mask_extreme": (rng.random((2, 16, 16)) < 0.1).astype(np.float32),
        "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.2).astype(
            np.float32),
        "timestep": np.array([[8.0 + 2 * i], [9.0 + 2 * i]], np.float32),
    } for i in range(n)]


@pytest.fixture
def pallas(jx):
    jx.runtime.set_force_pallas(True)
    yield
    jx.runtime.set_force_pallas(False)


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("name", sorted(CODEBOOKS))
def test_generic_forward_matches_jax(jx, name):
    """Eval forward of every codebook; for the codebooks without random
    draws also a training forward, its aux loss and (VQ-EMA) the updated
    collection. With k-means pending, the eval forward gives code 0
    everywhere in both. The JAX Mamba runs its XLA scan here; the train
    steps run its Pallas kernels in interpret mode."""
    cfg = _tiny_config(**CODEBOOKS[name])
    model_j, variables = _jax_variables(jx, cfg)
    model = _port_model(cfg, variables)
    assert not model._scalar_lfq()
    b = _batches(1, seed=1)[0]
    x, m = jx.jnp.asarray(b["x"]), jx.jnp.asarray(b["mask_extreme_loss"])
    tx, tm = torch.from_numpy(b["x"]), torch.from_numpy(b["mask_extreme_loss"])

    def compare(got, want, what):
        for k in ("z", "y", "z_q", "vq0", "loss_z_q", "loss_anomaly"):
            _close(getattr(got, k), getattr(want, k), f"{what} {k}")
        a, wa = got.anomaly.numpy(), np.asarray(want.anomaly)
        assert a.shape == (2, 3, 8, 16, 16) and a.dtype == np.int32
        assert (a == wa).mean() >= 0.999, what

    cb = {k: v for k, v in variables.items() if k != "params"}
    draws = "kmeans" in name  # the training forward's draws differ

    def both(v, x, m):
        ev = model_j.apply(v, x, train=False, mask_extreme_loss=m)
        if draws:
            return ev, None
        return ev, model_j.apply(
            v, x, train=True, mask_extreme_loss=m, mutable=list(cb),
            rngs={"codebook": jx.jax.random.PRNGKey(0)})

    want, trained = jx.jax.jit(both)(variables, x, m)
    with torch.inference_mode():
        got = model(tx, mask_extreme_loss=tm)
    compare(got, want, "eval")
    if draws:  # with k-means pending, code 0 everywhere in both
        assert got.anomaly.abs().sum() == 0
        return
    if name.startswith(("VQ", "LFQ")):  # both codes occur (FSQ and
        # LatentQuantize at 2 levels, and Random_VQ here, give one code)
        assert len(np.unique(got.anomaly.numpy())) > 1

    want, upd = trained
    got = model(tx, train=True, mask_extreme_loss=tm)
    compare(got, want, "train")
    for k, w in flax_to_state_dict({"params": {}, **upd},
                                   model.state_dict()).items():
        _close(model.state_dict()[k], w, f"updated {k}", atol=1e-5)


# ---------------------------------------------------------------- interop

def test_jax_vq_ema_variables_load_strictly(jx, tmp_path):
    cfg = _tiny_config(**CODEBOOKS["VQ_EMA_kmeans"])
    _, variables = _jax_variables(jx, cfg)
    sd = load_flax_params(cfg, variables)
    model = build_model(cfg)
    model.load_state_dict(sd)
    for k in ("embed", "cluster_size", "embed_avg", "initted"):
        np.testing.assert_array_equal(getattr(model.vq, k).numpy(),
                                      variables["codebook"]["vq"][k])
    assert not model.vq._initted
    with pytest.raises(ValueError, match="vq.cluster_size"):
        load_flax_params(cfg, {"params": variables["params"]})
    # a .npz keeps the collection; bare params keep their old layout
    save_flax_npz(str(tmp_path / "v.npz"), variables)
    back = load_flax_npz(str(tmp_path / "v.npz"))
    assert set(back) == {"params", "codebook"}
    for k, v in load_flax_params(cfg, back).items():
        assert torch.equal(v, sd[k]), k
    save_flax_npz(str(tmp_path / "p.npz"), {"params": variables["params"]})
    assert "params" not in load_flax_npz(str(tmp_path / "p.npz"))
    rvq = _tiny_config(**CODEBOOKS["Random_VQ"])
    _, variables = _jax_variables(jx, rvq)
    assert {"vq.rand_projs", "vq.vq.embed"} <= set(
        load_flax_params(rvq, variables))


# ---------------------------------------------------------------- checkpoints

def test_codebook_state_survives_checkpoint_and_resume(tmp_path,
                                                       monkeypatch):
    """VQ-EMA with k-means init and expiry through train_synthetic: the
    init runs once, in the first step of the run; the checkpoint holds the
    buffers; a restore gives them back (initted included, and the host
    flag with it); the resumed epoch never re-initialises."""
    calls = []
    kmeans = VQ.kmeans
    monkeypatch.setattr(VQ, "kmeans",
                        lambda self, *a: calls.append(1) or kmeans(self, *a))
    cube = make_fake_cube(n_vars=3, n_time=24, height=16, width=16, seed=3)
    cfg = _tiny_config(**CODEBOOKS["VQ_EMA_kmeans"], times_train=(1, 14),
                       times_val=(15, 24), n_epochs=1, dir_log=str(tmp_path))
    kw = dict(train_cube=cube.time_slice(1, 14),
              val_cube=cube.time_slice(15, 24), device="cpu")
    first = train_synthetic(cfg, **kw)
    model = first["state"].model
    assert calls == [1] and model.vq.initted.item() == 1.0
    assert (model.vq.cluster_size > 0).all()
    assert all(math.isfinite(v) for v in first["train_loss"])
    saved = torch.load(tmp_path / "codebook" / "model_checkpoints" /
                       "latest.pt", weights_only=True)["model"]
    for k, v in _buffers(model).items():
        assert torch.equal(saved[k], v), k

    fresh = build_model(cfg)
    assert not fresh.vq._initted
    state = create_train_state(cfg, fresh, "cpu")
    CheckpointManager(cfg.log_dir).restore("latest", state)
    assert fresh.vq._initted
    for k, v in _buffers(model).items():
        assert torch.equal(_buffers(fresh)[k], v), k

    more = train_synthetic(cfg.replace(n_epochs=2), **kw)
    assert calls == [1]
    assert more["train_loss"][:1] == first["train_loss"]
    assert more["state"].model.vq.initted.item() == 1.0
    assert more["state"].step == 2 * first["state"].step
