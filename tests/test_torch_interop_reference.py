# ------------------------------------------------------------------
"""The reference's PyTorch checkpoints in and out of the port
(models/interop.py's reference map, cli/import_reference_checkpoint.py,
cli/export_reference_checkpoint.py) against the JAX package's
idee_tpu/models/interop.py.

CPU, float32, at a small size (3 variables, 16x16, widths 8, depths
[2, 1]), for Mamba (d_state 1 and 2), Swin_3D and CNN_3D with the LFQ
codebook and the CNN_3D classifier:
  * a reference-layout state_dict made by JAX's ``export_torch_state_dict``
    imports into the port, and the port's forward matches JAX's on the
    same batch (logits within 1e-4, anomaly bits equal where the LFQ
    latent |s| > 1e-4: the port-against-JAX forward tolerance of
    tests/test_torch_slice.py);
  * the port's ``export_torch_state_dict`` equals JAX's key for key, in
    the same order, bit for bit; also for Swin_3D at delta_t 4, whose
    stage-1 bias table is the shrunk (4, 1, 1) window's while both write
    ``relative_position_index`` from cfg.en_window_size (the composite
    model runs at delta_t 8 only, so that tree's encoder comes from the
    encoder's own init and no forward is compared);
  * a ``.pth`` crosses both ways: JAX's ``export_checkpoint_file`` through
    the port's import CLI into ``test_synthetic --en_de_pretrained``, and
    the port's export CLI (from a run directory) through JAX's
    ``import_checkpoint_file`` back to the original flax tree;
  * a missing key, an extra key, the ``module.`` prefix, a pickle that is
    not weights-only and an unmapped codebook behave as in JAX.
"""
# ------------------------------------------------------------------

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.cli.export_reference_checkpoint import main as export_cli
from idee_tpu_torch.cli.import_reference_checkpoint import main as import_cli
from idee_tpu_torch.config import save_options, synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.models import interop
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.train.evaluate import test_synthetic as port_test

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
N_TIME = 16
CASES = {"Mamba": {"encoder": "Mamba"},
         "Mamba_dstate2": {"encoder": "Mamba", "d_state": [2, 2]},
         "Swin_3D": {"encoder": "Swin_3D"},
         "CNN_3D": {"encoder": "CNN_3D"},
         # stage 1's (8, 1, 1) window shrunk to (4, 1, 1): a smaller bias
         # table, relative_position_index still from cfg.en_window_size
         "Swin_3D_dt4": {"encoder": "Swin_3D", "delta_t": 4}}
FORWARD_CASES = [c for c in CASES if c != "Swin_3D_dt4"]


def _config(case="Mamba", **kw):
    base = dict(in_channels_dynamic=3, variables=VARS, x_max=16, y_max=16,
                en_embed_dim=[8, 8], en_depths=[2, 1], codebook_dim=8,
                cls_dim=8, times_test=(1, N_TIME), name="interop")
    base.update(CASES[case])
    base.update(kw)
    return synthetic_config(**base)


def _flags(cfg):
    """The CLI flags of ``cfg``'s model configuration."""
    out = ["--variables", str(VARS)]
    for k in ("encoder", "in_channels", "in_channels_dynamic", "en_embed_dim",
              "en_depths", "codebook_dim", "cls_dim", "d_state"):
        out += [f"--{k}", str(getattr(cfg, k))]
    return out


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.models import interop as jint
    from idee_tpu.models.vq_model import build_model as jax_build_model

    def params(cfg, seed=11):
        """The JAX model of ``cfg`` and its parameter tree, the flax
        shapes filled with N(0, 0.1) from a numpy seed (a plain dict)."""
        jcfg = JConfig.from_dict(cfg.to_dict())
        model = jax_build_model(jcfg)
        shapes = jax.eval_shape(
            lambda a: model.init(jax.random.PRNGKey(0), a, train=False),
            jnp.zeros((1, 3, 1, 8, 16, 16), jnp.float32))
        if cfg.delta_t != 8:
            # the composite model runs at delta_t 8 only (its classifier
            # collapses T = 8 to 1): the encoder's shapes from its own
            # init at delta_t, as a JAX checkpoint of that encoder holds
            from idee_tpu.models.vq_model import build_encoder

            enc = build_encoder(jcfg, None, None)
            shapes = dict(shapes, params=dict(
                shapes["params"], encoder=jax.eval_shape(
                    lambda a: enc.init(jax.random.PRNGKey(0), a),
                    jnp.zeros((1, 3, 1, cfg.delta_t, 16, 16),
                              jnp.float32))["params"]))
        rng = np.random.default_rng(seed)
        tree = jax.tree_util.tree_map(
            lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
            shapes["params"])
        return jcfg, model, jax.tree_util.tree_map(np.asarray, dict(tree))

    return SimpleNamespace(jax=jax, jnp=jnp, int=jint, params=params)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_jax_export_imports_and_the_forward_matches_jax(jx, case):
    cfg = _config(case)
    jcfg, jmodel, params = jx.params(cfg)
    ref = jx.int.export_torch_state_dict(jcfg, params)
    sd = interop.import_torch_state_dict(cfg, ref)
    # the same weights as the flax tree's direct carry
    want_sd = interop.load_flax_params(cfg, params)
    assert list(sd) == list(build_model(cfg).state_dict())
    for k in want_sd:
        assert torch.equal(sd[k], want_sd[k]), k

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32)
    want = jx.jax.jit(lambda p, a: jmodel.apply({"params": p}, a,
                                                train=False))(
        params, jx.jnp.asarray(x))
    model = build_model(cfg)
    model.load_state_dict(sd)
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        zp = model.encoder(torch.from_numpy(x), packed_out=True)
        k_in, b_in = model.vq.in_proj_params()
        s = (zp.reshape(*zp.shape[:-1], 3, 8) @ k_in + b_in).numpy()
    for name in ("z", "y", "z_q"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    bits, wbits = got.anomaly.numpy(), np.asarray(want.anomaly)
    clear = np.abs(s).transpose(0, 4, 1, 2, 3) > 1e-4
    np.testing.assert_array_equal(bits[clear], wbits[clear])
    assert int((bits[~clear] != wbits[~clear]).sum()) <= max(
        1, bits.size // 1000)


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_jax_key_for_key_bit_for_bit(jx, case):
    cfg = _config(case)
    jcfg, _, params = jx.params(cfg, seed=5)
    want = jx.int.export_torch_state_dict(jcfg, params)
    model = build_model(cfg)
    model.load_state_dict(interop.load_flax_params(cfg, params))
    for src in (model, model.state_dict()):
        got = interop.export_torch_state_dict(cfg, src)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the map's view of the port model is the JAX tree's layout
    view = interop.state_dict_to_flax(model.state_dict())
    assert sorted(interop.flatten_flax(view)) == sorted(
        interop.flatten_flax(params))


@pytest.mark.parametrize("case", ["Mamba", "Swin_3D"])
def test_jax_pth_through_the_import_cli_into_test_synthetic(jx, case,
                                                            tmp_path):
    cfg = _config(case, dir_log=str(tmp_path / "log"))
    jcfg, _, params = jx.params(cfg, seed=3)
    pth = tmp_path / "reference.pth"
    jx.int.export_checkpoint_file(jcfg, params, str(pth), epoch=4)
    out = tmp_path / "imported.pt"
    result = import_cli(["--checkpoint", str(pth), "--out", str(out),
                         "--device", "cpu"] + _flags(cfg))
    assert result["parameters"] == sum(
        v.size for v in interop.flatten_flax(params).values())
    cube = make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=4)
    got = port_test(cfg.replace(en_de_pretrained=str(out)), cube=cube,
                    device="cpu")
    want = port_test(cfg, cube=cube, params=params, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:  # the same weights and batches: equal, NaN included
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", ["Mamba_dstate2", "CNN_3D"])
def test_port_pth_through_jax_import_gives_the_tree_back(jx, case,
                                                         tmp_path):
    cfg = _config(case, dir_log=str(tmp_path), name="run")
    jcfg, _, params = jx.params(cfg, seed=7)
    save_options(cfg)
    ckpt = tmp_path / "run" / "model_checkpoints"
    ckpt.mkdir(parents=True)
    torch.save({"model": interop.load_flax_params(cfg, params),
                "meta": {"epoch": 3, "mean_loss_train": 0.5,
                         "mean_loss_validation": 0.25}},
               ckpt / "best_F1_model.pt")
    pth = tmp_path / "export.pth"
    result = export_cli(["--run_dir", str(tmp_path / "run"), "--out",
                         str(pth), "--device", "cpu"])
    assert result["epoch"] == 3
    payload = torch.load(pth, weights_only=True)
    assert payload["epoch"] == 3 and payload["mean_loss_validation"] == 0.25
    back = jx.int.import_checkpoint_file(jcfg, str(pth))
    want = interop.flatten_flax(params)
    got = interop.flatten_flax(_plain(back))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _faults(sd):
    """The state_dict variants of the error cases."""
    first = next(iter(sd))
    missing = dict(sd)
    del missing[first]
    extra = dict(sd, **{"encoder.unknown.weight": np.zeros(2, np.float32)})
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    return {"missing": missing, "extra": extra, "prefixed": prefixed}


@pytest.mark.parametrize("fault", ["missing", "extra", "prefixed"])
def test_faulty_state_dicts_behave_as_in_jax(jx, fault):
    cfg = _config("Swin_3D")
    jcfg, _, params = jx.params(cfg)
    sd = _faults(jx.int.export_torch_state_dict(jcfg, params))[fault]
    if fault == "prefixed":
        got = interop.import_torch_state_dict(cfg, sd)
        want = interop.load_flax_params(
            cfg, jx.int.import_torch_state_dict(jcfg, sd))
        for k in want:
            assert torch.equal(got[k], want[k]), k
        return
    errors = []
    for fn, c in ((jx.int.import_torch_state_dict, jcfg),
                  (interop.import_torch_state_dict, cfg)):
        with pytest.raises((KeyError, ValueError)) as info:
            fn(c, sd)
        errors.append(info)
    assert errors[0].type is errors[1].type
    assert str(errors[0].value) == str(errors[1].value)


class _Opaque:
    """An object a weights-only load refuses."""

    def __init__(self, value):
        self.value = value


def test_non_weights_only_pickle_needs_allow_pickle_as_in_jax(jx, tmp_path):
    cfg = _config("CNN_3D")
    jcfg, _, params = jx.params(cfg)
    sd = {k: torch.from_numpy(v) for k, v in
          jx.int.export_torch_state_dict(jcfg, params).items()}
    path = tmp_path / "pickled.pth"
    torch.save({"model_state_dict": sd, "extra": _Opaque(1)}, path)
    for fn, c in ((jx.int.import_checkpoint_file, jcfg),
                  (interop.import_checkpoint_file, cfg)):
        with pytest.raises(RuntimeError, match="allow_pickle=True"):
            fn(c, str(path))
    got = interop.import_checkpoint_file(cfg, str(path), allow_pickle=True)
    want = interop.load_flax_params(cfg, params)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    out = tmp_path / "imported.pt"
    with pytest.raises(RuntimeError, match="allow_pickle=True"):
        import_cli(["--checkpoint", str(path), "--out", str(out),
                    "--device", "cpu"] + _flags(cfg))
    import_cli(["--checkpoint", str(path), "--out", str(out), "--device",
                "cpu", "--allow_pickle"] + _flags(cfg))
    assert os.path.exists(out)


def test_unmapped_codebook_raises_as_in_jax(jx):
    cfg = _config("CNN_3D", codebook="VQ", codebook_size=4)
    with pytest.raises(ValueError, match="unmapped vq module"):
        interop.export_torch_state_dict(cfg, build_model(cfg))
    jcfg, _, params = jx.params(cfg)
    with pytest.raises(ValueError, match="unmapped vq module"):
        jx.int.export_torch_state_dict(jcfg, params)
    sd = {k: v.numpy() for k, v in build_model(_config("CNN_3D"))
          .state_dict().items()}
    with pytest.raises(ValueError, match="unmapped vq module"):
        interop.import_torch_state_dict(cfg, sd)
    assert json.dumps(interop.IGNORED_TORCH_SUFFIXES) == json.dumps(
        jx.int.IGNORED_TORCH_SUFFIXES)
