# ------------------------------------------------------------------
"""The port's real-world drivers against the JAX package's, for Mamba,
Swin_3D and CNN_3D at in_channels=2: train_real for 2 epochs (and, for
Mamba, a resumed third), test_real and predict_real. The tree, the tiny
config and the weights are those of test_torch_real_train.py; both
drivers start from the same N(0, 0.1) weights, the JAX one from an orbax
checkpoint, the port from a flax-path .npz. Tolerances: losses rtol 1e-4,
drought F1 / IoU within 1e-6, predict_real's probabilities within 1e-5,
its masks and name codes equal, its anomaly bits equal but for at most one
in a thousand (flips where the LFQ latent is within float noise of 0).
"""
# ------------------------------------------------------------------

import json
import os
import sys

import numpy as np
import pytest
import torch

from idee_tpu_torch.models.interop import save_flax_npz
from idee_tpu_torch.train.driver_real import test_real as port_test_real
from idee_tpu_torch.train.driver_real import train_real
from test_torch_real_train import (ENCODERS, REPO, _cfg, _close,  # noqa: F401
                                   _random_params, jx, tree)

torch.set_num_threads(1)


# ---------------------------------------------------------------- drivers

def _jax_init(jx, cfg, tmp):
    """Random flax params, saved as an orbax checkpoint (the JAX drivers'
    en_de_pretrained) and as a flax-path .npz (the port's)."""
    import orbax.checkpoint as ocp

    _, params = _random_params(jx, cfg)
    ocp.StandardCheckpointer().save(str(tmp / "init_orbax"), params)
    save_flax_npz(str(tmp / "init.npz"), params)
    return params


@pytest.mark.parametrize("encoder", ENCODERS)
def test_train_real_matches_jax_and_resumes(jx, tree, tmp_path, encoder):
    cfg = _cfg(tree, tmp_path / "port", encoder=encoder)
    _jax_init(jx, cfg, tmp_path)
    want = jx.driver.train_real(jx.cfg(cfg.replace(
        dir_log=str(tmp_path / "jax"),
        en_de_pretrained=str(tmp_path / "init_orbax"))), "CERRA")

    cfg = cfg.replace(en_de_pretrained=str(tmp_path / "init.npz"))
    got = train_real(cfg, "CERRA", device="cpu")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    _close(got["train_f1"], want["train_f1"], 1e-6, "train_f1")
    _close(got["val_f1"], want["val_f1"], 1e-6, "val_f1")
    names = sorted(p.stem for p in (tmp_path / "port" / "real" /
                                    "model_checkpoints").iterdir())
    assert names == sorted(os.listdir(tmp_path / "jax" / "real" /
                                      "model_checkpoints"))
    with open(tmp_path / "port" / "real" / "history.json") as fh:
        assert json.load(fh)["train_loss"] == got["train_loss"]
    if encoder != "Mamba":
        return
    # a third epoch resumes from latest: epochs 1-2 are kept, not rerun
    more = train_real(cfg.replace(n_epochs=3), "CERRA", device="cpu")
    assert more["train_loss"][:2] == got["train_loss"]
    assert len(more["train_loss"]) == 3 and more["state"].step == 3 * 4


@pytest.mark.parametrize("encoder", ENCODERS)
def test_test_real_and_predict_real_match_jax(jx, tree, tmp_path, encoder):
    sys.path.insert(0, str(REPO / "scripts"))
    from predict_real import predict_real as jax_predict

    from idee_tpu_torch.cli.predict_real import predict_real

    # batch 3: three full batches of the 9 samples, no ragged last one
    cfg = _cfg(tree, tmp_path, encoder=encoder, name=f"test_{encoder}",
               batch_size=3)
    params = _jax_init(jx, cfg, tmp_path)
    want = jx.driver.test_real(jx.cfg(cfg), "CERRA", params=params)
    got = port_test_real(cfg, "CERRA", params=params, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        _close([got[k]], [want[k]], 1e-6, k)
    assert 0 < got["drought_f1"] < 1

    want = jax_predict(jx.cfg(cfg), "CERRA", str(tmp_path / "init_orbax"),
                       str(tmp_path / "jax.npz"))
    got = predict_real(cfg, "CERRA", str(tmp_path / "init.npz"),
                       str(tmp_path / "port.npz"), device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.load(tmp_path / "port.npz")[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "drought_prob":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        elif k == "anomaly":
            # bits may flip only where the LFQ latent is within float noise
            # of 0: at most one in a thousand
            assert (g != w).mean() <= 1e-3, (g != w).mean()
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["drought_mask"].any() and not got["drought_mask"][
        got["valid_mask"] == 0].any()
