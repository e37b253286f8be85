# ------------------------------------------------------------------
"""The port's drivers with device_data against the JAX package's (the
device loaders and the fused epochs of both, end to end):
train_synthetic on make_fake_cube(n_vars=3, n_time=40, 16x16) and
train_real on a 16x16 CERRA fixture (year 1984, 9 samples), both CNN_3D
(en_depths [1, 1]), batch 2, aug off, 2 epochs, from the same N(0, 0.1)
weights (an orbax checkpoint for JAX, a flax-path .npz for the port).
Tolerances of tests/test_torch_train.py's driver test: losses rtol 1e-4,
every F1 equal. The config and loaders are those of
tests/test_torch_device_data.py.
"""
# ------------------------------------------------------------------

import math

import numpy as np
import torch

from idee_tpu_torch.data.fake import write_fake_reanalysis
from idee_tpu_torch.models.interop import save_flax_npz
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.driver_real import train_real
from test_torch_device_data import N_TIME, _tiny, cube, jx  # noqa: F401

torch.set_num_threads(1)

F1_KEYS = ("train_f1", "val_f1", "train_anom_f1", "val_anom_f1")


def _init_weights(jx, cfg, tmp, shape):
    """N(0, 0.1) weights in the JAX model's tree, as an orbax checkpoint
    (the JAX driver's en_de_pretrained) and a flax-path .npz (the
    port's)."""
    import orbax.checkpoint as ocp

    model = jx.build_model(jx.cfg(cfg))
    shapes = jx.jax.eval_shape(lambda a: model.init(
        jx.jax.random.PRNGKey(0), a, train=False),
        jx.jnp.zeros(shape, jx.jnp.float32))
    rng = np.random.default_rng(11)
    params = jx.jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])
    ocp.StandardCheckpointer().save(str(tmp / "init_orbax"), params)
    save_flax_npz(str(tmp / "init.npz"), params)
    return str(tmp / "init_orbax"), str(tmp / "init.npz")


def _same_history(got, want, f1_keys):
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    for k in f1_keys:
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a == b or (math.isnan(a) and math.isnan(b)), (k, a, b)


def test_train_synthetic_device_data_matches_jax(jx, cube, tmp_path):
    cfg = _tiny(tmp_path / "port")
    orbax, npz = _init_weights(jx, cfg, tmp_path, (1, 3, 1, 8, 16, 16))
    jcube = jx.fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                         seed=3)
    want = jx.driver.train_synthetic(
        jx.cfg(cfg.replace(dir_log=str(tmp_path / "jax"),
                           en_de_pretrained=orbax)),
        train_cube=jcube.time_slice(1, 28),
        val_cube=jcube.time_slice(29, N_TIME))
    got = train_synthetic(cfg.replace(en_de_pretrained=npz),
                          train_cube=cube.time_slice(1, 28),
                          val_cube=cube.time_slice(29, N_TIME),
                          device="cpu")
    _same_history(got, want, F1_KEYS)
    assert got["state"].step == 2 * ((28 - 7) // 2)


def test_train_real_device_data_matches_jax(jx, tmp_path_factory, tmp_path):
    root = tmp_path_factory.mktemp("cerra_1984")
    write_fake_reanalysis(str(root / "CERRA"), str(root / "NOAA"),
                          variables=["al", "t2m", "tp"], years=("1984",),
                          seed=0)
    cfg = _tiny(tmp_path / "port", in_channels=2,
                variables=["al", "t2m", "tp"], delta_t=8,
                root_CERRA=str(root / "CERRA"),
                root_NOAA_CERRA=str(root / "NOAA"), years_train=["1984"],
                years_val=["1984"], grid_override=(16, 16), name="real")
    orbax, npz = _init_weights(jx, cfg, tmp_path, (1, 3, 2, 8, 16, 16))
    want = jx.driver_real.train_real(
        jx.cfg(cfg.replace(dir_log=str(tmp_path / "jax"),
                           en_de_pretrained=orbax)), "CERRA")
    got = train_real(cfg.replace(en_de_pretrained=npz), "CERRA",
                     device="cpu")
    _same_history(got, want, ("train_f1", "val_f1"))
    assert got["state"].step == 2 * (9 // 2)
