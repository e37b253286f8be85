# ------------------------------------------------------------------
"""The port's device-resident data path and fused epochs against the JAX
package (idee_tpu/data/device.py, idee_tpu/train/steps.py:182-301,
idee_tpu/train/steps_real.py:142-191) and against the port's own host
datasets and per-step loop.

Sizes of tests/test_fused_epoch.py: make_fake_cube(n_vars=3, n_time=40,
16x16), delta_t 8, batch 2; CNN_3D (en_depths [1, 1]) and a tiny Mamba
(plain scans on the CPU); the real-world tree is a 16x16 CERRA fixture
(years 1990-1991, NOAA week 5 of 1991 left out, delta_t 4). Tolerances:
  * device batches: bit for bit, against JAX's DeviceLoader /
    RealDeviceLoader (with JAX's flip bits, from
    fold_in(key, epoch * 100003 + b), fed to the port's batch() when
    augmenting) and against the port's host items under the same flips;
  * the drivers with device_data against JAX's: in
    tests/test_torch_device_drivers.py;
  * the port's fused epochs against its per-step loop over the same
    device batches, aug on: equal histories and parameters (on the CPU
    both run the same body eagerly).
The card-only test (graph replays against the eager steps, exact launch
counts, dropout drawing new bits each replay) carries the gpu marker.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.device import DeviceLoader, RealDeviceLoader
from idee_tpu_torch.data.fake import make_fake_cube, write_fake_reanalysis
from idee_tpu_torch.data.reanalysis import ReanalysisDataset, cerra_spec
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.driver_real import train_real

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
N_TIME = 40


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.data import device as jdevice
    from idee_tpu.data import reanalysis as jreanalysis
    from idee_tpu.data.fake import make_fake_cube as jax_fake_cube
    from idee_tpu.data.synthetic import SyntheticDataset as JDataset
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.train import driver as jdriver
    from idee_tpu.train import driver_real as jdriver_real

    return SimpleNamespace(
        jax=jax, jnp=jnp, device=jdevice, reanalysis=jreanalysis,
        fake_cube=jax_fake_cube, Dataset=JDataset, driver=jdriver,
        driver_real=jdriver_real, build_model=jax_build_model,
        cfg=lambda c: JConfig.from_dict(c.to_dict()))


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)


def _datasets(jx, cube, is_aug):
    kw = dict(times=(1, N_TIME), variables=VARS, delta_t=8, is_aug=is_aug,
              is_clima_scale=False)
    jcube = jx.fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                         seed=3)
    return SyntheticDataset(cube=cube, **kw), jx.Dataset(cube=jcube, **kw)


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g, w = got[k].cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def aug_of_bits(bits):
    """Three flip bits -> the host datasets' augmentation (rotate, flip) of
    ``draw_aug`` (data/device.py's docstring)."""
    r0, r1, r2 = (bool(b) for b in bits)
    return r0, (0 if not r1 else (1 if r2 else 2))


def _jax_bits(jx, key, batch):
    """JAX's flip bits of each sample of the batch keyed ``key`` (the
    bernoulli draws of idee_tpu/data/device.py's ``one``)."""
    keys = jx.jax.random.split(key, batch)
    return np.asarray(jx.jax.vmap(
        lambda k: jx.jax.random.bernoulli(k, 0.5, (3,)))(keys))


# ---------------------------------------------------------------- loaders

def test_device_loader_matches_jax_bit_for_bit_without_aug(jx, cube):
    ds, jds = _datasets(jx, cube, is_aug=False)
    got = DeviceLoader(ds, 2, seed=5, with_anomaly=True, device="cpu")
    want = jx.device.DeviceLoader(jds, 2, seed=5, with_anomaly=True)
    assert len(got) == len(want) == (N_TIME - 7) // 2
    batches = list(want)
    for b, (g, w) in enumerate(zip(got, batches)):
        _equal(g, w, f"batch {b}")
    assert len(batches) == len(got)
    # the next epoch's order: the same permutation stream
    np.testing.assert_array_equal(got.epoch_order()[0],
                                  want.epoch_order()[0])


def test_device_loader_matches_jax_with_jax_flip_bits(jx, cube):
    ds, jds = _datasets(jx, cube, is_aug=True)
    got = DeviceLoader(ds, 2, seed=1, with_anomaly=True, device="cpu")
    want = jx.device.DeviceLoader(jds, 2, seed=1, with_anomaly=True)
    flipped = 0
    for _ in range(2):
        order, epoch = want.epoch_order()
        g_order, g_epoch = got.epoch_order()
        np.testing.assert_array_equal(g_order, order)
        assert g_epoch == epoch
        for b in range(order.shape[0]):
            key = jx.jax.random.fold_in(want._key, epoch * 100003 + b)
            bits = _jax_bits(jx, key, 2)
            flipped += int(bits[:, 0].sum())
            w = want._fetch(order[b], key)
            g = got.batch(torch.from_numpy(order[b]),
                          torch.from_numpy(bits))
            _equal(g, w, f"epoch {epoch} batch {b}")
    assert flipped > 0


def test_device_batches_equal_host_items_under_the_same_flips(cube):
    ds = SyntheticDataset(cube=cube, times=(1, N_TIME), variables=VARS,
                          delta_t=8, is_aug=True, is_clima_scale=False)
    loader = DeviceLoader(ds, 2, seed=0, with_anomaly=True, device="cpu")
    order, epoch = loader.epoch_order()
    flips = loader.epoch_flips(epoch)
    assert flips.shape == (len(loader), 2, 3) and 0 < flips.mean() < 1
    # the draws are keyed by (seed, epoch): drawn again, the same bits
    np.testing.assert_array_equal(loader.epoch_flips(epoch), flips)
    augs = set()
    for b in range(order.shape[0]):
        got = loader.batch(torch.from_numpy(order[b]),
                           torch.from_numpy(flips[b]))
        for i, (idx, bits) in enumerate(zip(order[b], flips[b])):
            augs.add(aug_of_bits(bits))
            want = ds.item(int(idx), aug_of_bits(bits))
            for k in ("x", "mask_extreme", "mask_extreme_loss", "timestep"):
                np.testing.assert_array_equal(got[k][i].numpy(), want[k],
                                              err_msg=k)
            np.testing.assert_array_equal(
                got["mask_anomaly"][i].numpy(),
                want["mask_anomaly"].astype(np.uint8))
    assert len(augs) >= 4  # rotations and both flip axes occur


@pytest.fixture(scope="module")
def cerra(tmp_path_factory):
    root = tmp_path_factory.mktemp("cerra")
    main, noaa = str(root / "main"), str(root / "noaa")
    write_fake_reanalysis(main, noaa, variables=["al", "t2m", "tp"],
                          years=("1990", "1991"), height=16, width=16,
                          seed=0, missing_weeks=(("1991", 5),))
    return main, noaa


def _real_datasets(jx, cerra, **kw):
    out = []
    for spec_fn, cls in ((cerra_spec, ReanalysisDataset),
                         (jx.reanalysis.cerra_spec,
                          jx.reanalysis.ReanalysisDataset)):
        spec = spec_fn(4)
        spec.grid_height = spec.grid_width = 16
        out.append(cls(spec=spec, root_main=cerra[0], root_noaa=cerra[1],
                       delta_t=4, variables=["al", "t2m", "tp"],
                       years=["1991"], x_max=16, y_max=16, **kw))
    return out


@pytest.mark.parametrize("is_clima_scale", [False, True])
def test_real_device_loader_matches_jax_bit_for_bit(jx, cerra,
                                                    is_clima_scale):
    ds, jds = _real_datasets(jx, cerra, is_aug=True,
                             is_clima_scale=is_clima_scale)
    got = RealDeviceLoader(ds, 3, seed=2, device="cpu")
    want = jx.device.RealDeviceLoader(jds, 3, seed=2)
    # the missing week: two items share a NOAA file list through the
    # fallback, so fewer mask triples than main weeks
    assert len(ds) == 51 and got.d35.shape[0] < got.xw.shape[0]
    order, epoch = want.epoch_order()
    np.testing.assert_array_equal(got.epoch_order()[0], order)
    for b in range(order.shape[0]):
        key = jx.jax.random.fold_in(want._key, epoch * 100003 + b)
        w = want._fetch(order[b], key)
        g = got.batch(torch.from_numpy(order[b]),
                      torch.from_numpy(_jax_bits(jx, key, 3)))
        _equal(g, w, f"batch {b}")
        if b == 0:  # and without augmentation, the dataset's own items
            g = got.batch(torch.from_numpy(order[b]))
            for i, idx in enumerate(order[b]):
                item = ds.item(int(idx), None)
                for k in g:
                    np.testing.assert_array_equal(g[k][i].numpy(), item[k],
                                                  err_msg=k)


# ---------------------------------------------------------------- drivers

def _tiny(tmp, encoder="CNN_3D", **kw):
    base = dict(encoder=encoder, in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[1, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=2,
                lr_warmup_epochs=1, times_train=(1, 28),
                times_val=(29, N_TIME), is_aug=False, is_clima_scale=False,
                device_data=True, dir_log=str(tmp), name="dev")
    base.update(kw)
    return synthetic_config(**base)


def _history_and_params(run):
    hist = run()
    state = hist.pop("state")
    hist.pop("steps_per_sec")
    return hist, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("path", ["synthetic", "real"])
def test_fused_epochs_equal_the_per_step_device_loop(cube, tmp_path_factory,
                                                     tmp_path, path):
    """aug on, a tiny Mamba, with the anomaly-L1 curriculum on the
    synthetic path (the per-step lambda goes up with the epoch's order)."""
    if path == "synthetic":
        def run(fused):
            cfg = _tiny(tmp_path / str(fused), encoder="Mamba",
                        en_depths=[2, 1], is_aug=True, fused_epoch=fused,
                        anomaly_ramp_epochs=2)
            return train_synthetic(cfg, train_cube=cube.time_slice(1, 28),
                                   val_cube=cube.time_slice(29, N_TIME),
                                   device="cpu")
    else:
        root = tmp_path_factory.mktemp("cerra_aug")
        write_fake_reanalysis(str(root / "CERRA"), str(root / "NOAA"),
                              variables=["al", "t2m", "tp"],
                              years=("1984",), seed=1)

        def run(fused):
            cfg = _tiny(tmp_path / str(fused), encoder="Mamba",
                        is_aug=True, fused_epoch=fused, in_channels=2,
                        variables=["al", "t2m", "tp"],
                        root_CERRA=str(root / "CERRA"),
                        root_NOAA_CERRA=str(root / "NOAA"),
                        years_train=["1984"], years_val=["1984"],
                        grid_override=(16, 16))
            return train_real(cfg, "CERRA", device="cpu")

    fused, fused_params = _history_and_params(lambda: run(True))
    step, step_params = _history_and_params(lambda: run(False))
    assert fused == step
    for k, v in step_params.items():
        assert torch.equal(fused_params[k], v), k


def test_fused_epochs_refuse_debug_nans(cube, tmp_path):
    with pytest.raises(ValueError, match="fused_epoch=False"):
        train_synthetic(_tiny(tmp_path, debug_nans=True),
                        train_cube=cube.time_slice(1, 28),
                        val_cube=cube.time_slice(29, N_TIME), device="cpu")


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the scan kernels "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_replays_match_the_eager_steps_on_card(cuda, cube, tmp_path):
    """A tiny Mamba with classifier dropout (its generator registered with
    the train graph): the fused epochs (CUDA graph replays) against the
    per-step device loop, the first epoch's train loss within 1e-3
    relative (cuDNN's backward convolutions are not bit-deterministic); the
    fused scan's launches counted once per step on both paths (3 forward
    and 3 backward per train step, 3 forward per val step); the train
    state's step count advanced by every step; each epoch's image panels
    add one eager val forward. chip_smoke.py checks that replays draw new
    dropout bits."""
    from idee_tpu_torch.kernels import selective_scan as ss

    def run(fused):
        cfg = _tiny(tmp_path / str(fused), encoder="Mamba",
                    en_depths=[2, 1], is_aug=True, fused_epoch=fused,
                    cls_drop_rate=0.2)
        before = dict(ss.launches)
        hist = train_synthetic(cfg, train_cube=cube.time_slice(1, 28),
                               val_cube=cube.time_slice(29, N_TIME),
                               device=cuda)
        return hist, {k: ss.launches[k] - before[k] for k in before}

    fused, fused_launches = run(True)
    step, step_launches = run(False)
    # per epoch: the val steps and the image panels' forward
    n_train, n_val = 2 * ((28 - 7) // 2), 2 * ((N_TIME - 28 - 7) // 2 + 1)
    want = {ss.FUSED_FWD: 3 * (n_train + n_val), ss.FUSED_BWD: 3 * n_train,
            ss.LINEAR_SCAN: 0}
    assert fused_launches == want and step_launches == want
    np.testing.assert_allclose(fused["train_loss"][:1],
                               step["train_loss"][:1], rtol=1e-3)
    assert fused["state"].step == n_train
