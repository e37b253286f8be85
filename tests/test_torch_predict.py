# ------------------------------------------------------------------
"""The port's predict_synthetic (cli/predict_synthetic.py) against the
JAX package's (scripts/predict_synthetic.py), on the CPU.

Tiny config (3 variables, 16x16, delta_t=8, en_embed_dim=[8, 8],
en_depths=[2, 1], batch 2 over 13 samples: a ragged last batch), the
same N(0, 0.1) weights carried across (JAX from an orbax checkpoint, the
port from a flax-path .npz), the same fake cube. At float32 the payloads
are equal: the same keys, dtypes, shapes and NaN warm-up rows;
extreme_prob within 1e-5 (float32 through ~15 layers summed in another
order); extreme_mask, anomaly, timestep and variables exact. The CLI
round trip restores a run directory the port's trainer wrote. At bfloat16
the payload has the float32 one's keys, dtypes and NaN rows.

The JAX side is imported inside a fixture.
"""
# ------------------------------------------------------------------

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from idee_tpu_torch.cli.predict_synthetic import main as predict_cli
from idee_tpu_torch.cli.predict_synthetic import predict_synthetic
from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube, write_cube_npz
from idee_tpu_torch.models.interop import save_flax_npz
from idee_tpu_torch.train.driver import train_synthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VARS = ["var_01", "var_02", "var_03"]
N_TIME = 20
DT = 8


def _cfg(tmp, **kw):
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, times_test=(1, N_TIME),
                batch_size=2, name="predict", dir_log=str(tmp))
    base.update(kw)
    return synthetic_config(**base)


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """N(0, 0.1) flax params of the tiny config, as an orbax checkpoint
    (the JAX exporter's) and a flax-path .npz (the port's)."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.models.vq_model import build_model as jax_build_model

    tmp = tmp_path_factory.mktemp("weights")
    model = jax_build_model(JConfig.from_dict(_cfg(tmp).to_dict()))
    shapes = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, train=False),
        jnp.zeros((1, 3, 1, DT, 16, 16), jnp.float32))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])
    ocp.StandardCheckpointer().save(str(tmp / "orbax"), params)
    save_flax_npz(str(tmp / "params.npz"), params)
    return tmp


def _check_layout(payload):
    T = N_TIME
    want = {"extreme_prob": (np.float32, (T, 16, 16)),
            "extreme_mask": (np.uint8, (T, 16, 16)),
            "anomaly": (np.float32, (3, T, 16, 16)),
            "timestep": (np.int32, (T,))}
    for k, (dtype, shape) in want.items():
        assert payload[k].dtype == dtype and payload[k].shape == shape, k
    prob = payload["extreme_prob"]
    # the delta_t - 1 warm-up weeks are never a target
    assert np.isnan(prob[:DT - 1]).all()
    assert np.isfinite(prob[DT - 1:]).all()
    assert ((prob[DT - 1:] >= 0) & (prob[DT - 1:] <= 1)).all()
    assert list(payload["variables"]) == VARS


def test_predict_synthetic_matches_jax(cube, weights, tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    from predict_synthetic import predict_synthetic as jax_predict

    from idee_tpu.config import Config as JConfig
    from idee_tpu.data.fake import make_fake_cube as jax_make_fake_cube

    jcube = jax_make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                               seed=3)
    cfg = _cfg(tmp_path)
    want = jax_predict(JConfig.from_dict(cfg.to_dict()),
                       str(weights / "orbax"), str(tmp_path / "jax.npz"),
                       cube=jcube)
    got = predict_synthetic(cfg, str(weights / "params.npz"),
                            str(tmp_path / "port.npz"), cube=cube,
                            device="cpu")
    assert sorted(got) == sorted(want)
    written = np.load(tmp_path / "port.npz")
    assert sorted(written.files) == sorted(want)
    _check_layout(got)
    for k, w in want.items():
        g = written[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "extreme_prob":
            assert np.array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["extreme_mask"].any() and not got["extreme_mask"].all()
    assert 0 < np.nanmean(got["anomaly"]) < 1


def test_cli_round_trip_from_a_port_run(cube, tmp_path):
    """Train one epoch with the port's driver from an .npz cube, then export
    from its run directory through the CLI: the payload equals
    predict_synthetic's on the same checkpoint."""
    root = tmp_path / "synthetic_fake"
    write_cube_npz(str(root), cube)
    cfg = _cfg(tmp_path / "log", root_synthetic=str(root),
               times_train=(1, 12), times_val=(13, N_TIME), n_epochs=1)
    train_synthetic(cfg, device="cpu")
    run = Path(cfg.log_dir)
    got = predict_cli(["--run_dir", str(run), "--checkpoint", "latest",
                       "--device", "cpu", "--out", str(tmp_path / "a.npz")])
    want = predict_synthetic(cfg, str(run / "model_checkpoints" /
                                      "latest.pt"),
                             str(tmp_path / "b.npz"), device="cpu")
    _check_layout(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tmp_path / "a.npz").exists()


def test_bf16_payload_keeps_the_float32_layout(cube, weights, tmp_path):
    cfg = _cfg(tmp_path, dtype="bfloat16")
    got = predict_synthetic(cfg, str(weights / "params.npz"),
                            str(tmp_path / "bf16.npz"), cube=cube,
                            device="cpu")
    _check_layout(got)


def test_eval_step_return_preds(cube, weights):
    """make_eval_step(return_preds=True) accumulates the same metrics and
    returns sigmoid(z), its prediction at 0.5 and the anomaly bits, as
    JAX's make_eval_step(return_preds=True) and train/steps_real.py's do."""
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.data.synthetic import SyntheticDataset
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.checkpoint import load_pretrained_weights
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_eval_step

    cfg = _cfg(weights)
    ds = SyntheticDataset(cube=cube, times=cfg.times_test, variables=VARS,
                          delta_t=DT, x_max=16, y_max=16)
    model = build_model(cfg)
    model.load_state_dict(load_pretrained_weights(
        cfg, str(weights / "params.npz")))
    batch = next(iter(DataLoader(ds, 2, device="cpu")))
    plain, with_preds = (init_epoch_metrics(ds.anomaly.shape, "cpu")
                         for _ in range(2))
    plain = make_eval_step(model, cfg, t0=1.0)(plain, batch)
    with_preds, preds = make_eval_step(model, cfg, t0=1.0,
                                       return_preds=True)(with_preds, batch)
    for k in ("n_steps", "vote_sum", "vote_cnt"):
        assert torch.equal(plain[k], with_preds[k]), k
    for k in plain["counts"]:
        assert torch.equal(plain["counts"][k], with_preds["counts"][k]), k
    with torch.inference_mode():
        out = model.eval()(batch["x"],
                           mask_extreme_loss=batch["mask_extreme_loss"])
    assert torch.equal(preds["pred"], torch.sigmoid(out.z))
    assert torch.equal(preds["pred_c"], (preds["pred"] > 0.5).float())
    assert torch.equal(preds["anomaly"], out.anomaly)
