# ------------------------------------------------------------------
"""The port's accuracy drivers against the JAX package's scripts:
cli/train_benchmark_accuracy.py against scripts/train_benchmark_accuracy.py
and cli/train_baselines_zoo.py against scripts/train_baselines_zoo.py,
with predict_synthetic's --cube_npz.

The configs, the cubes handed to the trainer and the JSON payload are
compared with the trainers replaced by a stub that records what it is
given and returns one canned history (NaN epochs included), so no JAX
trainer compiles: configs field by field (but device_data, which the port
does not have, and STEAL's delta_t, see the zoo CLI), cubes bit for bit,
payload files byte for byte. Then the port's CLIs run for real on the CPU
at 24x24 over 2 years for 1 epoch (make_benchmark_cube needs a grid of at
least 20: its events are placed 10 pixels from the border).
"""
# ------------------------------------------------------------------

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from idee_tpu_torch.cli import train_baselines_zoo as zoo
from idee_tpu_torch.cli import train_benchmark_accuracy as acc
from idee_tpu_torch.data.fake import load_cube_npz, make_benchmark_cube

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW, YEARS = 24, 2
NAN = float("nan")
HISTORY_KEYS = ["train_loss", "val_loss", "train_f1", "val_f1",
                "train_anom_f1", "val_anom_f1", "steps_per_sec"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _canned_history():
    return {"train_loss": [2.0, 1.5], "val_loss": [1.8, 1.7],
            "train_f1": [0.1, 0.2], "val_f1": [NAN, 0.25],
            "train_anom_f1": [0.3, 0.35], "val_anom_f1": [NAN, NAN],
            "steps_per_sec": [5.0, 6.0], "state": object()}


def _recorder(seen):
    def train(cfg, train_cube=None, val_cube=None, device="cpu"):
        seen.update(cfg=cfg, train_cube=train_cube, val_cube=val_cube,
                    device=device)
        return _canned_history()
    return train


def _same_cubes(got, want):
    for k in ("dynamic", "anomaly", "extreme", "static", "clima_median",
              "clima_std"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.stats == want.stats


ACC_ARMS = [
    [],
    ["--encoder", "Mamba", "--d_state", "1", "--batch", "8"],
    ["--encoder", "Swin_3D", "--codebook", "VQ_EMA",
     "--lambda_commitment", "0.25", "--density_ref_hw", "0"],
    ["--codebook", "FSQ", "--bce_weighting", "capped", "--name", "fsq",
     "--seed", "2"],
]


@pytest.mark.parametrize("arm", ACC_ARMS,
                         ids=["default", "mamba", "vq_ema", "fsq"])
def test_accuracy_cli_matches_the_jax_script(monkeypatch, tmp_path, arm):
    """The same flags give JAX's config (but device_data), JAX's train and
    val cubes and JAX's payload file."""
    import idee_tpu.train.driver as jax_driver

    flags = arm + ["--hw", str(HW), "--years", str(YEARS), "--epochs", "2",
                   "--dir_log", str(tmp_path / "log")]
    want = {}
    monkeypatch.setattr(jax_driver, "train_synthetic", _recorder(want))
    monkeypatch.setattr("sys.argv", ["train_benchmark_accuracy.py"] + flags
                        + ["--out", str(tmp_path / "jax.json")])
    _script("train_benchmark_accuracy").main()

    got = {}
    monkeypatch.setattr(acc, "train_synthetic", _recorder(got))
    payload = acc.main(flags + ["--out", str(tmp_path / "port.json"),
                                "--device", "cpu"])
    assert got["device"] == "cpu"
    a, b = got["cfg"].to_dict(), want["cfg"].to_dict()
    assert a.pop("device_data") is False and b.pop("device_data") is True
    assert a == b
    _same_cubes(got["train_cube"], want["train_cube"])
    _same_cubes(got["val_cube"], want["val_cube"])
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    assert payload["best_val_f1"] == 0.25
    assert payload["best_val_anom_f1"] is None


def test_accuracy_cli_float32_arm_differs_only_in_dtype_and_name():
    base = acc.parse_args(["--encoder", "CNN_3D", "--hw", "48"])
    f32 = acc.parse_args(["--encoder", "CNN_3D", "--hw", "48", "--dtype",
                          "float32"])
    a, b = acc.build_config(base).to_dict(), acc.build_config(f32).to_dict()
    assert (a.pop("dtype"), b.pop("dtype")) == ("bfloat16", "float32")
    assert (a.pop("name"), b.pop("name")) == ("acc_CNN_3D_48",
                                              "acc_CNN_3D_48_float32")
    assert a == b
    assert acc.split_weeks(40) == (2080, 1768)
    assert acc.split_weeks(2) == (104, 88)


@pytest.fixture(scope="module")
def acc_run(tmp_path_factory):
    """The accuracy CLI for real: CNN_3D, bf16, 24x24, 2 years, 1 epoch,
    batch 8, on the CPU, writing a cube cache."""
    tmp = tmp_path_factory.mktemp("acc")
    flags = ["--hw", str(HW), "--years", str(YEARS), "--epochs", "1",
             "--batch", "8", "--dir_log", str(tmp / "log"),
             "--cube_npz", str(tmp / "cube.npz"), "--device", "cpu"]
    payload = acc.main(flags + ["--out", str(tmp / "run.json")])
    return tmp, flags, payload


def test_accuracy_cli_trains_and_writes_the_payload(acc_run):
    tmp, flags, payload = acc_run
    assert list(payload) == ["encoder", "hw", "batch", "codebook",
                             "bce_weighting", "density_ref_hw", "d_state",
                             "lambda_commitment", "epochs", "recipe",
                             "history", "best_val_f1", "best_val_anom_f1"]
    assert sorted(payload["history"]) == sorted(HISTORY_KEYS)
    assert json.loads((tmp / "run.json").read_text()).keys() == \
        payload.keys()
    assert all(math.isfinite(v) for v in payload["history"]["train_loss"])
    for best, key in (("best_val_f1", "val_f1"),
                      ("best_val_anom_f1", "val_anom_f1")):
        v = payload[best]
        assert v is None or (0 <= v <= 1 and v in payload["history"][key])
    run = tmp / "log" / "acc_CNN_3D_24"
    assert json.loads((run / "config.json").read_text())["dtype"] == \
        "bfloat16"
    assert (run / "model_checkpoints" / "latest.pt").exists()
    # the cache holds the generated cube, density held at the 48x48 level
    dens = (HW / 48) ** 2
    _same_cubes(load_cube_npz(str(tmp / "cube.npz")), make_benchmark_cube(
        n_vars=6, n_time=YEARS * 52, height=HW, width=HW, seed=0,
        events_per_year=8.0 * dens, distractors_per_year=10.0 * dens))


def test_predict_synthetic_reads_the_cube_cache(acc_run):
    """predict_synthetic --cube_npz slices the cache to times_test and
    gives what the in-memory cube gives."""
    from idee_tpu_torch.cli.predict_synthetic import main, predict_synthetic
    from idee_tpu_torch.config import load_config

    tmp, _, _ = acc_run
    run = tmp / "log" / "acc_CNN_3D_24"
    got = main(["--run_dir", str(run), "--checkpoint", "latest",
                "--cube_npz", str(tmp / "cube.npz"), "--times", "(53,104)",
                "--out", str(tmp / "pred.npz"), "--device", "cpu"])
    cfg = load_config(str(run / "config.json")).replace(
        is_aug=False, times_test=(53, 104))
    want = predict_synthetic(
        cfg, str(run / "model_checkpoints" / "latest.pt"),
        str(tmp / "pred_mem.npz"),
        cube=load_cube_npz(str(tmp / "cube.npz")).time_slice(53, 104),
        device="cpu")
    assert got["extreme_prob"].shape == (52, HW, HW)
    np.testing.assert_array_equal(got["timestep"], np.arange(53, 105))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("which", zoo.ALL)
def test_zoo_configs_match_the_jax_script(monkeypatch, tmp_path, which):
    """Each baseline's config is the JAX script's, but STEAL's delta_t (8,
    where the JAX script leaves the reconstruction default 1)."""
    from idee_tpu.baselines.mil import driver as mil
    from idee_tpu.baselines.oneclass import driver as oneclass
    from idee_tpu.baselines.recon import driver as recon

    seen = {}

    def record(cfg, *args, train_cube=None, val_cube=None):
        seen.update(cfg=cfg, train_cube=train_cube, val_cube=val_cube)
        return {"val_anom_f1": [NAN, 0.4], "val_loss": [1.0],
                "steps_per_sec": [2.0], "state": object()}

    monkeypatch.setattr(mil, "train_mil_synthetic", record)
    monkeypatch.setattr(oneclass, "train_simplenet_synthetic", record)
    monkeypatch.setattr(recon, "train_recon_synthetic", record)
    cube = make_benchmark_cube(n_vars=6, n_time=YEARS * 52, height=HW,
                               width=HW, seed=0)
    ckpt = str(tmp_path / "best_F1_model")
    res = _script("train_baselines_zoo").run_one(
        which, cube, HW, 3, YEARS, str(tmp_path), pretrained=ckpt)
    got = zoo.zoo_config(which, HW, 3, YEARS, str(tmp_path), ckpt)
    a, b = got.to_dict(), seen["cfg"].to_dict()
    assert type(got).__name__ == type(seen["cfg"]).__name__
    if which == "steal":
        assert (a.pop("delta_t"), b.pop("delta_t")) == (8, 1)
    assert a == b
    assert res["best_val_anom_f1"] == 0.4
    _same_cubes(seen["train_cube"], cube.time_slice(1, 88))
    _same_cubes(seen["val_cube"], cube.time_slice(89, 104))


def test_zoo_pretrained_takes_a_checkpoint_alias(tmp_path):
    (tmp_path / "best_F1_model.pt").write_bytes(b"")
    alias = str(tmp_path / "best_F1_model")
    assert zoo.checkpoint_path(alias) == alias + ".pt"
    assert zoo.checkpoint_path(alias + ".pt") == alias + ".pt"
    assert zoo.checkpoint_path(None) is None
    assert zoo.zoo_config("simplenet", HW, 1, YEARS, str(tmp_path),
                          alias).model_pretrained == alias + ".pt"


def test_zoo_cli_trains_steal_and_rewrites_its_json(monkeypatch, tmp_path):
    """--which steal,steal: the JSON holds the first result before the
    second baseline starts, and both after."""
    out = tmp_path / "zoo.json"
    out.write_text("stale")
    run_one, seen = zoo.run_one, []

    def watch(which, *args, **kw):
        seen.append(out.read_text())
        return run_one(which, *args, **kw)

    monkeypatch.setattr(zoo, "run_one", watch)
    results = zoo.main(["--which", "steal,steal", "--hw", str(HW),
                        "--years", str(YEARS), "--epochs", "1",
                        "--dir_log", str(tmp_path / "log"), "--out",
                        str(out), "--device", "cpu"])
    assert seen[0] == "stale"
    assert [r["baseline"] for r in json.loads(seen[1])] == ["steal"]
    written = json.loads(out.read_text())
    assert [r["baseline"] for r in written] == ["steal", "steal"]
    r = written[0]
    assert set(r) == {"baseline", "epochs", "best_val_anom_f1",
                      "final_val_loss", "steps_per_sec", "history", "secs"}
    assert r["epochs"] == 1 and len(r["history"]["val_anom_f1"]) == 1
    assert math.isfinite(r["final_val_loss"])
    assert results[1]["history"]["train_loss"] == r["history"]["train_loss"]


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D"])
def test_accuracy_cli_on_card(cuda, tmp_path, encoder):
    """1 epoch of the accuracy CLI at 32x32 over 2 years, batch 8, bf16:
    each block launches its kernel once per forward (10 train and 1 val
    step: the 81 and 9 windows of weeks 1-88 and 89-104, partial batches
    dropped; and the epoch's image panels, one more val forward)."""
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.kernels import window_attention as wa

    counters = [ss.launches, wa.launches]
    before = [dict(c) for c in counters]
    payload = acc.main(["--encoder", encoder, "--hw", "32", "--years", "2",
                        "--epochs", "1", "--batch", "8", "--dir_log",
                        str(tmp_path), "--out", str(tmp_path / "a.json")])
    got = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
    train, val = 10, 1 + 1
    if encoder == "Mamba":
        want = {ss.FUSED_FWD: 3 * (train + val), ss.FUSED_BWD: 3 * train}
    else:
        want = {wa.ATTN_FWD_BF16: 3 * (train + val),
                wa.ATTN_BWD_BF16: 3 * train, wa.DBIAS_SUM: 3 * train}
    assert got == {k: want.get(k, 0) for k in got}
    assert all(math.isfinite(v) for v in payload["history"]["train_loss"])
