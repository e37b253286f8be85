# ------------------------------------------------------------------
"""The port's first slice as a whole: synthetic evaluation with the Mamba
encoder, the 1-bit LFQ codebook and the CNN_3D classifier.

CPU tests hold the port against the JAX package at a small size (3
variables, 16x16, delta_t=8, en_embed_dim=[8, 8], en_depths=[2, 1] so the
shifted block runs, default windows), with the same numpy-made weights
carried across by ``load_flax_params``:
  * the VQModel forward: logits within 1e-4 (float32 through ~15 layers
    whose sums run in another order), anomaly bits equal wherever the LFQ
    latent |s| > 1e-4, near-zero flips counted and bounded;
  * ``test_synthetic`` end to end: identical metrics (they are ratios of
    integer counts) and mean_loss within rel 1e-5.

The JAX side is imported inside the fixtures, so the card-only tests also
collect where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_slice.py -m gpu``).
"""
# ------------------------------------------------------------------

import math
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import idee_tpu_torch
from idee_tpu_torch.config import Config, synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube, write_cube_npz
from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.models.interop import load_flax_params, save_flax_npz
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.cli.train_synthetic import main as train_cli
from idee_tpu_torch.train.driver import train_synthetic as port_train
from idee_tpu_torch.train.evaluate import test_synthetic as port_test

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VARS = ["var_01", "var_02", "var_03"]
N_TIME = 20


def _tiny_config(**kw) -> Config:
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, times_test=(1, N_TIME),
                name="slice")
    base.update(kw)
    return synthetic_config(**base)


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model of the tiny config and its parameters: the flax tree's
    shapes filled with N(0, 0.1) from a numpy seed."""
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.train.evaluate import test_synthetic as jax_test

    jcfg = JConfig.from_dict(_tiny_config().to_dict())
    model = jax_build_model(jcfg)
    x = jnp.zeros((1, 3, 1, 8, 16, 16), jnp.float32)
    shapes = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, train=False), x)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])
    return SimpleNamespace(jnp=jnp, cfg=jcfg, model=model, params=params,
                           test_synthetic=jax_test)


def test_port_imports_nothing_of_jax():
    package = sorted((REPO / "idee_tpu_torch").rglob("*.py"))
    files = package + [REPO / "chip_smoke.py", REPO / "measure_cerra_step.py",
                       REPO / "mil_gradient_drift.py"]
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|idee_tpu)\b", re.M)
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in banned.finditer(f.read_text())]
    assert not hits, hits
    # every module of the package, imported in a fresh interpreter
    modules = sorted(".".join(f.relative_to(REPO).with_suffix("").parts)
                     for f in package if f.name != "__init__.py")
    assert "idee_tpu_torch.train.driver_real" in modules
    assert "idee_tpu_torch.data.device" in modules
    assert "idee_tpu_torch.cli.predict_synthetic" in modules
    assert {f"idee_tpu_torch.cli.{m}" for m in (
        "convert_synthetic", "convert_reanalysis", "train_benchmark_accuracy",
        "train_baselines_zoo")} <= set(modules)
    assert {f"idee_tpu_torch.quant.{m}" for m in (
        "lfq", "vq", "fsq", "latent_quantize", "random_vq")} <= set(modules)
    assert {f"idee_tpu_torch.cli.{m}" for m in (
        "import_reference_checkpoint", "export_reference_checkpoint",
        "memory_fit", "profile_step", "visualize_data")} <= set(modules)
    assert "idee_tpu_torch.utils.vis" in modules
    assert (REPO / "idee_tpu_torch" / "native" / "__init__.py") in package
    # the port's C++ and CUDA sources include nothing of the JAX package and
    # name no path into it
    sources = sorted(
        f for pattern in ("*.cpp", "*.cu", "*.h", "*.cuh")
        for f in (REPO / "idee_tpu_torch").rglob(pattern)
        if "build" not in f.relative_to(REPO).parts)
    assert REPO / "idee_tpu_torch" / "native" / "datacube_engine.cpp" \
        in sources
    include = re.compile(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', re.M)
    hits = [f"{f.relative_to(REPO)}: {inc}" for f in sources
            for inc in include.findall(f.read_text())
            if re.search(r"(^|/)idee_tpu(/|$)", inc)]
    hits += [f"{f.relative_to(REPO)}: names idee_tpu/" for f in sources
             if re.search(r"(?<![\w.])idee_tpu/", "\n".join(
                 line for line in f.read_text().splitlines()
                 if not line.lstrip().startswith("//")))]
    assert not hits, hits
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'idee_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_entry_points_need_a_card_or_explicit_cpu(monkeypatch, cube,
                                                  tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        idee_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test(_tiny_config(dir_log=str(tmp_path)), cube=cube)
    train_cfg = _tiny_config(dir_log=str(tmp_path), times_train=(1, 12),
                             times_val=(13, N_TIME), n_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train(train_cfg, train_cube=cube.time_slice(1, 12),
                   val_cube=cube.time_slice(13, N_TIME))
    root = tmp_path / "synthetic_fake"
    write_cube_npz(str(root), cube)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli(["--root_synthetic", str(root), "--dir_log",
                   str(tmp_path), "--variables", str(VARS),
                   "--in_channels_dynamic", "3", "--x_max", "16",
                   "--y_max", "16", "--times_train", "(1, 12)",
                   "--times_val", f"(13, {N_TIME})"])
    assert idee_tpu_torch.resolve_device("cpu").type == "cpu"


def test_tool_clis_need_a_card_or_explicit_cpu(monkeypatch, tmp_path):
    """The reference-checkpoint CLIs, memory_fit and profile_step run on
    cuda unless given --device cpu (the check above)."""
    from idee_tpu_torch.cli import (export_reference_checkpoint,
                                    import_reference_checkpoint, memory_fit,
                                    profile_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pth = tmp_path / "missing.pth"
    for main, argv in (
            (import_reference_checkpoint.main,
             ["--checkpoint", str(pth), "--out", str(tmp_path / "o.pt")]),
            (export_reference_checkpoint.main,
             ["--checkpoint", str(pth), "--out", str(tmp_path / "o.pth")]),
            (memory_fit.main, ["--family", "synthetic", "--hw", "16"]),
            (profile_step.main, ["--hw", "16", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_vq_model_forward_matches_jax(jax_side, cube):
    jnp = jax_side.jnp
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32)
    mel = (rng.random((2, 16, 16)) < 0.2).astype(np.float32)
    import jax

    # jitted: one XLA compile is quicker on this CPU than eager dispatch
    want = jax.jit(lambda p, a, m: jax_side.model.apply(
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


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in ("extreme_f1", "extreme_iou", "driver_f1_pos",
              "driver_iou_pos"):
        assert (got[k] == want[k]
                or (math.isnan(got[k]) and math.isnan(want[k]))), k
    assert got["mean_loss"] == pytest.approx(want["mean_loss"], rel=1e-5)


def test_test_synthetic_matches_jax(jax_side, cube, tmp_path):
    from idee_tpu.data.fake import make_fake_cube as jax_make_fake_cube

    jcube = jax_make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                               seed=3)
    want = jax_side.test_synthetic(
        jax_side.cfg.replace(dir_log=str(tmp_path / "jax")), cube=jcube,
        params=jax_side.params)
    got = port_test(_tiny_config(dir_log=str(tmp_path / "port")), cube=cube,
                    params=jax_side.params, device="cpu")
    _same_metrics(got, want)
    assert 0.0 < got["driver_f1_pos"] < 1.0


def test_cli_reads_npz_cube_and_flax_npz_params(jax_side, cube, tmp_path):
    from idee_tpu_torch.cli.test_synthetic import main

    root = tmp_path / "synthetic_fake"
    write_cube_npz(str(root), cube)
    params = tmp_path / "params.npz"
    save_flax_npz(str(params), jax_side.params)
    cfg = _tiny_config(dir_log=str(tmp_path / "log"))
    flags = ["--device", "cpu", "--root_synthetic", str(root),
             "--en_de_pretrained", str(params), "--dir_log", cfg.dir_log,
             "--name", "cli", "--variables", str(VARS)]
    for k in ("encoder", "in_channels_dynamic", "x_max", "y_max",
              "en_embed_dim", "en_depths", "codebook_dim", "cls_dim",
              "times_test"):
        flags += [f"--{k}", str(getattr(cfg, k))]
    got = main(flags)
    want = port_test(cfg, cube=cube, params=jax_side.params, device="cpu")
    _same_metrics(got, want)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the selective-scan kernel has no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_vq_model_forward_on_card_matches_cpu(cuda):
    """The same weights and batch on the card (the CUDA scan kernel, cuDNN
    and cuBLAS in float32) and on the CPU (the plain scan): logits within
    1e-4, the kernel launched three times (two stage-0 blocks, one
    stage-1 block)."""
    cfg = _tiny_config()
    model = build_model(cfg).eval()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 3, 1, 8, 16, 16)).astype(
        np.float32))
    with torch.inference_mode():
        want = model(x)
        model.to(cuda)
        before = ss.launches[ss.FUSED_FWD]
        got = model(x.to(cuda))
        torch.cuda.synchronize()
    assert ss.launches[ss.FUSED_FWD] == before + 3
    torch.testing.assert_close(got.z.cpu(), want.z, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.y.cpu(), want.y, rtol=1e-4, atol=1e-4)
