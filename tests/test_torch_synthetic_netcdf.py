# ------------------------------------------------------------------
"""The port's synthetic benchmark data against the JAX package: the
benchmark cube generator, the whole-cube cache, the reference-schema
NetCDF reader (load_cube_netcdf), SyntheticDataset's NetCDF branch, the
two conversion CLIs, and training from a NetCDF tree with no .npz.

One cube, make_benchmark_cube(n_vars=4, n_time=60, 24x24, seed 3),
written twice: by the JAX package's h5py fixture writer (NetCDF4,
anomaly_extreme as [time, var, y, x]) and by the port's
write_synthetic_netcdf (NetCDF3, [var, time, y, x], masks as signed
bytes). Both packages read both trees. Reads take 3 of the 4 variables,
weeks 5-50 and the crop x 2-20, y 3-22. Every comparison is exact (the
two packages run the same numpy code on the same arrays), but the
normalised dataset items, held to 1e-6 in float32.
"""
# ------------------------------------------------------------------

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data import fake
from idee_tpu_torch.data.convert import convert_reanalysis
from idee_tpu_torch.data.reanalysis import cerra_spec, era5_land_spec
from idee_tpu_torch.data.synthetic import (SyntheticDataset, cube_npz_path,
                                           load_cube_netcdf)

torch.set_num_threads(1)

CUBE = dict(n_vars=4, n_time=60, height=24, width=24, seed=3)
FIELDS = ("dynamic", "anomaly", "extreme", "static", "clima_median",
          "clima_std")
VARS = ["var_01", "var_03", "var_04"]
STATIC = ["latitude", "longitude"]
TIMES = (5, 50)
CROP = dict(x_min=2, x_max=20, y_min=3, y_max=22)


def _same_cube(got, want, fields=FIELDS):
    for k in fields:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
            continue
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype.newbyteorder("=") == b.dtype.newbyteorder("="), k
    assert [str(v) for v in got.variables] == [str(v) for v in
                                               want.variables]
    assert got.stats == want.stats


@pytest.fixture(scope="module")
def cube():
    return fake.make_benchmark_cube(**CUBE)


@pytest.fixture(scope="module")
def trees(cube, tmp_path_factory):
    """{"hdf5": JAX's h5py tree, "netcdf3": the port's tree}, each a
    directory named synth with no .npz."""
    from idee_tpu.data.fake import write_fake_netcdf

    base = tmp_path_factory.mktemp("trees")
    out = {"hdf5": base / "hdf5" / "synth", "netcdf3": base / "nc3" / "synth"}
    write_fake_netcdf(str(out["hdf5"]), cube)
    fake.write_synthetic_netcdf(str(out["netcdf3"]), cube)
    return out


def test_make_benchmark_cube_is_jax_bit_for_bit(cube):
    from idee_tpu.data.fake import make_benchmark_cube

    want = make_benchmark_cube(**CUBE)
    _same_cube(cube, want)
    assert cube.variables_static == want.variables_static
    # the structure the accuracy runs rely on: events and distractors
    assert 0 < cube.extreme.mean() < 1 and 0 < cube.anomaly.mean() < 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cube_cache_loads_in_either_package(cube, tmp_path, writer):
    from idee_tpu.data import fake as jax_fake

    path = str(tmp_path / "cube.npz")
    save, load = ((fake.save_cube_npz, jax_fake.load_cube_npz)
                  if writer == "port"
                  else (jax_fake.save_cube_npz, fake.load_cube_npz))
    save(path, cube)
    _same_cube(load(path), cube)
    # the port reads its own file back, and without pickles
    _same_cube(fake.load_cube_npz(path), cube)
    assert json.loads(str(np.load(path, allow_pickle=False)["stats"]))


@pytest.mark.parametrize("tree", ["hdf5", "netcdf3"])
@pytest.mark.parametrize("need_stats,need_clima",
                         [(True, False), (False, True), (False, False)])
def test_load_cube_netcdf_matches_jax(trees, cube, tree, need_stats,
                                      need_clima):
    from idee_tpu.data.synthetic import load_cube_netcdf as jax_load

    args = (str(trees[tree]), VARS, STATIC, TIMES, CROP["x_min"],
            CROP["x_max"], CROP["y_min"], CROP["y_max"], need_stats,
            need_clima)
    got, want = load_cube_netcdf(*args), jax_load(*args)
    _same_cube(got, want)
    assert (got.stats is not None) == need_stats
    assert (got.clima_median is not None) == need_clima
    # and the values are the cube's, cut to the window
    vi = [cube.variables.index(v) for v in VARS]
    t, y, x = (slice(TIMES[0] - 1, TIMES[1]),
               slice(CROP["y_min"], CROP["y_max"]),
               slice(CROP["x_min"], CROP["x_max"]))
    np.testing.assert_array_equal(got.dynamic, cube.dynamic[vi][:, t, y, x])
    np.testing.assert_array_equal(got.anomaly, cube.anomaly[vi][:, t, y, x])
    np.testing.assert_array_equal(got.extreme, cube.extreme[t, y, x])
    if need_clima:
        np.testing.assert_array_equal(got.clima_std,
                                      cube.clima_std[vi][:, :, y, x])


DATASET_ARMS = [
    # is_norm, is_clima_scale, is_replace_anomaly, is_aug
    (True, False, False, False),
    (True, True, False, True),
    (False, False, True, False),
    (True, True, True, True),
]


@pytest.mark.parametrize("tree", ["hdf5", "netcdf3"])
@pytest.mark.parametrize("norm,clima,replace,aug", DATASET_ARMS)
def test_dataset_items_from_netcdf_match_jax(trees, tree, norm, clima,
                                             replace, aug):
    from idee_tpu.data.synthetic import SyntheticDataset as JaxDataset

    kw = dict(root_datacube=str(trees[tree]), times=TIMES, variables=VARS,
              variables_static=STATIC, delta_t=4, is_aug=aug,
              is_norm=norm, is_clima_scale=clima,
              is_replace_anomaly=replace, seed=5, **CROP)
    got, want = SyntheticDataset(**kw), JaxDataset(**kw)
    assert not os.path.exists(cube_npz_path(str(trees[tree])))
    assert len(got) == len(want) == TIMES[1] - TIMES[0] + 1 - 3
    np.testing.assert_array_equal(got.anomaly, want.anomaly)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                       err_msg=f"item {i} {k}")
    if norm and not replace:
        x = np.stack([got[i]["x"] for i in range(len(got))])
        assert np.isfinite(x).all() and x.std() > 0.1


def test_npz_wins_over_netcdf(trees, tmp_path):
    """With both in the directory, the .npz is read, as in JAX."""
    root = tmp_path / "synth"
    shutil.copytree(trees["netcdf3"], root)
    other = fake.make_fake_cube(n_vars=4, n_time=60, height=24, width=24,
                                seed=9)
    fake.write_cube_npz(str(root), other)
    kw = dict(root_datacube=str(root), times=TIMES, variables=VARS,
              variables_static=STATIC, delta_t=4, **CROP)
    ds = SyntheticDataset(**kw)
    vi = [other.variables.index(v) for v in VARS]
    np.testing.assert_array_equal(
        ds.anomaly, other.anomaly[vi][:, TIMES[0] - 1:TIMES[1],
                                      CROP["y_min"]:CROP["y_max"],
                                      CROP["x_min"]:CROP["x_max"]])


@pytest.mark.parametrize("tree", ["hdf5", "netcdf3"])
def test_convert_synthetic_cli_matches_jax(trees, tmp_path, tree):
    from idee_tpu.data.convert import convert_synthetic as jax_convert

    from idee_tpu_torch.cli.convert_synthetic import main

    got = np.load(main(["--root", str(trees[tree]), "--out",
                        str(tmp_path / "port.npz")]), allow_pickle=True)
    want = np.load(jax_convert(str(trees[tree]), str(tmp_path / "jax.npz")),
                   allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "stats":
            assert got[k].item() == want[k].item()
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    # without --out the .npz lands where SyntheticDataset looks first
    root = tmp_path / "synth"
    shutil.copytree(trees[tree], root)
    assert main(["--root", str(root)]) == cube_npz_path(str(root))


@pytest.mark.parametrize("family", ["CERRA", "ERA5_Land"])
def test_convert_reanalysis_cli_matches_convert(tmp_path, family):
    from idee_tpu.data.convert import convert_reanalysis as jax_convert
    from idee_tpu.data.reanalysis import cerra_spec as jax_cerra
    from idee_tpu.data.reanalysis import era5_land_spec as jax_era5

    from idee_tpu_torch.cli.convert_reanalysis import main, parse_years

    # each family's first year, whose skip rule keeps every window inside
    # it, so --validate needs no earlier year
    region = "EUR-11" if family == "ERA5_Land" else None
    years = ["1981", "1982"] if region else ["1984", "1985"]
    main_root, noaa_root = tmp_path / "main", tmp_path / "noaa"
    fake.write_fake_reanalysis(str(main_root), str(noaa_root), years=years,
                               height=16, width=16, era5_region=region,
                               seed=4)
    crop = ["--x_min", "2", "--x_max", "14", "--y_min", "1", "--y_max", "13"]
    flags = ["--family", family, "--root_main", str(main_root),
             "--root_noaa", str(noaa_root), "--years", "-".join(years),
             "--variables", "tp", "al", "t2m", "--alpha", "0.4",
             "--grid", "16x16", "--out", str(tmp_path / "cli")] + crop
    if region:
        flags += ["--region", region]
    out = main(flags + ["--validate"])
    assert parse_years(["1988-1990", "1995"]) == ["1988", "1989", "1990",
                                                   "1995"]
    spec = jax_era5(region, delta_t=8) if region else jax_cerra(delta_t=8)
    spec.grid_height = spec.grid_width = 16
    sub = (lambda p: str(p / region)) if region else str
    jax_convert(spec, sub(main_root), sub(noaa_root), years,
                ["tp", "al", "t2m"], str(tmp_path / "jax"), alpha=0.4,
                x_min=2, x_max=14, y_min=1, y_max=13)
    port_spec = era5_land_spec(region, 8) if region else cerra_spec(8)
    port_spec.grid_height = port_spec.grid_width = 16
    convert_reanalysis(port_spec, sub(main_root), sub(noaa_root),
                       years, ["tp", "al", "t2m"],
                       str(tmp_path / "port"), alpha=0.4, x_min=2, x_max=14,
                       y_min=1, y_max=13)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    for other in ("cli", "port"):
        assert sorted(p.name for p in (tmp_path / other).iterdir()) == files
        for name in files:
            a, b = tmp_path / other / name, tmp_path / "jax" / name
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b))
            else:
                assert json.loads(a.read_text()) == json.loads(b.read_text())
    assert out == str(tmp_path / "cli")


def _train_flags(root, dir_log, name):
    cfg = synthetic_config(
        encoder="Mamba", in_channels_dynamic=3, variables=VARS,
        x_min=2, x_max=18, y_min=3, y_max=19, en_embed_dim=[8, 8],
        en_depths=[2, 1], codebook_dim=8, cls_dim=8, batch_size=2,
        times_train=(1, 20), times_val=(21, 34), lr_warmup_epochs=0)
    flags = ["--device", "cpu", "--root_synthetic", str(root), "--dir_log",
             str(dir_log), "--name", name, "--n_epochs", "1",
             "--variables", str(VARS)]
    for k in ("encoder", "in_channels_dynamic", "x_min", "x_max", "y_min",
              "y_max", "en_embed_dim", "en_depths", "codebook_dim",
              "cls_dim", "times_train", "times_val", "batch_size",
              "lr_warmup_epochs"):
        flags += [f"--{k}", str(getattr(cfg, k))]
    assert cfg.is_clima_scale  # the config's own weekly climatology
    return flags


def test_train_synthetic_reads_a_netcdf_tree(tmp_path):
    """train_synthetic --root_synthetic <tree with no .npz> trains, and
    gives the history that the tree's converted .npz gives. The tree holds
    a make_fake_cube: the benchmark cube at 24x24 has windows whose
    extremes cover the whole crop, where the anomaly L1 is 0/0 (in JAX
    too)."""
    from idee_tpu_torch.cli.convert_synthetic import main as convert
    from idee_tpu_torch.cli.train_synthetic import main as train

    tree = tmp_path / "nc" / "synth"
    fake.write_synthetic_netcdf(str(tree), fake.make_fake_cube(**CUBE))
    got = train(_train_flags(tree, tmp_path, "nc"))
    root = tmp_path / "npz" / "synth"
    shutil.copytree(tree, root)
    convert(["--root", str(root)])
    want = train(_train_flags(root, tmp_path, "npz"))
    assert len(got["train_loss"]) == 1
    for k in ("train_loss", "val_loss", "train_f1", "val_f1",
              "train_anom_f1", "val_anom_f1"):
        for a, b in zip(got[k], want[k]):
            assert a == b or (math.isnan(a) and math.isnan(b)), k
    assert all(math.isfinite(v) for v in got["train_loss"] + got["val_loss"])


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_from_netcdf3_tree_on_card(cuda, tmp_path):
    """1 epoch of Mamba from a NetCDF3 tree of two years at 32x32 (no
    .npz, the weekly climatology): exact fused-scan launches, finite
    losses."""
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.train.driver import train_synthetic

    root = tmp_path / "synth"
    fake.write_synthetic_netcdf(str(root), fake.make_fake_cube(
        n_vars=6, n_time=104, height=32, width=32, seed=0))
    cfg = synthetic_config(encoder="Mamba", x_max=32, y_max=32,
                           root_synthetic=str(root), dir_log=str(tmp_path),
                           name="nc3", times_train=(1, 24),
                           times_val=(25, 40), n_epochs=1, batch_size=1)
    before = dict(ss.launches)
    history = train_synthetic(cfg, device=cuda)
    train_steps, val_steps = 24 - 8 + 1, 16 - 8 + 1
    assert ss.launches[ss.FUSED_FWD] - before[ss.FUSED_FWD] == \
        3 * (train_steps + val_steps)
    assert ss.launches[ss.FUSED_BWD] - before[ss.FUSED_BWD] == \
        3 * train_steps
    assert ss.launches[ss.LINEAR_SCAN] == before[ss.LINEAR_SCAN]
    assert all(math.isfinite(v) for v in
               history["train_loss"] + history["val_loss"])
