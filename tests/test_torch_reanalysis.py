# ------------------------------------------------------------------
"""The port's real-world data path against the JAX package: the NetCDF
reader, the fixture writers, the week index, the dataset items, the
offline cache and the threaded loader.

Trees are 16x16 (CERRA: years 1990-1991 with NOAA week 5 of 1991 left out,
so the rollover and the missing-week fallback run; ERA5-Land: EUR-11),
written from one seed by the JAX writers (NetCDF4 through h5py) and by
the port's (NetCDF3 through scipy). Dataset items use delta_t=4. Every
comparison is exact: the two packages run the same numpy code on the same
arrays, so items, index and caches agree bit for bit.
"""
# ------------------------------------------------------------------

import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from idee_tpu_torch.data.convert import convert_reanalysis, convert_synthetic
from idee_tpu_torch.data.fake import (write_fake_reanalysis,
                                      write_structured_reanalysis)
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.netcdf import NetCDFFile, is_netcdf3
from idee_tpu_torch.data.reanalysis import (ReanalysisDataset,
                                            build_week_index, cerra_spec,
                                            era5_land_spec)

torch.set_num_threads(1)

VARS = ["al", "t2m", "tp"]
YEARS = ("1990", "1991")
MISSING = (("1991", 5),)


def _write_trees(root: Path, **kw):
    """{"port": (main, noaa), "jax": (main, noaa)} written from seed 0 (the
    JAX writer needs h5py)."""
    pytest.importorskip("h5py")
    from idee_tpu.data.fake import write_fake_reanalysis as jax_write

    trees = {}
    for side, write in (("port", write_fake_reanalysis), ("jax", jax_write)):
        main, noaa = str(root / side / "main"), str(root / side / "noaa")
        write(main, noaa, years=YEARS, height=16, width=16, seed=0, **kw)
        trees[side] = (main, noaa)
    return trees


@pytest.fixture(scope="module")
def cerra(tmp_path_factory):
    return _write_trees(tmp_path_factory.mktemp("cerra"),
                        missing_weeks=MISSING)


@pytest.fixture(scope="module")
def era5(tmp_path_factory):
    trees = _write_trees(tmp_path_factory.mktemp("era5"),
                         era5_region="EUR-11")
    return {side: tuple(os.path.join(r, "EUR-11") for r in roots)
            for side, roots in trees.items()}


def _files(root: str):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _trees_equal(a, b, reader):
    """Every file of the two trees read with ``reader``: the same names,
    the same variables, the same values; JSON files equal."""
    for ra, rb in zip(a, b):
        names = _files(ra)
        assert names == _files(rb)
        for name in names:
            pa, pb = os.path.join(ra, name), os.path.join(rb, name)
            if name.endswith(".json"):
                with open(pa) as fa, open(pb) as fb:
                    assert json.load(fa) == json.load(fb), name
                continue
            with reader(pa) as fa, reader(pb) as fb:
                assert sorted(fa.keys()) == sorted(fb.keys()), name
                for v in fa.keys():
                    if v in ("statistic", "climatology"):
                        assert fa.coord(v).tolist() == fb.coord(v).tolist()
                        continue
                    got, want = fa.read(v), fb.read(v)
                    assert got.dtype.kind == want.dtype.kind, (name, v)
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{name} {v}")


# ---------------------------------------------------------------- files

def test_port_writes_netcdf3_and_jax_writes_netcdf4(cerra):
    port_file = os.path.join(cerra["port"][0], "1990", "1990001.nc")
    jax_file = os.path.join(cerra["jax"][0], "1990", "1990001.nc")
    assert is_netcdf3(port_file) and not is_netcdf3(jax_file)


def test_reader_reads_the_same_arrays_from_netcdf4_and_netcdf3(cerra):
    """The port's reader: every file of the JAX writer's NetCDF4 tree and
    of the port writer's NetCDF3 tree holds the same arrays, and a
    slab read equals the slab of a whole read."""
    _trees_equal(cerra["port"], cerra["jax"], NetCDFFile)
    sel = {-2: slice(3, 11), -1: slice(2, 7)}
    for side in ("port", "jax"):
        path = os.path.join(cerra[side][0],
                            "CERRA_climatology_pixels_train.nc")
        with NetCDFFile(path) as f:
            np.testing.assert_array_equal(f.read("t2m", sel=sel),
                                          f.read("t2m")[..., 3:11, 2:7])
            assert f.label_indices("climatology", ["std"]).tolist() == [1]
            assert f.range_slice("week", 3, 5) == slice(2, 5)


@pytest.mark.parametrize("family", ["CERRA", "ERA5_Land"])
def test_fake_writer_matches_jax(cerra, era5, family):
    """One seed: the port's NetCDF3 writer and the JAX writer give the same
    arrays, read back by the JAX reader."""
    from idee_tpu.data.netcdf import NetCDFFile as JaxNetCDF

    trees = cerra if family == "CERRA" else era5
    _trees_equal(trees["port"], trees["jax"], JaxNetCDF)


def test_structured_writer_matches_jax(tmp_path):
    from idee_tpu.data.fake import write_structured_reanalysis as jax_write
    from idee_tpu.data.netcdf import NetCDFFile as JaxNetCDF

    kw = dict(years=("1989", "1990"), height=24, width=32, seed=1,
              write_climatology=True)
    info = {}
    for side, write in (("port", write_structured_reanalysis),
                        ("jax", jax_write)):
        info[side] = write(str(tmp_path / side / "main"),
                           str(tmp_path / side / "noaa"), **kw)
    assert info["port"] == info["jax"]
    assert info["port"]["drought_rate_valid"] > 0
    _trees_equal([str(tmp_path / "port" / d) for d in ("main", "noaa")],
                 [str(tmp_path / "jax" / d) for d in ("main", "noaa")],
                 JaxNetCDF)


def test_convert_synthetic_matches_jax(tmp_path):
    from idee_tpu.data.convert import convert_synthetic as jax_convert
    from idee_tpu.data.fake import make_fake_cube, write_fake_netcdf

    root = tmp_path / "synthetic_fake"
    write_fake_netcdf(str(root), make_fake_cube(n_vars=3, n_time=12,
                                                height=8, width=8, seed=2))
    got = np.load(convert_synthetic(str(root), str(tmp_path / "port.npz")),
                  allow_pickle=True)
    want = np.load(jax_convert(str(root), str(tmp_path / "jax.npz")),
                   allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "stats":
            assert got[k].item() == want[k].item()
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


# ---------------------------------------------------------------- index

@pytest.mark.parametrize("delta_t,skip", [
    (4, {}), (8, {}), (4, {1990: (40, 52), 1991: (1, 17)})])
def test_build_week_index_matches_jax(cerra, delta_t, skip):
    from idee_tpu.data.reanalysis import build_week_index as jax_index

    main, noaa = cerra["port"]
    years = ["1991"] if not skip else list(YEARS)
    got = build_week_index(main, noaa, years, delta_t, skip)
    want = jax_index(main, noaa, years, delta_t, skip)
    assert len(got) == len(want)
    for (gm, gn, gw), (wm, wn, ww) in zip(got, want):
        assert gm == wm and gn == wn
        np.testing.assert_array_equal(gw, ww)
        assert gw.dtype == ww.dtype
    if not skip:
        # the rollover into 1990, and week 5's missing NOAA file
        assert got[0][2].tolist()[:2] == [1.0, 52.0]
        assert os.sep + "1990" + os.sep in got[0][0][1]
        assert 5.0 not in [g[2][0] for g in got]
        week6 = next(g for g in got if g[2][0] == 6.0)
        assert week6[1][1] == week6[1][0]


# ---------------------------------------------------------------- items

ITEM_CASES = {
    "global_norm": dict(is_norm=True, is_clima_scale=False),
    "climatology_norm": dict(is_norm=True, is_clima_scale=True),
    "raw": dict(is_norm=False),
    "augmented": dict(is_norm=True, is_clima_scale=False, is_aug=True,
                      seed=3),
    "window_2": dict(is_norm=True, is_clima_scale=False, window_size=2,
                     threshold=40.0),
    "crop_shuffle": dict(is_norm=True, is_clima_scale=True, x_min=2,
                         x_max=14, y_min=1, y_max=13, is_shuffle=True),
}


def _datasets(trees, family, cache_root=None, **kw):
    """(port dataset, JAX dataset) of the port's tree."""
    from idee_tpu.data import reanalysis as jr

    main, noaa = trees["port"]
    out = []
    for mod in (None, jr):
        spec = (cerra_spec(4) if mod is None else mod.cerra_spec(4)) \
            if family == "CERRA" else \
            (era5_land_spec("EUR-11", 4) if mod is None
             else mod.era5_land_spec("EUR-11", 4))
        spec.grid_height = spec.grid_width = 16
        cls = ReanalysisDataset if mod is None else mod.ReanalysisDataset
        args = dict(spec=spec, root_main=main, root_noaa=noaa, delta_t=4,
                    variables=list(VARS), years=["1991"], x_max=16,
                    y_max=16, cache_root=cache_root if mod is None else None)
        args.update(kw)
        out.append(cls(**args))
    return out


def _items_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(ITEM_CASES))
def test_dataset_items_match_jax_bit_for_bit(cerra, case):
    got_ds, want_ds = _datasets(cerra, "CERRA", **ITEM_CASES[case])
    assert len(got_ds) == len(want_ds) == 51
    for i in (0, 4, 17, 50) if case != "augmented" else range(12):
        _items_equal(got_ds[i], want_ds[i], f"{case} item {i}")


def test_era5_land_items_match_jax_bit_for_bit(era5):
    got_ds, want_ds = _datasets(era5, "ERA5_Land", is_norm=True,
                                is_clima_scale=False)
    # the land fraction's inverse: fractional sea
    assert 0 < got_ds.mask_water.mean() < 1
    for i in (0, 30):
        _items_equal(got_ds[i], want_ds[i], f"era5 item {i}")


def test_cache_matches_jax_cache_and_direct_path(cerra, tmp_path):
    from idee_tpu.data.convert import convert_reanalysis as jax_convert
    from idee_tpu.data.reanalysis import cerra_spec as jax_spec

    main, noaa = cerra["port"]
    crop = dict(alpha=0.5, x_max=16, y_max=16)
    spec = cerra_spec(4)
    spec.grid_height = spec.grid_width = 16
    got = convert_reanalysis(spec, main, noaa, list(YEARS), VARS,
                             str(tmp_path / "port"), **crop)
    jspec = jax_spec(4)
    jspec.grid_height = jspec.grid_width = 16
    want = jax_convert(jspec, main, noaa, list(YEARS), VARS,
                       str(tmp_path / "jax"), **crop)
    assert _files(got) == _files(want)
    for name in _files(want):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(os.path.join(got, name)),
                np.load(os.path.join(want, name)), err_msg=name)

    direct, _ = _datasets(cerra, "CERRA", is_norm=True, is_clima_scale=False)
    cached, jax_direct = _datasets(cerra, "CERRA", cache_root=got,
                                   is_norm=True, is_clima_scale=False)
    assert cached._cache is not None and direct._cache is None
    for i in (0, 3, 20, len(direct) - 1):
        _items_equal(cached[i], direct[i], f"cache item {i}")
        _items_equal(cached[i], jax_direct[i], f"cache vs jax item {i}")
    other, _ = _datasets(cerra, "CERRA", cache_root=got, alpha=0.7)
    assert other._cache is None  # alpha differs: the direct path


# ---------------------------------------------------------------- loader

def _batches(loader):
    return [{k: v.numpy().copy() for k, v in b.items()} for b in loader]


def test_loader_prefetch_and_workers_match_serial(cerra):
    ds, _ = _datasets(cerra, "CERRA", is_norm=True, is_clima_scale=False)
    serial = _batches(DataLoader(ds, 2, device="cpu", prefetch=0))
    assert len(serial) == 25
    for kw in (dict(prefetch=2), dict(workers=3), dict(workers=3,
                                                        prefetch=0)):
        got = _batches(DataLoader(ds, 2, device="cpu", **kw))
        assert len(got) == len(serial), kw
        for a, b in zip(got, serial):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(kw))
    # shuffled: the same order as the JAX loader's, epoch after epoch
    from idee_tpu.data.loader import DataLoader as JaxLoader

    items = [{"i": np.array([i])} for i in range(11)]
    for kw in (dict(prefetch=2), dict(workers=2)):
        want = JaxLoader(items, 2, shuffle=True, seed=5, prefetch=0)
        got = DataLoader(items, 2, device="cpu", shuffle=True, seed=5, **kw)
        for _ in range(2):
            assert ([b["i"].ravel().tolist() for b in got]
                    == [np.asarray(b["i"]).ravel().tolist() for b in want])


def test_loader_workers_keep_the_serial_augmentations(cerra):
    """With is_aug, the pool's batches hold the serial path's rotations and
    flips: the draws are made in index order, not on the pool's threads."""
    def batches(**kw):
        ds, _ = _datasets(cerra, "CERRA", is_aug=True, is_norm=False)
        return _batches(DataLoader(ds, 2, device="cpu", **kw))

    serial = batches(prefetch=0)
    for kw in (dict(prefetch=2), dict(workers=3), dict(workers=3,
                                                        prefetch=0)):
        got = batches(**kw)
        assert len(got) == len(serial), kw
        for a, b in zip(got, serial):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(kw))


def test_loader_stopped_early_leaves_no_thread_and_raises_errors(cerra):
    ds, _ = _datasets(cerra, "CERRA", is_norm=False)
    before = set(threading.enumerate())
    for kw in (dict(prefetch=1), dict(workers=2)):
        it = iter(DataLoader(ds, 1, device="cpu", **kw))
        next(it)
        it.close()  # what a for loop's break does to the generator
        assert set(threading.enumerate()) <= before, kw

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("item 2")
            return {"a": np.zeros(1)}

    for kw in (dict(prefetch=2), dict(workers=2)):
        with pytest.raises(KeyError, match="item 2"):
            list(DataLoader(Broken(), 1, device="cpu", **kw))
    assert set(threading.enumerate()) <= before


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_threaded_loader_on_card_matches_serial(cuda, tmp_path):
    """Batches staged by the prefetch thread or the worker pool (pinned
    memory, non_blocking copies on the thread's default stream) hold on the
    card the values of the serial CPU path, read after a step-like kernel
    on the consumer's stream. The port's tree only: no h5py needed."""
    main, noaa = str(tmp_path / "main"), str(tmp_path / "noaa")
    write_fake_reanalysis(main, noaa, years=YEARS, height=16, width=16,
                          seed=0)
    spec = cerra_spec(4)
    spec.grid_height = spec.grid_width = 16
    ds = ReanalysisDataset(spec, main, noaa, delta_t=4, variables=VARS,
                           years=["1991"], x_max=16, y_max=16)
    want = _batches(DataLoader(ds, 2, device="cpu", prefetch=0))
    for kw in (dict(prefetch=2), dict(workers=3)):
        got = []
        for b in DataLoader(ds, 2, device=cuda, **kw):
            b = {k: (v * 2.0) / 2.0 for k, v in b.items()}  # work on it
            got.append({k: v.cpu().numpy() for k, v in b.items()})
        assert len(got) == len(want), kw
        for a, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(a[k], w[k], err_msg=str(kw))
