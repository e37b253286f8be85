# ------------------------------------------------------------------
"""The port's host batch engine (idee_tpu_torch/native: the C++/OpenMP
``synth_batch`` and ``vhi_mask``, built by g++ at first use) against the
JAX package's engine (idee_tpu/native) and against the port's own numpy
versions.

Every comparison is exact: both engines run the same C++ on the same
float32 arrays, and the numpy versions do the same arithmetic.
  * ``SyntheticDataset.get_batch`` equals JAX's ``get_batch`` and the
    port's ``collate`` of items, augmentation off and on, with static
    layers and with a window mean (fractional masks);
  * the loader builds its batches with the engine: a shuffled epoch equals
    JAX's loader's, and a pool of workers or the prefetch thread keeps the
    serial batches and augmentations;
  * ``vhi_mask`` equals JAX's and ``data/reanalysis.py::vhi_drought_plain``
    with NaN and cold pixels; reanalysis items are the same with the
    engine and with the numpy version;
  * a failed build raises with g++'s output; wrong inputs raise.
"""
# ------------------------------------------------------------------

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from idee_tpu_torch import native
from idee_tpu_torch.data.fake import make_fake_cube, write_fake_reanalysis
from idee_tpu_torch.data.loader import DataLoader, collate
from idee_tpu_torch.data.reanalysis import (ReanalysisDataset, cerra_spec,
                                            vhi_drought_plain)
from idee_tpu_torch.data.synthetic import SyntheticDataset

torch.set_num_threads(1)

N_TIME = 30
CASES = {"plain": dict(is_aug=False),
         "augmented": dict(is_aug=True),
         "window_mean": dict(is_aug=True, window_size=2)}


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=5)


def _kw(cube, **over):
    kw = dict(cube=cube, times=(1, N_TIME), variables=cube.variables,
              variables_static=cube.variables_static, delta_t=8, seed=11,
              x_max=16, y_max=16)
    kw.update(over)
    return kw


class _ItemsOnly:
    """A dataset's item interface without get_batch: the loader collates
    its items."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def draw_aug(self):
        return self.ds.draw_aug()

    def item(self, i, aug):
        return self.ds.item(i, aug)


def _same(got, want, what):
    assert list(got) == list(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_get_batch_matches_jax_engine_and_collate(cube, case):
    from idee_tpu import native as jax_native
    from idee_tpu.data.fake import make_fake_cube as jax_cube
    from idee_tpu.data.synthetic import SyntheticDataset as JaxDataset

    assert jax_native.available()
    jcube = jax_cube(n_vars=3, n_time=N_TIME, height=16, width=16, seed=5)
    port = SyntheticDataset(**_kw(cube, **CASES[case]))
    items = SyntheticDataset(**_kw(cube, **CASES[case]))
    jx = JaxDataset(**_kw(jcube, **CASES[case]))
    assert port._static is not None
    for idx in ([0, 3, 7, 12], [20, 1, 1, 9, 22]):
        want = collate([items[i] for i in idx])
        got = port.get_batch(idx)
        _same(got, want, f"{case} collate {idx}")
        _same(got, jx.get_batch(idx), f"{case} jax {idx}")
    if case == "window_mean":
        assert 0 < np.mean((got["mask_anomaly"] > 0)
                           & (got["mask_anomaly"] < 1))


def test_loader_batches_match_the_jax_loader(cube):
    from idee_tpu.data.fake import make_fake_cube as jax_cube
    from idee_tpu.data.loader import DataLoader as JaxLoader
    from idee_tpu.data.synthetic import SyntheticDataset as JaxDataset

    jcube = jax_cube(n_vars=3, n_time=N_TIME, height=16, width=16, seed=5)
    got = DataLoader(SyntheticDataset(**_kw(cube, is_aug=True)), 3,
                     device="cpu", shuffle=True, seed=2, prefetch=0)
    want = JaxLoader(JaxDataset(**_kw(jcube, is_aug=True)), 3,
                     shuffle=True, seed=2, prefetch=0)
    for epoch in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == len(got) == 7
        for b, (g, w) in enumerate(pairs):
            assert sorted(g) == sorted(w)  # JAX's device_put sorts keys
            _same({k: v.numpy() for k, v in g.items()},
                  {k: np.asarray(w[k]) for k in g},
                  f"epoch {epoch} batch {b}")


@pytest.mark.parametrize("kw", [dict(workers=2), dict(workers=2, prefetch=0),
                                dict(prefetch=2)])
def test_loader_threads_keep_the_serial_batches(cube, kw):
    """The engine path under the prefetch thread or the worker pool gives
    the batches, augmentations included, of the serial item path."""
    def batches(dataset, **over):
        loader = DataLoader(dataset, 2, device="cpu", shuffle=True, seed=4,
                            **over)
        return [[{k: v.numpy() for k, v in b.items()} for b in loader]
                for _ in range(2)]

    want = batches(_ItemsOnly(SyntheticDataset(**_kw(cube, is_aug=True))),
                   prefetch=0)
    got = batches(SyntheticDataset(**_kw(cube, is_aug=True)), **kw)
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we) == 11
        for b, (g, w) in enumerate(zip(ge, we)):
            _same(g, w, f"{kw} epoch {e} batch {b}")


def test_concurrent_first_calls_agree(cube):
    """16 threads (more than this machine's cores) make a fresh dataset's
    first get_batch calls at once: each gets the serial batch of its
    indices and augmentations."""
    ds = SyntheticDataset(**_kw(cube, is_aug=True))
    ref = SyntheticDataset(**_kw(cube, is_aug=True))
    jobs = [([i % 23, (3 * i) % 23], [ds.draw_aug(), ds.draw_aug()])
            for i in range(16)]
    want = [collate([ref.item(i, a) for i, a in zip(idx, augs)])
            for idx, augs in jobs]
    start = threading.Barrier(16)

    def run(job):
        start.wait(timeout=30)
        return ds.get_batch(*job)

    with ThreadPoolExecutor(max_workers=16) as pool:
        got = list(pool.map(run, jobs, timeout=60))
    for n, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"job {n}")


def test_vhi_mask_matches_jax_and_the_numpy_version():
    from idee_tpu import native as jax_native

    rng = np.random.default_rng(3)
    vhi = rng.uniform(0, 100, (64, 80)).astype(np.float32)
    vhi[rng.random(vhi.shape) < 0.1] = np.nan
    vhi[:4, :4] = 35.0  # exactly at the threshold: no drought
    cold = rng.integers(0, 3, vhi.shape).astype(np.float32)  # 0, 1, 2
    cold_eq1 = np.ascontiguousarray(cold == 1, np.float32)
    got = native.vhi_mask(vhi, vhi, cold_eq1, 0.5, 35.0)
    np.testing.assert_array_equal(got, vhi_drought_plain(vhi, cold, 35.0))
    np.testing.assert_array_equal(
        got, jax_native.vhi_mask(vhi, vhi, cold_eq1, 0.5, 35.0))
    assert 0 < got.mean() < 1 and not got[:4, :4].any()
    # distinct VCI and TCI at another alpha, the raw cold mask
    tci = rng.uniform(0, 100, vhi.shape).astype(np.float32)
    np.testing.assert_array_equal(
        native.vhi_mask(vhi, tci, cold, 0.3, 26.0),
        jax_native.vhi_mask(vhi, tci, cold, 0.3, 26.0))


@pytest.fixture(scope="module")
def cerra_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_cerra")
    main, noaa = str(root / "main"), str(root / "noaa")
    write_fake_reanalysis(main, noaa, years=("1989", "1990"), height=16,
                          width=16, seed=0)
    return main, noaa


def test_reanalysis_items_with_the_engine_equal_the_numpy_version(
        cerra_tree, monkeypatch):
    spec = cerra_spec(4)
    spec.grid_height = spec.grid_width = 16

    def dataset():
        return ReanalysisDataset(
            spec, *cerra_tree, delta_t=4, variables=["al", "t2m", "tp"],
            years=["1990"], is_aug=True, x_max=16, y_max=16, seed=3)

    engine = dataset()
    engine_items = [engine[i] for i in range(6)]
    calls = []

    def plain(vci, tci, cold, alpha, thr):
        calls.append(1)
        return vhi_drought_plain(alpha * vci + (1 - alpha) * tci, cold,
                                 thr)

    monkeypatch.setattr(native, "vhi_mask", plain)
    plain_ds = dataset()
    for i, want in enumerate(engine_items):
        _same(plain_ds[i], want, f"item {i}")
    assert calls  # the numpy version ran
    assert 0 < np.mean([it["mask_extreme_loss"].mean()
                        for it in engine_items]) < 1


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "datacube_engine.cpp"
    bad.write_text("extern \"C\" int engine_version() { return }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build()
    assert not list((tmp_path / "build").iterdir())  # no half library


def test_engine_builds_into_the_package_and_rejects_bad_inputs(cube):
    native.build()
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert native.engine_threads() >= 1
    ds = SyntheticDataset(**_kw(cube))
    dyn, ext, anom = (np.ascontiguousarray(a, np.float32) for a in
                      (ds._dynamic, ds._extreme, ds._anomaly))
    flips = np.zeros(1, np.uint8)
    with pytest.raises(ValueError, match="dynamic"):
        native.synth_batch(dyn.astype(np.float64), ext, anom,
                           np.zeros(1, np.int64), flips, flips, 8)
    with pytest.raises(ValueError, match="out of"):
        native.synth_batch(dyn, ext, anom, np.array([N_TIME - 7]),
                           flips, flips, 8)
    with pytest.raises(ValueError, match="cold"):
        native.vhi_mask(dyn[0, 0], dyn[0, 0], dyn[0, :2], 0.5, 1.0)
