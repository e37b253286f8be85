# ------------------------------------------------------------------
"""The host batch engine: a small C++/OpenMP library bound with ctypes
(counterpart of idee_tpu/native).

``datacube_engine.cpp`` holds two functions: ``synth_batch``, the
synthetic dataset's whole collated batch in one pass (window gather, time
flip, augmentation flips, label masks), and ``vhi_mask``, the VHI drought
threshold of the reanalysis label engine. It is compiled at first use by
the system ``g++``:

    g++ -O3 -fopenmp -shared -fPIC -std=c++17 \
        -o build/libdatacube_engine-<hash>.so datacube_engine.cpp

into ``native/build/`` (git-ignored); the file name carries a hash of the
source, so an edited source is rebuilt and a stale library never loaded.
A failed build or load raises with the compiler's output: there is no
fallback. Nothing is built at import time.

The numpy paths stay as the plain versions: a dataset's ``item`` plus
``data/loader.py::collate`` for ``synth_batch``, and
``data/reanalysis.py::vhi_drought_plain`` for ``vhi_mask``.
"""
# ------------------------------------------------------------------

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "datacube_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdatacube_engine-{digest}.so"


def build() -> float:
    """Compile the engine unless its library is built; returns the wall
    seconds it took (0 when it was built already). Raises with g++'s
    output when the build fails."""
    t0 = time.perf_counter()
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name and rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    """The engine's library, built and loaded at first use (once per
    process, also when the loader's threads ask together)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            i64 = ctypes.c_int64
            fp = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.synth_batch.argtypes = [fp, fp, fp, i64, i64, i64, i64, i64,
                                        i64p, u8p, u8p, i64,
                                        fp, fp, fp, fp, fp]
            lib.synth_batch.restype = None
            lib.vhi_mask.argtypes = [fp, fp, fp, i64, ctypes.c_float,
                                     ctypes.c_float, fp]
            lib.vhi_mask.restype = None
            lib.engine_version.restype = ctypes.c_int
            lib.engine_threads.restype = ctypes.c_int
            _lib = lib
        return _lib


def engine_threads() -> int:
    """The OpenMP threads one engine call runs on."""
    return int(_load().engine_threads())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _checked(a: np.ndarray, dtype, name: str, ndim: int) -> np.ndarray:
    if not (isinstance(a, np.ndarray) and a.dtype == dtype
            and a.ndim == ndim and a.flags["C_CONTIGUOUS"]):
        raise ValueError(f"{name}: want a C-contiguous {ndim}-d {dtype} "
                         f"array, got {getattr(a, 'dtype', type(a))} "
                         f"{getattr(a, 'shape', '')}")
    return a


def synth_batch(dynamic: np.ndarray, extreme: np.ndarray,
                anomaly: np.ndarray, base_idx: np.ndarray,
                flip_h: np.ndarray, flip_w: np.ndarray, delta_t: int
                ) -> Tuple[np.ndarray, ...]:
    """One collated synthetic batch (see datacube_engine.cpp): dynamic and
    anomaly [V, T, H, W], extreme [T, H, W], all C-contiguous float32;
    base_idx [B] int64 window starts, flip_h / flip_w [B] uint8. Returns
    x [B, V, 1, dt, H, W], mask_extreme, mask_extreme_loss [B, H, W],
    mask_extreme_loss_t [B, dt, H, W], mask_anomaly [B, V, dt, H, W]."""
    lib = _load()
    _checked(dynamic, np.float32, "dynamic", 4)
    _checked(anomaly, np.float32, "anomaly", 4)
    _checked(extreme, np.float32, "extreme", 3)
    V, T, H, W = dynamic.shape
    if anomaly.shape != dynamic.shape or extreme.shape != (T, H, W):
        raise ValueError(f"shapes {dynamic.shape}, {anomaly.shape}, "
                         f"{extreme.shape} do not agree")
    B = base_idx.shape[0]
    _checked(base_idx, np.int64, "base_idx", 1)
    for name, f in (("flip_h", flip_h), ("flip_w", flip_w)):
        if _checked(f, np.uint8, name, 1).shape != (B,):
            raise ValueError(f"{name}: want [{B}], got {f.shape}")
    dt = int(delta_t)
    if B and not (base_idx.min() >= 0 and base_idx.max() + dt <= T):
        raise ValueError(f"window starts {base_idx} out of [0, {T - dt}]")
    x = np.empty((B, V, 1, dt, H, W), np.float32)
    me = np.empty((B, H, W), np.float32)
    mel = np.empty((B, H, W), np.float32)
    mel_t = np.empty((B, dt, H, W), np.float32)
    ma = np.empty((B, V, dt, H, W), np.float32)
    fp = ctypes.c_float
    lib.synth_batch(
        _ptr(dynamic, fp), _ptr(extreme, fp), _ptr(anomaly, fp),
        V, T, H, W, dt, _ptr(base_idx, ctypes.c_int64),
        _ptr(flip_h, ctypes.c_uint8), _ptr(flip_w, ctypes.c_uint8), B,
        _ptr(x, fp), _ptr(me, fp), _ptr(mel, fp), _ptr(mel_t, fp),
        _ptr(ma, fp))
    return x, me, mel, mel_t, ma


def vhi_mask(vci: np.ndarray, tci: np.ndarray, cold: np.ndarray,
             alpha: float, threshold: float) -> np.ndarray:
    """The elementwise VHI drought core: 1 where alpha * vci + (1 - alpha)
    * tci < threshold and cold == 0, else 0 (a NaN compares false). All
    three C-contiguous float32 arrays of one shape."""
    lib = _load()
    for name, a in (("vci", vci), ("tci", tci), ("cold", cold)):
        _checked(a, np.float32, name, vci.ndim)
        if a.shape != vci.shape:
            raise ValueError(f"{name}: shape {a.shape} != {vci.shape}")
    out = np.empty_like(vci)
    fp = ctypes.c_float
    lib.vhi_mask(_ptr(vci, fp), _ptr(tci, fp), _ptr(cold, fp), vci.size,
                 float(alpha), float(threshold), _ptr(out, fp))
    return out
