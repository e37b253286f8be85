# ------------------------------------------------------------------
"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library that ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``kernels/build/`` (git-ignored) at first use. Its
file name carries a hash of the source, so an edited source is rebuilt and
a stale library is never loaded. Nothing is built at import time: this
package also imports on machines with no CUDA toolkit.

``c_function`` loads one symbol of a library (building it at first use) and
``call`` runs it on the current stream of a tensor's card, raising when the
launch was refused; the kernel modules count their launches around it.
"""
# ------------------------------------------------------------------

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/"
                           "bin); the CUDA toolkit is needed to build the "
                           "kernels")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name and rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> float:
    """Compile the named sources, one nvcc per source, all started
    together. Returns the wall seconds until all were built."""
    t0 = time.perf_counter()
    jobs = [(n, _start_build(n)) for n in names]
    errors: List[str] = []
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def c_function(name: str, symbol: str, argtypes: Sequence):
    """``symbol`` of csrc/<name>.cu as a ctypes function returning the int
    error code (loaded, and built, at first use). Pointers and the stream
    are ``ctypes.c_void_p``: a plain int would be cut to 32 bits."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def call(fn, kernel: str, device: torch.device, args: Sequence) -> None:
    """Run the C launcher ``fn`` on the current stream of ``device``:
    tensors in ``args`` pass as their data pointers (they must be
    contiguous), None as NULL, numbers as they are; the stream is the last
    argument. Raises when the launch was refused.

    A launch costs microseconds of host time, as much as a small kernel
    runs: the stream is read as a raw handle (no ``torch.cuda.Stream`` is
    built) and the device is switched only when it is not the current
    one."""
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_contiguous():
                raise ValueError(f"{kernel}: inputs must be contiguous")
            a = a.data_ptr()
        ptrs.append(a)
    # the card's context exists: a tensor lies on it
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*ptrs, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
