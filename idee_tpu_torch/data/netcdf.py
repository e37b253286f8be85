# ------------------------------------------------------------------
"""Minimal NetCDF reader (the port's copy of idee_tpu/data/netcdf.py):
NetCDF4 (HDF5) through h5py, NetCDF3-classic and 64-bit-offset through
scipy.io.netcdf_file, dispatched on the file magic.

NetCDF4 files are HDF5 files with named datasets and dimension-scale
coordinates; classic NetCDF3 files are covered by scipy's pure-python
reader. Both back ends expose the same interface: read variables by name,
decode string coordinates, label-select along coordinates. h5py is
optional: without it only NetCDF3 files open.
"""
# ------------------------------------------------------------------

from typing import Dict, List, Optional, Sequence

import numpy as np

try:
    import h5py

    HAS_H5PY = True
except ImportError:  # NetCDF3 files still open through scipy
    HAS_H5PY = False


def _require_h5py():
    if not HAS_H5PY:
        raise ImportError(
            "h5py is required to read NetCDF4 files; install h5py or write "
            "the data as NetCDF3 (idee_tpu_torch.data.fake writes NetCDF3)")


def _decode(arr) -> np.ndarray:
    """Decode bytes/object string arrays to python str."""
    arr = np.asarray(arr)
    if arr.dtype.kind in ("S", "O"):
        return np.array([
            v.decode() if isinstance(v, bytes) else str(v) for v in arr.ravel()
        ]).reshape(arr.shape)
    return arr


def is_netcdf3(path: str) -> bool:
    """'CDF\\x01' / 'CDF\\x02' = classic / 64-bit-offset NetCDF3;
    '\\x89HDF' = NetCDF4 (HDF5)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    return magic[:3] == b"CDF"


class _NC3Backend:
    """scipy.io.netcdf_file adapter with the h5py-backend interface.

    NetCDF3 stores string coordinates as [n, strlen] char arrays; get()
    joins them back to python strings.
    """

    def __init__(self, path: str):
        from scipy.io import netcdf_file

        self._f = netcdf_file(path, "r", mmap=True)

    def close(self):
        self._f.close()

    def keys(self):
        return list(self._f.variables.keys())

    def __contains__(self, name):
        return name in self._f.variables

    def get(self, name):
        v = self._f.variables[name]
        data = np.asarray(v[:])
        if data.dtype.kind == "S" and data.ndim >= 2:
            # char matrix -> string vector
            data = np.array([b"".join(row).decode().rstrip("\x00 ").strip()
                             for row in data.reshape(-1, data.shape[-1])])
        return data


class NetCDFFile:
    """Read-only view of a NetCDF4/HDF5 or NetCDF3 file."""

    def __init__(self, path: str):
        self._nc3 = is_netcdf3(path)
        if self._nc3:
            self._f = _NC3Backend(path)
        else:
            _require_h5py()
            self._f = h5py.File(path, "r")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._f.close()

    def keys(self) -> List[str]:
        return list(self._f.keys())

    def has(self, name: str) -> bool:
        return name in self._f

    def coord(self, name: str) -> np.ndarray:
        if self._nc3:
            # a copy: a view would hold the file's mmap open
            return np.array(_decode(self._f.get(name)))
        return _decode(self._f[name][()])

    def read(self, name: str, sel: Optional[Dict[int, object]] = None
             ) -> np.ndarray:
        """Read dataset ``name``; ``sel`` maps axis -> (slice | index
        array)."""
        data = self._f.get(name) if self._nc3 else self._f[name]
        if not sel:
            # scipy's mmap arrays are read-only views: copy
            return np.array(data) if self._nc3 else data[()]
        index = [slice(None)] * data.ndim
        fancy_axes = []
        for ax, s in sel.items():
            if isinstance(s, slice):
                index[ax] = s
            else:
                fancy_axes.append((ax, np.asarray(s)))
        data = data[tuple(index)]
        for ax, idx in fancy_axes:  # fancy indexing after the load
            data = np.take(data, idx, axis=ax)
        return np.array(data)

    def label_indices(self, coord_name: str, labels: Sequence) -> np.ndarray:
        """Indices of ``labels`` along a coordinate (xarray .sel semantics)."""
        coord = self.coord(coord_name)
        lut = {v: i for i, v in enumerate(coord.tolist())}
        return np.array([lut[l] for l in labels], dtype=np.int64)

    def range_slice(self, coord_name: str, lo, hi) -> slice:
        """Contiguous slice where lo <= coord <= hi (xarray slice .sel)."""
        coord = np.asarray(self.coord(coord_name))
        idx = np.nonzero((coord >= lo) & (coord <= hi))[0]
        if idx.size == 0:
            return slice(0, 0)
        return slice(int(idx[0]), int(idx[-1]) + 1)
