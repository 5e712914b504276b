"""The on-disk format of a preprocessed dataset, behind one interface.

A dataset is three int8 arrays, ``nodes`` (R, N, Fn), ``edges``
(R, N, N, E) and ``APDs`` (R, dim_apd).  Two back ends hold them:

* ``hdf5``: one HDF5 file with those three datasets, the reference's and
  the JAX package's layout (``train.h5``).  A finished file is read by
  ``data/hdf5.py`` on numpy alone, on every machine; ``h5py`` writes it,
  and reads and writes the growable ``.chunked`` store of preprocessing;
* ``npy``: a directory (``train.npd``) of ``nodes.npy``, ``edges.npy`` and
  ``APDs.npy``, written with ``numpy.lib.format.open_memmap``, for machines
  without ``h5py``.

The back end is chosen by the path alone (:func:`backend_of`): ``.h5`` in
the file name means hdf5, ``.npd`` means npy.  A write to a ``.h5`` path
without ``h5py`` raises, and so does a finished ``.h5`` whose datasets are
chunked or compressed; nothing falls through to the other back end or to
``h5py``.  Every other module of the port goes through this one and
imports no ``h5py`` itself.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Mapping, Tuple

import numpy as np
from numpy.lib.format import open_memmap

from graphinvent_tpu_torch.data import hdf5

NAMES = ("nodes", "edges", "APDs")
SUFFIXES = {"hdf5": "h5", "npy": "npd"}


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "this dataset path is an HDF5 file and h5py is not installed; "
            "preprocess into a '.npd' directory of .npy arrays instead") \
            from exc
    return h5py


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def backend_of(path: str) -> str:
    """``"hdf5"`` or ``"npy"`` from the path's name (shard and ``.chunked``
    suffixes may follow the extension)."""
    parts = os.path.basename(os.path.normpath(path)).split(".")[1:]
    if "h5" in parts:
        return "hdf5"
    if "npd" in parts:
        return "npy"
    raise ValueError(f"{path!r} names no dataset back end: expected '.h5' "
                     "(HDF5) or '.npd' (directory of .npy arrays)")


def default_suffix() -> str:
    """The extension new datasets get here: ``h5`` where ``h5py`` imports,
    else ``npd``."""
    return SUFFIXES["hdf5" if have_h5py() else "npy"]


def find_dataset(stem: str) -> str:
    """The existing dataset ``<stem>.h5`` or ``<stem>.npd``; HDF5 first."""
    for suffix in SUFFIXES.values():
        if os.path.exists(f"{stem}.{suffix}"):
            return f"{stem}.{suffix}"
    raise FileNotFoundError(f"no dataset {stem}.h5 or {stem}.npd "
                            "(run the preprocess job first)")


def remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

class ReadStore:
    """The three arrays of a finished dataset as read-only memmaps,
    sliceable without loading them whole.  One read path for either back
    end on every machine: a ``.h5`` file through ``data/hdf5.py``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.backend = backend_of(path)
        if self.backend == "hdf5":
            found = hdf5.read_datasets(path)
            missing = [name for name in NAMES if name not in found]
            if missing:
                raise ValueError(f"{path} holds no dataset {missing[0]!r} "
                                 f"(found {sorted(found)})")
            arrays = {name: found[name] for name in NAMES}
        else:
            arrays = {name: np.load(os.path.join(path, name + ".npy"),
                                    mmap_mode="r") for name in NAMES}
        self.arrays: Dict[str, np.ndarray] = arrays

    def close(self) -> None:
        self.arrays = {}

    def __enter__(self) -> "ReadStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

class GrowableStore:
    """Row-growable int8 arrays for the preprocessing pass.  ``dims`` gives
    each array's row shape; ``append=True`` reopens an existing store
    (restart), and ``fresh`` then says whether it held no arrays yet."""

    def __init__(self, path: str, dims: Mapping[str, Tuple[int, ...]],
                 capacity: int, append: bool = False) -> None:
        self.path = path
        self.dims = {name: tuple(dims[name]) for name in NAMES}
        self.backend = backend_of(path)
        if self.backend == "hdf5":
            self._file = _h5py().File(path, "a" if append else "w")
            self.fresh = "nodes" not in self._file
            if self.fresh:
                self.arrays = {name: self._file.create_dataset(
                    name, (capacity, *self.dims[name]), chunks=True,
                    dtype=np.int8, maxshape=(None, *self.dims[name]))
                    for name in NAMES}
            else:
                self.arrays = {name: self._file[name] for name in NAMES}
        else:
            self._file = None
            if not append and os.path.isdir(path):
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
            self.fresh = not all(os.path.exists(self._npy(n)) for n in NAMES)
            if self.fresh:
                self.arrays = {name: open_memmap(
                    self._npy(name), mode="w+", dtype=np.int8,
                    shape=(capacity, *self.dims[name])) for name in NAMES}
            else:
                self.arrays = {name: open_memmap(self._npy(name), mode="r+")
                               for name in NAMES}

    def _npy(self, name: str) -> str:
        return os.path.join(self.path, name + ".npy")

    @property
    def capacity(self) -> int:
        return int(self.arrays["nodes"].shape[0])

    def resize(self, rows: int) -> None:
        for name in NAMES:
            if self.backend == "hdf5":
                self.arrays[name].resize((rows, *self.dims[name]))
                continue
            old = self.arrays[name]
            tmp = self._npy(name) + ".tmp"
            new = open_memmap(tmp, mode="w+", dtype=np.int8,
                              shape=(rows, *self.dims[name]))
            keep = min(rows, old.shape[0])
            new[:keep] = old[:keep]
            new.flush()
            del old, new
            os.replace(tmp, self._npy(name))
            self.arrays[name] = open_memmap(self._npy(name), mode="r+")

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()
        else:
            for a in self.arrays.values():
                a.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
        self.arrays = {}

    def __enter__(self) -> "GrowableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_arrays(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """A finished dataset from in-memory arrays: int8, and unchunked
    (contiguous) in HDF5 as the reference resaves it
    (DataProcesser.py:147-165)."""
    if backend_of(path) == "hdf5":
        with _h5py().File(path, "w") as out:
            for name in NAMES:
                out.create_dataset(name, data=arrays[name], chunks=None,
                                   dtype=np.int8)
        return
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    for name in NAMES:
        np.save(os.path.join(path, name + ".npy"),
                np.asarray(arrays[name], np.int8))


def resave(chunked: str, final: str) -> None:
    """The growable store ``chunked`` rewritten as the finished dataset
    ``final``; ``chunked`` is removed."""
    if backend_of(chunked) == "hdf5":
        with _h5py().File(chunked, "r") as src:
            write_arrays(final, {name: src[name][:] for name in NAMES})
    else:
        write_arrays(final, {name: np.load(
            os.path.join(chunked, name + ".npy"), mmap_mode="r")
            for name in NAMES})
    remove(chunked)
