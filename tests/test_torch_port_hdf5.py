"""The port's HDF5 reader (``data/hdf5.py``: numpy and the standard
library, no ``h5py``) against ``h5py`` on the CPU.

* the committed fixture (``tests/torch_port_data/ggnn_n13.h5``, written by
  the JAX package's ``Preprocessor``) matches its manifest through
  ``h5py`` and through the reader;
* files that the JAX package's preprocessing writes, and files that
  ``h5py`` writes directly at ``libver`` "earliest" and "latest" (v0 and v3
  superblocks, v1 and v2 object headers, continuation blocks, zero-row
  datasets, a 512-byte user block, 4-byte offsets, compact layouts, many
  links in a B-tree of symbol nodes) read byte-equal to ``h5py``'s read;
* chunked, compressed, external and non-int8 datasets, dense link storage
  and a bad checksum raise, the unsupported layouts with ``.npd`` in the
  message;
* with ``h5py`` hidden, the port's test job and one streamed train epoch
  on a JAX-written ``.h5`` give the NLLs and per-step losses of the JAX
  package's jobs on the same files (rtol 1e-4, atol 1e-5: the NLL step's
  and the restart trajectory's tolerances).
"""

import ast
import builtins
import hashlib
import json
import os

import h5py
import numpy as np
import pytest
import torch

import graphinvent_tpu.workflow as jworkflow
from graphinvent_tpu.config import GraphInventConfig as JaxConfig
from graphinvent_tpu.config import preset as jax_preset
from graphinvent_tpu.data import preprocess as jpre

import graphinvent_tpu_torch.workflow as pworkflow
from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.data import hdf5, store
from graphinvent_tpu_torch.data.loader import HDFDataset
from graphinvent_tpu_torch.main import main as port_main
from graphinvent_tpu_torch.models import build_model
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles
from graphinvent_tpu_torch.utils.weights import save_checkpoint

import _torch_port_util  # noqa: F401  (caps torch's threads)

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_port_data")
NAMES = ("nodes", "edges", "APDs")


def _h5py_read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f if isinstance(f[k], h5py.Dataset)}


def _assert_reads_like_h5py(path):
    got, want = hdf5.read_datasets(path), _h5py_read(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.int8
        assert got[k].shape == w.shape
        assert got[k].tobytes() == w.tobytes()
        assert not got[k].flags.writeable
    return got


def _sha256(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _hide_h5py(monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    assert not store.have_h5py()


# --------------------------------------------------------------------------
# the fixture
# --------------------------------------------------------------------------

def test_fixture_matches_its_manifest_through_h5py_and_the_reader(
        monkeypatch):
    with open(os.path.join(FIXTURES, "ggnn_n13.json")) as fh:
        manifest = json.load(fh)
    path = os.path.join(FIXTURES, manifest["file"])
    assert os.path.getsize(path) == manifest["bytes"] <= 2_500_000
    assert manifest["rows"] >= 1000 and manifest["h5py"] and manifest["hdf5"]
    cfg = jax_preset("GGNN")
    shapes = {"nodes": cfg.dim_nodes, "edges": cfg.dim_edges,
              "APDs": (cfg.dim_apd,)}
    want = manifest["arrays"]
    h5 = _h5py_read(path)
    _hide_h5py(monkeypatch)
    with store.ReadStore(path) as ds:
        for name in NAMES:
            for arr in (h5[name], ds.arrays[name]):
                assert list(arr.shape) == want[name]["shape"]
                assert str(arr.dtype) == want[name]["dtype"] == "int8"
                assert _sha256(arr) == want[name]["sha256"]
            assert tuple(want[name]["shape"][1:]) == tuple(shapes[name])
            assert want[name]["contiguous"]


# --------------------------------------------------------------------------
# byte-equal to h5py
# --------------------------------------------------------------------------

def test_jax_preprocess_files_read_byte_equal(tmp_path):
    data = str(tmp_path) + "/"
    smiles = synthesize_smiles(40, 3, 9, seed=5)
    for name, rows in (("train", smiles[:24]), ("valid", smiles[24:32]),
                       ("test", smiles[32:])):
        with open(data + name + ".smi", "w") as fh:
            fh.write("SMILES\n" + "\n".join(rows) + "\n")
    jpre.preprocess_dataset(jax_preset("GGNN", dataset_dir=data,
                                       preprocess_num_shards=2))
    for name in ("train", "valid", "test"):
        got = _assert_reads_like_h5py(data + name + ".h5")
        assert sorted(got) == sorted(NAMES) and len(got["nodes"]) > 0
        with h5py.File(data + name + ".h5", "r") as f:
            assert all(f[k].chunks is None for k in NAMES)
        with store.ReadStore(data + name + ".h5") as ds:
            assert all(isinstance(ds.arrays[k], np.memmap) for k in NAMES)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("userblock", [0, 512])
def test_h5py_files_read_byte_equal(tmp_path, libver, userblock):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "a.h5")
    kw = {"userblock_size": userblock} if userblock else {}
    with h5py.File(path, "w", libver=libver, **kw) as f:
        f.create_dataset("nodes", data=rng.integers(
            -128, 128, (37, 13, 8), dtype=np.int8), chunks=None)
        f.create_dataset("edges", data=rng.integers(
            -128, 128, (37, 13, 13, 3), dtype=np.int8), chunks=None)
        f.create_dataset("APDs", shape=(0, 625), dtype=np.int8)   # no rows
        f.create_dataset("scalar", data=np.int8(-5))
        f.create_group("group").create_dataset("x", data=np.ones(2, np.int8))
        # enough attributes to push messages into continuation blocks
        for k in range(30):
            f["nodes"].attrs[f"a{k}"] = np.arange(40)
            f.attrs[f"r{k}"] = "x" * 90
        f.create_dataset("late", data=np.full((5, 2), -3, np.int8))
    with open(path, "rb") as fh:
        head = fh.read(userblock + 9)
    assert head[userblock:userblock + 8] == hdf5.SIGNATURE
    assert head[userblock + 8] == (0 if libver == "earliest" else 3)
    got = _assert_reads_like_h5py(path)
    assert got["APDs"].shape == (0, 625) and got["scalar"].shape == ()
    assert "group" not in got and "x" not in got


def test_many_links_small_offsets_and_compact_layouts(tmp_path):
    rng = np.random.default_rng(4)
    many = str(tmp_path / "many.h5")
    with h5py.File(many, "w") as f:      # a B-tree over several SNODs
        for k in range(40):
            f.create_dataset(f"d{k:02d}", data=rng.integers(
                -128, 128, (k + 1, 3), dtype=np.int8))
    assert len(_assert_reads_like_h5py(many)) == 40

    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)                 # 4-byte offsets and lengths
    small = str(tmp_path / "small.h5")
    with h5py.File(h5py.h5f.create(small.encode(), h5py.h5f.ACC_TRUNC,
                                   fcpl=fcpl)) as f:
        f.create_dataset("nodes", data=np.arange(-50, 50, dtype=np.int8))
    _assert_reads_like_h5py(small)

    compact = str(tmp_path / "compact.h5")
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    with h5py.File(compact, "w") as f:
        ds = h5py.h5d.create(f.id, b"nodes", h5py.h5t.STD_I8LE,
                             h5py.h5s.create_simple((4, 2)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.arange(8, dtype=np.int8).reshape(4, 2))
    _assert_reads_like_h5py(compact)


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------

def _write_one(path, **kw):
    with h5py.File(path, "w") as f:
        f.create_dataset("nodes", **kw)


UNSUPPORTED = {
    "chunked": (dict(data=np.ones((10, 3), np.int8), chunks=(2, 3)),
                "chunked layout"),
    "gzip": (dict(data=np.ones((10, 3), np.int8), compression="gzip"),
             "filter pipeline"),
    "shuffle": (dict(data=np.ones((10, 3), np.int8), shuffle=True),
                "filter pipeline"),
    "uint8": (dict(data=np.ones((10, 3), np.uint8)), "not int8"),
    "int16": (dict(data=np.ones((10, 3), np.int16)), "not int8"),
    "float32": (dict(data=np.ones((10, 3), np.float32)), "not int8"),
    "external": (dict(shape=(4,), dtype=np.int8,
                      external=[("raw.bin", 0, 4)]), "external files"),
}


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
def test_unsupported_datasets_raise_naming_npd(tmp_path, kind):
    kw, what = UNSUPPORTED[kind]
    path = str(tmp_path / "x.h5")
    _write_one(path, **kw)
    with pytest.raises(hdf5.UnsupportedHDF5, match=what) as err:
        hdf5.read_datasets(path)
    assert ".npd" in str(err.value)
    with pytest.raises(ValueError, match=r"\.npd"):
        store.ReadStore(path)


def test_growable_restart_store_and_dense_links_raise(tmp_path):
    # the preprocessing pass's growable .chunked file is chunked
    chunked = str(tmp_path / "train.h5.chunked")
    dims = {"nodes": (13, 8), "edges": (13, 13, 3), "APDs": (625,)}
    with store.GrowableStore(chunked, dims, capacity=8) as out:
        out.arrays["nodes"][:2] = 1
    with pytest.raises(hdf5.UnsupportedHDF5, match=r"chunked.*\.npd"):
        store.ReadStore(chunked)
    dense = str(tmp_path / "dense.h5")
    with h5py.File(dense, "w", libver="latest") as f:
        for k in range(20):              # past 8 links: a fractal heap
            f.create_dataset(f"d{k}", data=np.ones(2, np.int8))
    with pytest.raises(hdf5.UnsupportedHDF5, match="dense storage"):
        hdf5.read_datasets(dense)


def test_bad_checksum_and_missing_arrays_raise(tmp_path):
    path = str(tmp_path / "a.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("nodes", data=np.ones(3, np.int8))
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF                      # inside the v3 superblock
    bad = str(tmp_path / "bad.h5")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        hdf5.read_datasets(bad)
    with pytest.raises(ValueError, match="no dataset 'edges'"):
        store.ReadStore(path)
    open(str(tmp_path / "empty.h5"), "wb").close()
    with pytest.raises(ValueError, match="empty file"):
        hdf5.read_datasets(str(tmp_path / "empty.h5"))


def test_lookup3_matches_the_reference_vectors():
    # lookup3.c's driver5 values for hashlittle
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    text = b"Four score and seven years ago"
    assert hdf5.lookup3(text) == 0x17770551
    assert hdf5.lookup3(text, 1) == 0xCD628161


def test_the_reader_imports_numpy_and_the_standard_library_only():
    src = open(hdf5.__file__).read()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "mmap", "struct", "typing", "numpy"}


# --------------------------------------------------------------------------
# jobs on a JAX-written .h5, without h5py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """Train / valid / test ``.h5`` files the JAX package's preprocess job
    wrote, at the tiny test config's chemistry."""
    data = str(tmp_path_factory.mktemp("jax_h5")) + "/"
    smiles = synthesize_smiles(84, 3, 9, seed=5)
    for name, lo, hi in (("train", 0, 60), ("valid", 60, 72),
                         ("test", 72, 84)):
        with open(data + name + ".smi", "w") as fh:
            fh.write("SMILES\n" + "\n".join(smiles[lo:hi]) + "\n")
    cfg = port_tiny("GGNN", device="cpu", job_type="preprocess",
                    dataset_dir=data, tensorboard_dir="", batch_size=32)
    os.makedirs(data + "pre")
    cfg.replace(job_dir=data + "pre/").write_csv(data + "pre/input.csv")
    jcfg = JaxConfig.from_job_dir(data + "pre").replace(job_dir=data + "pre/")
    jworkflow.Workflow(jcfg).run()
    assert all(os.path.exists(data + f"{n}.h5") for n in
               ("train", "valid", "test"))
    return data


def _recording(module, name, store_in):
    """``module.name`` wrapped so that each call's result is kept."""
    inner = getattr(module, name)

    def make(*a, **k):
        fn = inner(*a, **k)

        def run(*args, **kw):
            out = fn(*args, **kw)
            loss = out[-1] if isinstance(out, tuple) else out
            store_in.append(float(loss))
            return out
        return run
    return make


def _job_pair(root, data, job_type, **kw):
    """Port and JAX job dirs with one seeded model_restart_0.pth and one
    input.csv -> (port job, JAX job, port config)."""
    port, jax_job = os.path.join(root, "port"), os.path.join(root, "jax")
    cfg = port_tiny("GGNN", device="cpu", job_type=job_type,
                    dataset_dir=data, tensorboard_dir="", batch_size=32,
                    block_size=96, n_samples=40, **kw)
    model = build_model(cfg, torch.Generator().manual_seed(3))
    for job in (port, jax_job):
        os.makedirs(job)
        save_checkpoint(model, job, 0)
        cfg.replace(job_dir=job + "/").write_csv(
            os.path.join(job, "input.csv"))
    return port, jax_job


def _run_jax(job):
    jcfg = JaxConfig.from_job_dir(job).replace(job_dir=job + "/")
    jworkflow.Workflow(jcfg).run()


def test_streamed_train_epoch_on_a_jax_h5_without_h5py(jax_dataset,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    port, jax_job = _job_pair(str(tmp_path), jax_dataset, "train",
                              restart=True, epochs=1, sample_every=10,
                              device_data_gb=0.0)
    want = []
    monkeypatch.setattr(jworkflow, "make_train_step",
                        _recording(jworkflow, "make_train_step", want))
    _run_jax(jax_job)
    got = []
    with monkeypatch.context() as m:
        _hide_h5py(m)
        m.setattr(pworkflow, "make_train_step",
                  _recording(pworkflow, "make_train_step", got))
        w = port_main(["--job-dir", port])
    out = capsys.readouterr().out
    assert w.data_path == "streamed" and "(hdf5," in out
    assert "APD wire: train sparse, valid sparse" in out
    rows = len(HDFDataset(jax_dataset + "train.h5"))
    assert len(got) == len(want) == -(-rows // 32) and len(got) > 1
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_test_job_on_a_jax_h5_without_h5py(jax_dataset, tmp_path,
                                           monkeypatch):
    port, jax_job = _job_pair(str(tmp_path), jax_dataset, "test")
    want, got = [], []

    def recording(module, into):
        inner = module.streamed_random_nlls

        def run(*a, **k):
            out = inner(*a, **k)
            into.append(np.asarray(out))
            return out
        return run

    monkeypatch.setattr(jworkflow, "streamed_random_nlls",
                        recording(jworkflow, want))
    _run_jax(jax_job)
    with monkeypatch.context() as m:
        _hide_h5py(m)
        m.setattr(pworkflow, "streamed_random_nlls",
                  recording(pworkflow, got))
        port_main(["--job-dir", port])
    assert len(got) == len(want) == 2           # test rows, then train rows
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    lines = [open(os.path.join(j, "validation.log")).read().splitlines()[-1]
             for j in (port, jax_job)]
    assert [l.split(",")[0] for l in lines] == ["Test 0", "Test 0"]
