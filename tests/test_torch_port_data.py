"""The port's data path (storage back ends, block loader, preprocessing,
SMILES synthesizer) against ``graphinvent_tpu.data`` on the same files.

Everything here is integer data: arrays, batches and files must be
byte-equal, so no tolerance is stated except for the float columns of
``train.csv`` (rtol 1e-12, the same numpy arithmetic on the same rows).
"""

import builtins
import importlib.util
import os
import shutil

import h5py
import numpy as np
import pytest

from graphinvent_tpu.config import preset as jax_preset
from graphinvent_tpu.data import loader as jloader
from graphinvent_tpu.data import preprocess as jpre

from graphinvent_tpu_torch.config import preset as port_preset
from graphinvent_tpu_torch.data import loader as ploader
from graphinvent_tpu_torch.data import preprocess as ppre
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.eval.properties import load_ts_properties_csv
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles

import _torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("nodes", "edges", "APDs")
SMILES = ["CC", "CCC", "CCO", "CC(C)C", "C1CC1", "OC1CC1", "NCCN", "CC#N",
          "CC=O", "CSC", "not-a-smiles", "CC(=O)N", "ClCCl", "C1CCOC1",
          "CC", "OCC", "C[N+](C)(C)C", "CC([O-])=O"]


def _write_smi(path, rows):
    with open(path, "w") as fh:
        fh.write("SMILES Name\n")
        for i, s in enumerate(rows):
            fh.write(f"{s} {i}\n")


def _two_dirs(tmp_path, rows=SMILES):
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        _write_smi(d / "train.smi", rows)
        dirs.append(str(d) + "/")
    return dirs


def _cfgs(jdir, pdir, **kw):
    return (jax_preset("GGNN", dataset_dir=jdir, job_type="preprocess", **kw),
            port_preset("GGNN", dataset_dir=pdir, job_type="preprocess",
                        device="cpu", **kw))


def _h5_arrays(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in NAMES}


def _port_arrays(path):
    with store.ReadStore(path) as src:
        return {k: np.asarray(src.arrays[k][:]) for k in NAMES}


def _assert_same_arrays(got, want):
    for k in NAMES:
        assert got[k].dtype == want[k].dtype == np.int8
        np.testing.assert_array_equal(got[k], want[k])


def _assert_same_props(got_csv, want_csv):
    got = load_ts_properties_csv(got_csv)
    want = load_ts_properties_csv(want_csv)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float),
                                   np.asarray(want[k], dtype=float),
                                   rtol=1e-12)


# --------------------------------------------------------------------------
# preprocessing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", ["h5", "npd"])
@pytest.mark.parametrize("group", [8, 1000])
def test_preprocessor_is_byte_equal_to_jax(tmp_path, suffix, group):
    jdir, pdir = _two_dirs(tmp_path)
    jcfg, pcfg = _cfgs(jdir, pdir, batch_size=group)
    jpre.Preprocessor(jcfg, jdir + "train.smi", is_training_set=True).run()
    out = ppre.Preprocessor(pcfg, pdir + "train.smi", is_training_set=True,
                            suffix=suffix).run()
    assert out == pdir + "train." + suffix
    assert store.backend_of(out) == {"h5": "hdf5", "npd": "npy"}[suffix]
    _assert_same_arrays(_port_arrays(out), _h5_arrays(jdir + "train.h5"))
    _assert_same_props(pdir + "train.csv", jdir + "train.csv")
    assert not os.path.exists(out + ".chunked")
    assert not os.path.exists(pdir + "index.restart")
    if suffix == "h5":
        # the final file is contiguous, as the reference resaves it
        with h5py.File(out, "r") as f:
            assert all(f[k].chunks is None for k in NAMES)


@pytest.mark.parametrize("suffix", ["h5", "npd"])
def test_restart_from_index_restart_is_byte_equal(tmp_path, monkeypatch,
                                                  suffix):
    jdir, pdir = _two_dirs(tmp_path)
    jcfg, pcfg = _cfgs(jdir, pdir, batch_size=8)
    jpre.Preprocessor(jcfg, jdir + "train.smi", is_training_set=True).run()
    want = _h5_arrays(jdir + "train.h5")

    orig = ppre.Preprocessor._routes
    state = {"n": 0}

    def crashing(self, start=0):
        for item in orig(self, start):
            if state["n"] >= 7:
                raise RuntimeError("simulated crash")
            state["n"] += 1
            yield item

    monkeypatch.setattr(ppre.Preprocessor, "_routes", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        ppre.Preprocessor(pcfg, pdir + "train.smi", True,
                          suffix=suffix).run()
    monkeypatch.setattr(ppre.Preprocessor, "_routes", orig)
    with open(pdir + "index.restart") as fh:
        last_mol, written = (int(x) for x in fh.read().split(","))
    assert 0 < last_mol <= 7 and written > 0
    assert os.path.exists(pdir + f"train.{suffix}.chunked")

    out = ppre.Preprocessor(pcfg, pdir + "train.smi", True,
                            suffix=suffix).run(restart=True)
    _assert_same_arrays(_port_arrays(out), want)
    _assert_same_props(pdir + "train.csv", jdir + "train.csv")
    assert not os.path.exists(pdir + "index.restart")


def test_preprocess_job_and_shards_match_jax(tmp_path):
    jdir, pdir = _two_dirs(tmp_path)
    for d in (jdir, pdir):
        _write_smi(d + "valid.smi", SMILES[:6])
        _write_smi(d + "test.smi", SMILES[6:])
    jcfg, pcfg = _cfgs(jdir, pdir, batch_size=8, preprocess_num_shards=3)
    jpre.preprocess_dataset(jcfg)
    ppre.preprocess_dataset(pcfg, suffix="npd")
    for name in ("train", "valid", "test"):
        _assert_same_arrays(_port_arrays(pdir + name + ".npd"),
                            _h5_arrays(jdir + name + ".h5"))
    _assert_same_props(pdir + "train.csv", jdir + "train.csv")
    assert (open(pdir + "preprocessing_params.csv").read()
            == open(jdir + "preprocessing_params.csv").read())
    assert sorted(os.listdir(pdir)) == sorted(
        n.replace(".h5", ".npd") for n in os.listdir(jdir))
    with pytest.raises(OSError, match="already exists"):
        ppre.preprocess_dataset(pcfg, suffix="h5")
    assert ppre.read_smiles_file(pdir + "train.smi") == SMILES


def test_multi_process_preprocessing_is_refused():
    """num_processes=2 outside a process group of 2 raises: the job would
    otherwise run alone and quietly (multi-process runs go through
    ``main``, tests/test_torch_port_multihost.py)."""
    cfg = port_preset("GGNN", device="cpu", num_processes=2)
    with pytest.raises(RuntimeError, match="group of 1"):
        ppre.preprocess_dataset(cfg)


# --------------------------------------------------------------------------
# storage back ends
# --------------------------------------------------------------------------

def _random_arrays(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"nodes": rng.integers(0, 2, (rows, 13, 8)).astype(np.int8),
            "edges": rng.integers(0, 2, (rows, 13, 13, 3)).astype(np.int8),
            "APDs": rng.integers(0, 5, (rows, 625)).astype(np.int8)}


@pytest.mark.parametrize("suffix", ["h5", "npd"])
def test_growable_store_resize_reopen_resave(tmp_path, suffix):
    arrays = _random_arrays(50)
    dims = {k: v.shape[1:] for k, v in arrays.items()}
    chunked = str(tmp_path / f"x.{suffix}.chunked")
    with store.GrowableStore(chunked, dims, capacity=16) as out:
        assert out.fresh and out.capacity == 16
        for k in NAMES:
            out.arrays[k][:16] = arrays[k][:16]
        out.resize(40)
        assert out.capacity == 40
        for k in NAMES:
            out.arrays[k][16:40] = arrays[k][16:40]
    with store.GrowableStore(chunked, dims, capacity=16, append=True) as out:
        assert not out.fresh and out.capacity == 40
        out.resize(64)
        for k in NAMES:
            out.arrays[k][40:50] = arrays[k][40:50]
        out.resize(50)
    final = str(tmp_path / f"x.{suffix}")
    store.resave(chunked, final)
    assert not os.path.exists(chunked)
    _assert_same_arrays(_port_arrays(final), arrays)


def test_both_back_ends_hold_byte_equal_arrays(tmp_path):
    arrays = _random_arrays(33, seed=1)
    store.write_arrays(str(tmp_path / "a.h5"), arrays)
    store.write_arrays(str(tmp_path / "a.npd"), arrays)
    assert os.path.isfile(tmp_path / "a.h5") and os.path.isdir(tmp_path / "a.npd")
    assert sorted(os.listdir(tmp_path / "a.npd")) == [
        "APDs.npy", "edges.npy", "nodes.npy"]
    _assert_same_arrays(_port_arrays(str(tmp_path / "a.h5")), arrays)
    _assert_same_arrays(_port_arrays(str(tmp_path / "a.npd")), arrays)
    # the JAX package reads the port's HDF5 file
    ds = jloader.HDFDataset(str(tmp_path / "a.h5"))
    np.testing.assert_array_equal(ds.apds[:], arrays["APDs"])
    ds.close()
    for suffix in ("h5", "npd"):
        pds = ploader.HDFDataset(str(tmp_path / f"a.{suffix}"))
        assert len(pds) == 33 and pds.backend == store.backend_of(pds.path)
        block = pds.read_block(3, 9, np.int8)
        np.testing.assert_array_equal(block["edges"], arrays["edges"][3:9])
        pds.close()
    assert store.find_dataset(str(tmp_path / "a")).endswith("a.h5")
    with pytest.raises(FileNotFoundError, match="preprocess"):
        store.find_dataset(str(tmp_path / "b"))


@pytest.mark.parametrize("path,backend", [
    ("d/train.h5", "hdf5"), ("d/train.h5.shard2", "hdf5"),
    ("d/train.h5.chunked", "hdf5"), ("d/train.npd", "npy"),
    ("d/train.npd.shard0.chunked", "npy"), ("d.h5/train.npd/", "npy"),
])
def test_backend_is_chosen_by_the_path(path, backend):
    assert store.backend_of(path) == backend


def test_unknown_path_and_missing_h5py_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="names no dataset back end"):
        store.backend_of("d/train.hdf")
    arrays = _random_arrays(4)
    store.write_arrays(str(tmp_path / "a.h5"), arrays)
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    assert not store.have_h5py() and store.default_suffix() == "npd"
    # a finished .h5 reads without h5py (data/hdf5.py); writes still need
    # it, and nothing falls through to the other back end
    _assert_same_arrays(_port_arrays(str(tmp_path / "a.h5")), arrays)
    with pytest.raises(ImportError, match="h5py is not installed"):
        store.write_arrays(str(tmp_path / "b.h5"), arrays)
    store.write_arrays(str(tmp_path / "b.npd"), arrays)
    _assert_same_arrays(_port_arrays(str(tmp_path / "b.npd")), arrays)
    monkeypatch.undo()
    assert store.have_h5py() and store.default_suffix() == "h5"


# --------------------------------------------------------------------------
# wire formats and the block loader
# --------------------------------------------------------------------------

def test_pack_rows_and_sparse_apds_match_jax():
    arrays = _random_arrays(20, seed=2)
    for k in ("nodes", "edges"):
        np.testing.assert_array_equal(ploader.pack_rows(arrays[k]),
                                      jloader.pack_rows(arrays[k]))
    rng = np.random.default_rng(3)
    apds = np.zeros((20, 625), np.int8)
    for r in range(20):
        cols = rng.choice(625, size=rng.integers(0, 6), replace=False)
        apds[r, cols] = rng.integers(1, 9, len(cols))
    for cap in (8, 5):
        got, want = ploader.sparse_apds(apds, cap), jloader.sparse_apds(apds, cap)
        assert got[0].dtype == np.uint16 and got[1].dtype == np.int8
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # overflow: any row above the cap -> None -> the dense wire
    assert ploader.sparse_apds(apds, 2) is None
    assert jloader.sparse_apds(apds, 2) is None
    assert ploader.sparse_apds(np.zeros((2, 70000), np.int8), 4) is None


LOADER_MODES = {
    "plain": {},
    "packed": {"packed": True},
    "sparse": {"packed": True, "apd_nnz": 8},
    "sparse-overflow": {"packed": True, "apd_nnz": 1},
    "unshuffled": {"shuffle": False, "packed": True, "apd_nnz": 8},
    "drop-last": {"drop_last": True},
    "shard-1-of-2": {"shard_index": 1, "num_shards": 2, "prefetch": False},
}


@pytest.mark.parametrize("mode", sorted(LOADER_MODES))
def test_block_loader_batches_are_byte_equal_to_jax(tmp_path, mode):
    arrays = _random_arrays(107, seed=4)
    # sparse targets with a few multi-action rows
    arrays["APDs"][:] = 0
    rng = np.random.default_rng(5)
    arrays["APDs"][np.arange(107), rng.integers(0, 625, 107)] = 1
    arrays["APDs"][::9, 7] += 2
    path = str(tmp_path / "train.h5")
    store.write_arrays(path, arrays)
    kw = LOADER_MODES[mode]
    jds, pds = jloader.HDFDataset(path), ploader.HDFDataset(path)
    # the port picks one APD wire for the whole dataset (the largest row,
    # 2 nonzeros here); the JAX loader picks it batch by batch, so where a
    # row overflows the port's batches are the JAX loader's dense ones
    jkw = dict(kw, apd_nnz=0) if mode == "sparse-overflow" else kw
    jl = jloader.BlockLoader(jds, 16, 40, seed=3, **jkw)
    pl = ploader.BlockLoader(pds, 16, 40, seed=3, **kw)
    assert len(pl) == len(jl)
    kinds = set()
    for epoch in (0, 5):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(jl)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            kinds.add(tuple(sorted(g)))
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_array_equal(g[k], w[k])
        if not kw.get("drop_last") and "shard_index" not in kw:
            # 107 rows in blocks of 40, 40, 27: remainder batches of 8, 8
            # and 11 rows, zero-padded and masked
            assert sorted(int(b["valid"].sum()) for b in got) == [
                8, 8, 11, 16, 16, 16, 16, 16]
    if mode == "sparse":
        assert kinds == {("apds_i", "apds_v", "edges_p", "nodes_p", "valid")}
    if mode == "sparse-overflow":      # rows with 2 nonzeros overflow cap 1
        assert kinds == {("apds", "edges_p", "nodes_p", "valid")}
        assert pl.apd_wire == "dense" and pds.max_apd_nnz() == 2
    jds.close()
    pds.close()


@pytest.mark.parametrize("cap,wire", [(3, "sparse"), (2, "dense")])
def test_one_apd_wire_for_every_batch_and_every_shard(tmp_path, cap, wire):
    """The wire is chosen once from the whole dataset's largest APD row
    (3 nonzeros, in one row of the last block, which only shard 1 reads):
    every batch of every epoch of both shards has that one layout."""
    arrays = _random_arrays(100, seed=8)
    arrays["APDs"][:] = 0
    arrays["APDs"][np.arange(100), np.arange(100) % 625] = 1
    arrays["APDs"][95, [7, 9]] = 2
    path = str(tmp_path / "train.npd")
    store.write_arrays(path, arrays)
    ds = ploader.HDFDataset(path)
    assert ds.max_apd_nnz() == 3
    want = ({"apds_i", "apds_v", "edges_p", "nodes_p", "valid"}
            if wire == "sparse" else {"apds", "edges_p", "nodes_p", "valid"})
    for shard in (0, 1):
        loader = ploader.BlockLoader(ds, 8, 20, seed=2, packed=True,
                                     apd_nnz=cap, shard_index=shard,
                                     num_shards=2)
        assert loader.apd_wire == wire
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            batches = list(loader)
            assert len(batches) == len(loader) > 0
            assert all(set(b) == want for b in batches)
    # unpacked, or without sparse slots, the wire is dense
    assert ploader.BlockLoader(ds, 8, 20, packed=True).apd_wire == "dense"
    ds.close()


def test_block_loader_reads_the_npy_back_end_the_same(tmp_path):
    arrays = _random_arrays(50, seed=6)
    for suffix in ("h5", "npd"):
        store.write_arrays(str(tmp_path / f"t.{suffix}"), arrays)
    a = ploader.HDFDataset(str(tmp_path / "t.h5"))
    b = ploader.HDFDataset(str(tmp_path / "t.npd"))
    for x, y in zip(ploader.BlockLoader(a, 8, 20, seed=1, packed=True),
                    ploader.BlockLoader(b, 8, 20, seed=1, packed=True)):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    a.close()
    b.close()
    with pytest.raises(ValueError, match="block_size"):
        ploader.BlockLoader(a, 8, 4)


def test_block_reader_errors_reach_the_consumer(tmp_path):
    arrays = _random_arrays(50, seed=7)
    store.write_arrays(str(tmp_path / "t.npd"), arrays)
    ds = ploader.HDFDataset(str(tmp_path / "t.npd"))
    calls = {"n": 0}
    real = ds.read_block

    def failing(start, end, dtype=np.float32):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk went away")
        return real(start, end, dtype)

    ds.read_block = failing
    with pytest.raises(OSError, match="disk went away"):
        list(ploader.BlockLoader(ds, 8, 20, seed=1))


# --------------------------------------------------------------------------
# the SMILES synthesizer
# --------------------------------------------------------------------------

def test_synthesizer_matches_the_jax_package_tool_and_preprocesses(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "synthesize_smiles_tool",
        os.path.join(ROOT, "tools", "synthesize_smiles.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    got = synthesize_smiles(60, 4, 13, seed=11)
    assert got == tool.synthesize(60, 4, 13, seed=11)
    assert got == synthesize_smiles(60, 4, 13, seed=11)      # seeded
    assert got != synthesize_smiles(60, 4, 13, seed=12)
    assert len(set(got)) == 60
    assert synthesize_smiles(20, 20, 30, seed=1, aromatic=True) \
        == tool.synthesize(20, 20, 30, seed=1, aromatic=True)
    # every molecule fits the GDB-13 configuration: one terminate target a
    # molecule survives preprocessing
    _write_smi(tmp_path / "train.smi", got)
    cfg = port_preset("GGNN", device="cpu", dataset_dir=str(tmp_path) + "/",
                      batch_size=1000)
    out = ppre.Preprocessor(cfg, str(tmp_path / "train.smi"), True,
                            suffix="npd").run()
    apds = _port_arrays(out)["APDs"]
    assert int(apds[:, -1].sum()) == 60
    shutil.rmtree(out)
