"""SMILES -> dataset preprocessing.

Counterpart of ``graphinvent_tpu/data/preprocess.py`` (reference
DataProcesser, DataProcesser.py:19-457): for every molecule, replay its
decoding route and write (nodes, edges, APD) int8 triples to the dataset's
three arrays.  As in the JAX package:

* duplicate subgraphs within a group are merged by *hashing* the graph
  bytes, first occurrence kept, their APDs summed;
* the route is one backward truncation sweep per molecule
  (chem/molgraph.py);
* ``num_shards``/``shard_index`` write shard files directly and
  ``combine_shards`` merges them (``preprocess_num_shards`` /
  ``preprocess_shard_index`` in the config);
* training-set properties (``train.csv``) are computed from the FINISHED
  dataset: full molecules are exactly the rows whose APD carries a
  terminate count, so the scan is exact, restart-proof and
  shard-merge-proof.

Restart uses the reference's ``index.restart`` + ``.chunked`` protocol
(util.py:387-476, DataProcesser.py:66-135).  Routes come from the Python
path (``chem/molgraph.decoding_route``); the native C++ route kernel of the
JAX package is not ported (ROADMAP.md).  Files go through
``data/store.py``: HDF5 where ``h5py`` is installed, a directory of .npy
arrays where it is not.  One process only.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphinvent_tpu_torch.chem.molgraph import decoding_route
from graphinvent_tpu_torch.chem.smiles import mol_from_smiles
from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.eval.properties import (
    graph_set_properties, merge_ts_properties, write_ts_properties_csv,
)


def read_smiles_file(path: str) -> List[str]:
    """Reads a .smi file; the first line may be a header containing
    'SMILES' (reference: parameters/load.py:10-26)."""
    with open(path) as fh:
        lines = [l.strip() for l in fh if l.strip()]
    if lines and "SMILES" in lines[0]:
        lines = lines[1:]
    return [l.split()[0] for l in lines]


def _csv_path(dataset_path: str) -> str:
    """``train.h5`` / ``train.npd`` -> ``train.csv``."""
    return dataset_path.rsplit(".", 1)[0] + ".csv"


class Preprocessor:
    """Writes ``<name>.<suffix>`` with the arrays ``nodes``/``edges``/
    ``APDs`` (int8), plus ``<name>.csv`` training-set properties when
    ``is_training_set``.  ``suffix`` (``h5`` or ``npd``) picks the storage
    back end; by default ``store.default_suffix()``."""

    def __init__(self, cfg: GraphInventConfig, smi_path: str,
                 is_training_set: bool = False,
                 shard_index: int = 0, num_shards: int = 1,
                 suffix: Optional[str] = None) -> None:
        self.cfg = cfg
        self.smi_path = smi_path
        self.is_training_set = is_training_set
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.h5_path = smi_path[:-3] + (suffix or store.default_suffix())
        if num_shards > 1:
            self.h5_path += f".shard{shard_index}"
        self.restart_path = os.path.join(
            os.path.dirname(smi_path) or ".", f"index.restart{shard_index}"
            if num_shards > 1 else "index.restart")

        smiles = read_smiles_file(smi_path)
        self.smiles = smiles[shard_index::num_shards]
        self.rng = random.Random(cfg.seed + shard_index)
        print(f"-- Preprocessing {os.path.basename(smi_path)} on the "
              f"Python route path (native kernel not ported) into "
              f"{os.path.basename(self.h5_path)} "
              f"({store.backend_of(self.h5_path)})", flush=True)

    # ------------------------------------------------------------------
    def _routes(self, start: int = 0):
        """Yields (molecule_idx, route); route is a list of
        (nodes, edges, apd).  Unparseable molecules are skipped."""
        cfg = self.cfg
        for idx in range(start, len(self.smiles)):
            try:
                mol = mol_from_smiles(
                    self.smiles[idx], kekulize_mol=not cfg.use_aromatic_bonds)
                route = list(decoding_route(mol, cfg, rng=self.rng))
            except Exception:
                continue
            if route:
                yield idx, route

    # ------------------------------------------------------------------
    def run(self, restart: bool = False) -> str:
        cfg = self.cfg
        chunked = self.h5_path + ".chunked"
        group_size = cfg.batch_size
        dims = {"nodes": cfg.dim_nodes, "edges": cfg.dim_edges,
                "APDs": (cfg.dim_apd,)}
        start_idx, written = 0, 0
        append = restart and os.path.exists(chunked)
        # arrays grow on demand
        with store.GrowableStore(chunked, dims, max(2 * group_size, 4096),
                                 append=append) as out:
            if not out.fresh:
                start_idx, written = self._read_restart()
            ds = out.arrays

            group: Dict[bytes, int] = {}
            g_nodes: List[np.ndarray] = []
            g_edges: List[np.ndarray] = []
            g_apds: List[np.ndarray] = []
            last_mol = start_idx

            def flush() -> None:
                nonlocal written, group, g_nodes, g_edges, g_apds, ds
                if not g_nodes:
                    return
                k = len(g_nodes)
                if written + k > out.capacity:
                    out.resize(max(2 * out.capacity, written + k))
                    ds = out.arrays
                ds["nodes"][written:written + k] = np.stack(g_nodes)
                ds["edges"][written:written + k] = np.stack(g_edges)
                # APD counts are summed in int16 and clipped into the int8
                # on-disk format (the loss renormalises targets anyway)
                ds["APDs"][written:written + k] = np.clip(
                    np.stack(g_apds), 0, 127).astype(np.int8)
                written += k
                group, g_nodes, g_edges, g_apds = {}, [], [], []
                out.flush()
                self._write_restart(last_mol, written)

            for idx, route in self._routes(start_idx):
                for nodes, edges, apd in route:
                    key = nodes.tobytes() + edges.tobytes()
                    pos = group.get(key)
                    if pos is None:
                        group[key] = len(g_nodes)
                        g_nodes.append(nodes)
                        g_edges.append(edges)
                        g_apds.append(apd.astype(np.int16))
                    else:
                        g_apds[pos] = g_apds[pos] + apd
                # flush only at molecule boundaries: index.restart points at
                # a molecule, so a mid-route flush could strand the tail of
                # a molecule's route on a crash.  Boundary-aligned groups
                # also make restarted runs byte-identical to fresh ones.
                last_mol = idx + 1
                if len(g_nodes) >= group_size:
                    flush()
            flush()
            out.resize(written)      # trim what the dedupe saved

        # resave unchunked (reference: DataProcesser.py:147-165)
        store.resave(chunked, self.h5_path)
        if os.path.exists(self.restart_path):
            os.remove(self.restart_path)
        # training-set properties from the finished dataset: exact whether
        # this run was fresh or restarted.  Shard runs skip it:
        # combine_shards recomputes over the merged file.
        if self.is_training_set and self.num_shards == 1:
            ts, _ = ts_properties_from_hdf(cfg, self.h5_path)
            if ts:
                write_ts_properties_csv(_csv_path(self.h5_path), ts)
        return self.h5_path

    # ------------------------------------------------------------------
    def _write_restart(self, last_mol: int, dataset_size: int) -> None:
        with open(self.restart_path, "w") as fh:
            fh.write(f"{last_mol}, {dataset_size}")

    def _read_restart(self) -> Tuple[int, int]:
        try:
            with open(self.restart_path) as fh:
                a, b = fh.read().split(",")
            return int(a), int(b)
        except (OSError, ValueError):
            return 0, 0


def ts_properties_from_hdf(cfg: GraphInventConfig, h5_path: str,
                           chunk: int = 8192) -> Tuple[Dict, int]:
    """-> (training-set property dict, n_molecules) computed from a finished
    dataset.  Full molecules are the rows whose APD carries a terminate
    count (apd[-1] >= 1): every decoding route ends at its full ordered
    graph with a terminate target, and the within-group dedupe *sums* APDs,
    so apd[-1] is the multiplicity of that full graph in the set.  Streamed
    in ``chunk``-row slices."""
    parts: List[Dict] = []
    weights: List[int] = []
    with store.ReadStore(h5_path) as src:
        apd_ds, node_ds, edge_ds = (src.arrays["APDs"], src.arrays["nodes"],
                                    src.arrays["edges"])
        n_rows = apd_ds.shape[0]
        for lo in range(0, n_rows, chunk):
            hi = min(lo + chunk, n_rows)
            counts = np.asarray(apd_ds[lo:hi, -1]).astype(np.int64)
            sel = np.nonzero(counts > 0)[0]
            if sel.size == 0:
                continue
            nodes = np.repeat(node_ds[lo:hi][sel].astype(np.float32),
                              counts[sel], axis=0)
            edges = np.repeat(edge_ds[lo:hi][sel].astype(np.float32),
                              counts[sel], axis=0)
            n_nodes = (nodes.sum(axis=2) > 0).sum(axis=1)
            parts.append(graph_set_properties(cfg, nodes, edges, n_nodes))
            weights.append(int(nodes.shape[0]))
    return merge_ts_properties(parts, weights), int(sum(weights))


def combine_shards(shard_paths: List[str], out_path: str,
                   cfg: Optional[GraphInventConfig] = None,
                   is_training_set: bool = False,
                   remove_shards: bool = False) -> str:
    """Merges shard datasets into one (reference tools/combine_HDFs.py:
    120-189).  With ``cfg`` and ``is_training_set``, also recomputes the
    training-set property CSV over the merged file."""
    arrays: Dict[str, List[np.ndarray]] = {name: [] for name in store.NAMES}
    for p in shard_paths:
        with store.ReadStore(p) as src:
            for name in arrays:
                arrays[name].append(np.asarray(src.arrays[name][:]))
    store.write_arrays(out_path, {name: np.concatenate(parts)
                                  for name, parts in arrays.items()})
    if remove_shards:
        for p in shard_paths:
            store.remove(p)
    if cfg is not None and is_training_set:
        ts, _ = ts_properties_from_hdf(cfg, out_path)
        if ts:
            write_ts_properties_csv(_csv_path(out_path), ts)
    return out_path


def write_preprocessing_params_csv(cfg: GraphInventConfig) -> None:
    """Writes ``preprocessing_params.csv`` into the dataset dir so later
    train/generate/test jobs can cross-check their featurization config
    (reference: util.write_preprocessing_parameters, util.py:493-518)."""
    keys = ("atom_types", "formal_charge", "imp_H", "chirality",
            "max_n_nodes", "use_aromatic_bonds", "use_chirality",
            "use_explicit_H", "ignore_H")
    me = cfg.to_dict()
    path = os.path.join(cfg.dataset_dir, "preprocessing_params.csv")
    with open(path, "w") as fh:
        for key in keys:
            value = me[key]
            if isinstance(value, tuple):
                value = list(value)
            fh.write(f"{key};{value}\n")


def _shard_plan(cfg: GraphInventConfig) -> Tuple[int, List[int]]:
    """-> (num_shards, shards this run writes): ``preprocess_num_shards``
    shards one after the other (then combined), or only
    ``preprocess_shard_index`` when set -- the reference's one shard per
    cluster job (tools/submit-split-preprocessing-supercloud.py:8-17)."""
    if cfg.num_processes > 1:
        raise NotImplementedError(
            "multi-process preprocessing is not ported to PyTorch yet (see "
            "ROADMAP.md, queue A: parallelism)")
    num_shards = cfg.preprocess_num_shards or 1
    if num_shards > 1 and cfg.preprocess_shard_index >= 0:
        return num_shards, [cfg.preprocess_shard_index]
    return num_shards, list(range(num_shards))


def preprocess_dataset(cfg: GraphInventConfig, restart: bool = False,
                       suffix: Optional[str] = None) -> None:
    """Preprocesses valid -> test -> train, in the reference's order and
    with its restart inference (Workflow.preprocess_phase,
    Workflow.py:294-353)."""
    suffix = suffix or store.default_suffix()
    num_shards, my_shards = _shard_plan(cfg)
    partial_run = num_shards > 1 and cfg.preprocess_shard_index >= 0
    paths = [
        (os.path.join(cfg.dataset_dir, "valid.smi"), False),
        (os.path.join(cfg.dataset_dir, "test.smi"), False),
        (os.path.join(cfg.dataset_dir, "train.smi"), True),
    ]
    if not restart:
        for smi, _ in paths:
            for known in store.SUFFIXES.values():
                h5 = smi[:-3] + known
                if os.path.exists(h5):
                    raise OSError(
                        f"{h5} already exists; delete it to re-preprocess "
                        "(reference: Workflow.py:298-309)")
    for smi, is_train in paths:
        if not os.path.exists(smi):
            continue
        h5 = smi[:-3] + suffix
        if restart and os.path.exists(h5) and \
                (num_shards > 1 or not os.path.exists(h5 + ".chunked")):
            # finished (and, if sharded, combined) in a previous run; the
            # unsharded check keeps the reference's crash-window semantics
            # (h5 + leftover .chunked => redo, Workflow.py:317-353)
            continue
        print(f"* Preprocessing {smi}"
              + (f" (shards {my_shards} of {num_shards})"
                 if num_shards > 1 else ""), flush=True)
        for shard in my_shards:
            p = Preprocessor(cfg, smi, is_training_set=is_train,
                             shard_index=shard, num_shards=num_shards,
                             suffix=suffix)
            if restart and os.path.exists(p.h5_path) \
                    and not os.path.exists(p.h5_path + ".chunked"):
                continue    # this shard finished in a previous run
            p.run(restart=restart)
        if num_shards > 1 and not partial_run:
            all_shards = [f"{h5}.shard{i}" for i in range(num_shards)]
            combine_shards(all_shards, h5, cfg=cfg,
                           is_training_set=is_train, remove_shards=True)
    if not partial_run:
        write_preprocessing_params_csv(cfg)
