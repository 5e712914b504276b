"""Block-shuffled input pipeline over a preprocessed dataset.

Counterpart of ``graphinvent_tpu/data/loader.py`` (reference
BlockDatasetLoader.py): sequential block reads from disk, shuffling *within*
a block (no random row reads, BlockDatasetLoader.py:11-63), in numpy:

* batches have a *fixed* shape (the last partial batch is zero-padded and
  carries a ``valid`` row mask);
* the two RNG streams are seeded ``(seed, epoch)`` for the block order and
  ``(seed + 1, epoch)`` for the rows within a block, so the batches are
  byte-equal to the JAX loader's;
* a ``shard_index / num_shards`` pair slices blocks round-robin;
* a background thread reads the next block while the current one is used;
* the packed wire ships APD targets sparse or dense for the whole dataset,
  decided once from its largest row (:meth:`HDFDataset.max_apd_nnz`), so
  every batch of every epoch has one layout.  The JAX loader decides batch
  by batch; the batches' losses are the same either way.

The files are opened through ``data/store.py`` (HDF5, or a directory of
.npy arrays).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from graphinvent_tpu_torch.data import store

SCAN_ROWS = 8192        # rows a read of HDFDataset.max_apd_nnz's scan


class HDFDataset:
    """Reads the three arrays written by preprocessing: ``nodes``,
    ``edges``, ``APDs`` (the reference's layout,
    BlockDatasetLoader.py:117-147), from either storage back end."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._store = store.ReadStore(path)
        self.backend = self._store.backend
        self.nodes = self._store.arrays["nodes"]
        self.edges = self._store.arrays["edges"]
        self.apds = self._store.arrays["APDs"]
        self.n_subgraphs = int(self.nodes.shape[0])
        self._max_apd_nnz: Optional[int] = None

    def __len__(self) -> int:
        return self.n_subgraphs

    def read_block(self, start: int, end: int,
                   dtype=np.float32) -> Dict[str, np.ndarray]:
        return {
            "nodes": np.asarray(self.nodes[start:end], dtype=dtype),
            "edges": np.asarray(self.edges[start:end], dtype=dtype),
            "apds": np.asarray(self.apds[start:end], dtype=dtype),
        }

    def max_apd_nnz(self) -> int:
        """The most nonzeros of any APD target row, scanned block by block
        through the memmap; computed once."""
        if self._max_apd_nnz is None:
            most = 0
            for lo in range(0, self.n_subgraphs, SCAN_ROWS):
                block = np.asarray(self.apds[lo:lo + SCAN_ROWS])
                most = max(most, int(np.count_nonzero(block, axis=1).max()))
            self._max_apd_nnz = most
        return self._max_apd_nnz

    def close(self) -> None:
        self._store.close()


def pack_rows(a: np.ndarray) -> np.ndarray:
    """0/1 int8 rows -> bitpacked uint8 ``(B, ceil(prod(shape[1:])/8))``.

    The streamed-training wire format: node and edge tensors are 0/1
    one-hots, so 8 entries a byte cut the host-to-device upload 8x.
    ``train.step.batch_arrays`` unpacks on the device."""
    B = a.shape[0]
    return np.packbits(np.ascontiguousarray(a).reshape(B, -1), axis=1)


def sparse_fits(n_cols: int, nnz: int, cap: int) -> bool:
    """Whether APD rows of ``n_cols`` columns with at most ``nnz`` nonzeros
    fit the sparse wire of ``cap`` slots (uint16 column indices)."""
    return n_cols <= np.iinfo(np.uint16).max and nnz <= cap


def sparse_apds(apds: np.ndarray, cap: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """APD target rows -> fixed-width (indices uint16, values int8) pairs,
    or None when any row carries more than ``cap`` nonzeros (or a column
    index does not fit uint16).

    APD rows are very sparse: a decoding step targets one action, plus the
    merges of duplicate subgraphs (DataProcesser.py:207-231).  On the
    device the rows are rebuilt by a scatter-add
    (``train.step.batch_arrays``), so padded (0, 0) slots add nothing and
    the loss is the dense wire's."""
    B, A = apds.shape
    nz_b, nz_j = np.nonzero(apds)
    counts = np.bincount(nz_b, minlength=B)
    if not sparse_fits(A, int(counts.max()) if len(nz_b) else 0, cap):
        return None
    idx = np.zeros((B, cap), np.uint16)
    val = np.zeros((B, cap), apds.dtype)
    pos = np.arange(len(nz_b)) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    idx[nz_b, pos] = nz_j
    val[nz_b, pos] = apds[nz_b, nz_j]
    return idx, val


class BlockLoader:
    """Iterates fixed-shape batches over an :class:`HDFDataset`."""

    def __init__(self, dataset: HDFDataset, batch_size: int,
                 block_size: int, shuffle: bool = True, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 drop_last: bool = False, prefetch: bool = True,
                 packed: bool = False, apd_nnz: int = 0) -> None:
        if block_size < batch_size:
            raise ValueError("block_size must be >= batch_size "
                             "(reference: BlockDatasetLoader.py:85)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.block_size = block_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.prefetch = prefetch
        # packed: yield the bitpacked wire format ("nodes_p"/"edges_p"
        # uint8 + int8 "apds") instead of float32 tensors; the steps
        # unpack on the device.
        # apd_nnz > 0 additionally ships APD targets sparse ("apds_i"/
        # "apds_v", see sparse_apds) where the whole dataset's largest row
        # fits apd_nnz slots, else dense: one layout for every batch.  The
        # scan covers every row, not this shard's, so every rank of a
        # multi-process job makes the same choice.
        self.packed = packed
        self.apd_nnz = apd_nnz
        self.apd_wire = "dense"
        if packed and apd_nnz > 0 and sparse_fits(
                int(dataset.apds.shape[1]), dataset.max_apd_nnz(), apd_nnz):
            self.apd_wire = "sparse"
        self._epoch = 0

    # ------------------------------------------------------------------
    def _my_blocks(self) -> list:
        n = len(self.dataset)
        n_blocks = (n + self.block_size - 1) // self.block_size
        blocks = [(b * self.block_size, min((b + 1) * self.block_size, n))
                  for b in range(n_blocks)]
        return blocks[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        total = 0
        for start, end in self._my_blocks():
            rows = end - start
            if self.drop_last:
                total += rows // self.batch_size
            else:
                total += (rows + self.batch_size - 1) // self.batch_size
        return total

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    # ------------------------------------------------------------------
    def _iter_blocks(self) -> Iterator[Dict[str, np.ndarray]]:
        blocks = self._my_blocks()
        rng = np.random.default_rng((self.seed, self._epoch))
        if self.shuffle:
            rng.shuffle(blocks)
        dtype = np.int8 if self.packed else np.float32
        if not self.prefetch or len(blocks) <= 1:
            for start, end in blocks:
                yield self.dataset.read_block(start, end, dtype)
            return
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = object()
        failure = []

        def worker() -> None:
            # a read error must not end the epoch early and quietly: it is
            # kept and raised again on the consumer's side
            try:
                for start, end in blocks:
                    q.put(self.dataset.read_block(start, end, dtype))
            except BaseException as exc:   # noqa: BLE001
                failure.append(exc)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed + 1, self._epoch))
        bs = self.batch_size
        for block in self._iter_blocks():
            rows = block["nodes"].shape[0]
            order = rng.permutation(rows) if self.shuffle else np.arange(rows)
            n_batches = rows // bs if self.drop_last \
                else (rows + bs - 1) // bs
            for k in range(n_batches):
                idx = order[k * bs:(k + 1) * bs]
                nodes = block["nodes"][idx]
                edges = block["edges"][idx]
                apds = block["apds"][idx]
                n_valid = len(idx)
                if n_valid < bs:   # zero-pad the remainder batch
                    pad = bs - n_valid
                    nodes = np.concatenate(
                        [nodes, np.zeros((pad,) + nodes.shape[1:], nodes.dtype)])
                    edges = np.concatenate(
                        [edges, np.zeros((pad,) + edges.shape[1:], edges.dtype)])
                    apds = np.concatenate(
                        [apds, np.zeros((pad,) + apds.shape[1:], apds.dtype)])
                valid = np.zeros(bs, np.float32)
                valid[:n_valid] = 1.0
                if self.packed:
                    out = {"nodes_p": pack_rows(nodes),
                           "edges_p": pack_rows(edges), "valid": valid}
                    if self.apd_wire == "sparse":
                        out["apds_i"], out["apds_v"] = sparse_apds(
                            apds, self.apd_nnz)
                    else:
                        out["apds"] = apds
                    yield out
                else:
                    yield {"nodes": nodes, "edges": edges, "apds": apds,
                           "valid": valid}
        self._epoch += 1
