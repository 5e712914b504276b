"""Merges sharded preprocessing outputs.

Counterpart of the JAX package's ``tools/combine_hdfs.py`` (reference
tools/combine_HDFs.py:120-189): the preprocess job writes shard datasets
(``preprocess_num_shards`` / ``preprocess_shard_index``) and this merges
them through ``data/preprocess.combine_shards``.  The output takes the
back end its path names (``data/store.py``): ``train.h5`` is HDF5 and
needs ``h5py``, ``train.npd`` a directory of ``.npy`` arrays.  With
``--job-dir`` (a job dir whose input.csv holds the preprocessing config)
the training set's property CSV is recomputed over the merged dataset
and ``preprocessing_params.csv`` is written beside it.

    python -m graphinvent_tpu_torch.tools.combine_hdfs out.npd \\
        in.npd.shard0 in.npd.shard1 ... [--job-dir jobs/pre0]

The last line printed is one JSON object: the output and its rows.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.data.preprocess import (
    combine_shards, write_preprocessing_params_csv,
)


def combine(out: str, shards: Sequence[str],
            cfg: Optional[GraphInventConfig] = None) -> dict:
    """Merges ``shards`` into ``out``; a training set (``train.*``) with
    ``cfg`` also gets its property CSV and the dataset dir its
    ``preprocessing_params.csv``."""
    is_train = os.path.basename(os.path.normpath(out)).split(".")[0] == "train"
    combine_shards(list(shards), out, cfg=cfg, is_training_set=is_train)
    if cfg is not None and is_train:
        # shard runs skip the params CSV (preprocess.py, partial_run); the
        # merge completes the dataset, so later jobs can cross-check it
        write_preprocessing_params_csv(cfg)
    with store.ReadStore(out) as ds:
        rows = int(ds.arrays["nodes"].shape[0])
    return {"out": out, "backend": store.backend_of(out),
            "shards": len(shards), "rows": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("shards", nargs="+")
    ap.add_argument("--job-dir", default=None)
    args = ap.parse_args(argv)
    cfg = (GraphInventConfig.from_job_dir(args.job_dir)
           if args.job_dir else None)
    result = combine(args.out, args.shards, cfg)
    print(f"wrote {args.out}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
