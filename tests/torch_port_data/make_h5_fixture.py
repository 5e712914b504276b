"""Writes the ``.h5`` fixture that the port's HDF5 reader is held to.

    JAX_PLATFORMS=cpu python tests/torch_port_data/make_h5_fixture.py

Seeded SMILES made the way ``chip_smoke.py`` phase 7 makes them
(``synthesize_smiles``, seed 7, 9-13 heavy atoms), preprocessed by the JAX
package's own ``Preprocessor`` at ``preset("GGNN")``'s chemistry (N=13,
GDB-13 atoms), so that phase 8's checkpoint fits the rows.  The file is
``ggnn_n13.h5`` (contiguous int8 ``nodes``, ``edges``, ``APDs``, as the
JAX package finishes every dataset) beside ``ggnn_n13.json``: each
array's shape, dtype and sha256 as ``h5py`` reads them, the rows and
bytes, and the ``h5py`` and HDF5 versions that wrote the file.  Needs
``h5py`` and the JAX package; no download.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from graphinvent_tpu.config import preset  # noqa: E402
from graphinvent_tpu.data.preprocess import Preprocessor  # noqa: E402
from graphinvent_tpu_torch.utils.synthetic import (  # noqa: E402
    synthesize_smiles,
)

N_MOLECULES, MIN_ATOMS, MAX_ATOMS, SEED = 140, 9, 13, 7
NAME = "ggnn_n13"


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        smi = os.path.join(tmp, "train.smi")
        with open(smi, "w") as fh:
            fh.write("SMILES\n" + "\n".join(synthesize_smiles(
                N_MOLECULES, MIN_ATOMS, MAX_ATOMS, seed=SEED)) + "\n")
        cfg = preset("GGNN", dataset_dir=tmp + "/")
        out = Preprocessor(cfg, smi, is_training_set=True).run()
        h5 = os.path.join(HERE, NAME + ".h5")
        shutil.copy(out, h5)
    with h5py.File(h5, "r") as f:
        arrays = {name: {"shape": list(f[name].shape),
                         "dtype": str(f[name].dtype),
                         "sha256": sha256(f[name][()]),
                         "contiguous": f[name].chunks is None}
                  for name in ("nodes", "edges", "APDs")}
    manifest = {
        "file": NAME + ".h5", "bytes": os.path.getsize(h5),
        "rows": arrays["nodes"]["shape"][0], "arrays": arrays,
        "source": {"smiles": "graphinvent_tpu_torch.utils.synthetic."
                             "synthesize_smiles", "n": N_MOLECULES,
                   "min_atoms": MIN_ATOMS, "max_atoms": MAX_ATOMS,
                   "seed": SEED, "writer": "graphinvent_tpu.data.preprocess"
                   ".Preprocessor at preset('GGNN')"},
        "h5py": h5py.__version__, "hdf5": h5py.version.hdf5_version}
    with open(os.path.join(HERE, NAME + ".json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
        fh.write("\n")
    return manifest


if __name__ == "__main__":
    print(json.dumps(main()))
