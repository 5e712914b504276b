"""Trains a QSAR activity classifier for RL scoring.

Counterpart of the JAX package's ``tools/train_qsar.py``.  The reference
ships a scikit-learn SVC pickled over RDKit ECFP4 fingerprints
(data/fine-tuning/qsar_model.pickle, constants.py:250-256); the in-repo
fingerprints hash differently, so activity models are trained here on
labelled SMILES:

    python -m graphinvent_tpu_torch.tools.train_qsar actives.smi \\
        inactives.smi out.pickle [--classifier logistic] [--device cuda|cpu]

and written as ``{"classifier_sv": model}``, the reference's pickle
layout, which ``eval/scoring.py`` loads.  ``logistic`` (the default here)
is ``eval/qsar.py``: trained in torch, predicting in numpy, so the pickle
scores on a machine without scikit-learn.  ``svc`` (the JAX tool's
default, an RBF SVC) has no port yet and raises (ROADMAP A 5).

The last line printed is one JSON object: molecules, actives, the
training accuracy and the output path.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import Optional, Sequence

import numpy as np

from graphinvent_tpu_torch.chem import mol_from_smiles
from graphinvent_tpu_torch.chem.fingerprint import bulk_fingerprints
from graphinvent_tpu_torch.data.preprocess import read_smiles_file
from graphinvent_tpu_torch.eval.qsar import fit_logistic


def fingerprints(path: str) -> np.ndarray:
    """Morgan fingerprints of the molecules of a .smi file that parse."""
    mols = []
    for smi in read_smiles_file(path):
        try:
            mols.append(mol_from_smiles(smi))
        except Exception:
            pass
    return bulk_fingerprints(mols)


def train(actives_path: str, inactives_path: str, out_path: str,
          classifier: str = "logistic", device: str = "cuda") -> dict:
    if classifier != "logistic":
        raise NotImplementedError(
            f"classifier {classifier!r} is not ported to PyTorch yet: an RBF "
            "SVC trained in torch is ROADMAP.md A 5; use 'logistic'")
    X_act = fingerprints(actives_path)
    X_inact = fingerprints(inactives_path)
    X = np.concatenate([X_act, X_inact])
    y = np.concatenate([np.ones(len(X_act)), np.zeros(len(X_inact))])
    model = fit_logistic(X, y, device=device)
    with open(out_path, "wb") as fh:
        pickle.dump({"classifier_sv": model}, fh)
    accuracy = float(np.mean(model.predict(X) == y))
    print(f"trained {classifier} on {len(X)} molecules ({len(X_act)} "
          f"active), wrote {out_path}")
    return {"classifier": classifier, "n": int(len(X)),
            "n_active": int(len(X_act)), "train_accuracy": accuracy,
            "out": out_path}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("actives")
    ap.add_argument("inactives")
    ap.add_argument("out")
    ap.add_argument("--classifier", default="logistic",
                    choices=["svc", "logistic"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    result = train(args.actives, args.inactives, args.out, args.classifier,
                   args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
