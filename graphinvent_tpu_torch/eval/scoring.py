"""RL scoring function.

Counterpart of ``graphinvent_tpu/eval/scoring.py`` (reference
ScoringFunction.py:14-192): components ``target_size={n}``, ``QED`` and
``{name}_activity`` (a pickled QSAR model's ``predict_proba`` over Morgan
fingerprints), combined either as a product ("continuous") or a
thresholded binary AND ("binary"); non-unique, invalid or improperly
terminated molecules score 0.

QED always takes the pure-Python ``chem.descriptors.qed`` (the JAX package
has a native C++ batch as well, byte-identical to it, not ported yet), so
scores equal the JAX package's exactly.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from graphinvent_tpu_torch.chem.descriptors import qed
from graphinvent_tpu_torch.chem.fingerprint import bulk_fingerprints
from graphinvent_tpu_torch.config import GraphInventConfig


class ScoringFunction:
    def __init__(self, cfg: GraphInventConfig) -> None:
        self.score_components = list(cfg.score_components)
        self.score_type = cfg.score_type
        self.score_thresholds = list(cfg.score_thresholds)
        self.max_n_nodes = cfg.max_n_nodes
        if len(self.score_components) != len(self.score_thresholds):
            raise ValueError("score_components and score_thresholds mismatch")
        self.qsar_models: Dict[str, object] = {}
        needed = {c for c in self.score_components if "activity" in c}
        for name, path in (cfg.qsar_models or {}).items():
            if name not in needed:
                continue
            if not (isinstance(path, str) and os.path.exists(path)):
                # hard-fail like the reference's import-time pickle load
                # (parameters/constants.py:250-256): a silent zero here would
                # zero the whole binary reward and fine-tune nothing
                raise FileNotFoundError(
                    f"QSAR model for score component {name!r} not found at "
                    f"{path!r} (set qsar_models in the config)")
            with open(path, "rb") as fh:
                model = pickle.load(fh)
            if isinstance(model, dict) and "classifier_sv" in model:
                model = model["classifier_sv"]   # reference pickle layout
            self.qsar_models[name] = model
        missing = needed - set(self.qsar_models)
        if missing:
            raise FileNotFoundError(
                f"score component(s) {sorted(missing)} have no entry in "
                f"qsar_models (reference: constants.py:250-256)")

    # ------------------------------------------------------------------
    def compute_score(self, graphs: Sequence, termination: np.ndarray,
                      validity: np.ndarray, uniqueness: np.ndarray
                      ) -> np.ndarray:
        contributions = self._contributions(graphs)
        if len(contributions) == 1:
            final = contributions[0].astype(np.float64)
        elif self.score_type == "continuous":
            final = contributions[0].astype(np.float64)
            for comp in contributions[1:]:
                final = final * comp
        elif self.score_type == "binary":
            masks = [(comp > thr).astype(np.float64)
                     for comp, thr in zip(contributions, self.score_thresholds)]
            final = masks[0]
            for m in masks[1:]:
                final = final * m
        else:
            raise NotImplementedError(self.score_type)
        final = final * np.asarray(uniqueness, np.float64)
        final = final * np.asarray(validity, np.float64)
        final = final * np.asarray(termination, np.float64)
        return final

    # ------------------------------------------------------------------
    def _contributions(self, graphs: Sequence) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        mols = None
        for comp in self.score_components:
            if comp.startswith("target_size"):
                target = int(comp.split("=", 1)[1])
                # target == max_n_nodes is degenerate: the reference divides
                # by (max_n_nodes - target) unguarded (ScoringFunction.py:
                # 111-129), and every score is then 1 - |n - max|/0
                if not (0 < target < self.max_n_nodes):
                    raise ValueError(
                        f"target_size={target} must satisfy 0 < target < "
                        f"max_n_nodes ({self.max_n_nodes}); "
                        f"target == max_n_nodes makes every score "
                        f"1 - |n - max|/0 degenerate")
                n_nodes = np.array([g.n_nodes for g in graphs], np.float64)
                out.append(1.0 - np.abs(n_nodes - target)
                           / (self.max_n_nodes - target))
            elif comp == "QED":
                if mols is None:
                    mols = [g.molecule for g in graphs]
                out.append(np.array([qed(m) for m in mols], np.float64))
            elif "activity" in comp:
                if mols is None:
                    mols = [g.molecule for g in graphs]
                model = self.qsar_models[comp]   # guaranteed by __init__
                fps = bulk_fingerprints(mols)
                try:
                    probs = model.predict_proba(fps)[:, 1]
                except Exception as exc:
                    # no silent zero: a fingerprint-width mismatch or a
                    # model quirk would zero the activity reward of the
                    # whole run unnoticed
                    raise RuntimeError(
                        f"QSAR model for {comp!r} failed on a "
                        f"{np.asarray(fps).shape} fingerprint batch "
                        f"(model {type(model).__name__}): {exc}") from exc
                # molecules that failed to build score 0
                for k, m in enumerate(mols):
                    if m is None or m.n_atoms == 0:
                        probs[k] = 0.0
                out.append(np.asarray(probs, np.float64))
            else:
                raise NotImplementedError(
                    f"score component {comp!r} is not defined "
                    "(reference: ScoringFunction.py:155-158)")
        return out
