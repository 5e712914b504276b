"""A logistic activity model over Morgan fingerprints, for RL scoring.

The reference scores activity with a pickled scikit-learn SVC over RDKit
ECFP4 fingerprints (parameters/constants.py:250-256); the JAX package's
``tools/train_qsar.py`` retrains one on the in-repo fingerprints with
scikit-learn.  The machine with the card has no scikit-learn, so the
port trains in torch and predicts in numpy:

* :func:`fit_logistic` minimises scikit-learn's ``LogisticRegression``
  objective at its defaults, 0.5 * |w|^2 + C * sum_i log(1 + exp(-s_i *
  (x_i . w + b))) with s_i = +-1 and an unpenalised intercept, by L-BFGS
  in float64 on ``device``;
* :class:`LogisticModel` keeps the weights as numpy arrays and has
  ``predict_proba``, so its pickle loads and scores in
  ``eval/scoring.py`` with nothing but numpy.
"""

from __future__ import annotations

import numpy as np


class LogisticModel:
    """Binary logistic classifier with scikit-learn's attribute names
    (``coef_`` (1, d), ``intercept_`` (1,), ``classes_``)."""

    def __init__(self, coef: np.ndarray, intercept: float) -> None:
        self.coef_ = np.asarray(coef, np.float64).reshape(1, -1)
        self.intercept_ = np.array([float(intercept)])
        self.classes_ = np.array([0.0, 1.0])

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_[0] + self.intercept_[0]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """(n, 2): P(inactive), P(active)."""
        z = self.decision_function(X)
        e = np.exp(-np.abs(z))
        p1 = np.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.decision_function(X) > 0).astype(np.float64)


def fit_logistic(X: np.ndarray, y: np.ndarray, C: float = 1.0,
                 device: str = "cuda", max_iter: int = 2000,
                 tol: float = 1e-10) -> LogisticModel:
    """Fits the L2-regularised logistic regression of scikit-learn's
    ``LogisticRegression(C=C)`` to fingerprints ``X`` (n, d) and 0/1
    labels ``y``; -> a :class:`LogisticModel`."""
    import torch
    from graphinvent_tpu_torch.utils.device import resolve_device

    y = np.asarray(y)
    if set(np.unique(y).tolist()) != {0.0, 1.0}:
        raise ValueError("fit_logistic needs both labels 0 and 1, got "
                         f"{sorted(set(np.unique(y).tolist()))}")
    dev = resolve_device(device)
    Xt = torch.as_tensor(np.asarray(X, np.float64), device=dev)
    s = torch.as_tensor(np.where(y > 0, 1.0, -1.0), device=dev)
    w = torch.zeros(Xt.shape[1], dtype=torch.float64, device=dev,
                    requires_grad=True)
    b = torch.zeros((), dtype=torch.float64, device=dev, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=max_iter,
                            tolerance_grad=tol, tolerance_change=0.0,
                            history_size=20, line_search_fn="strong_wolfe")

    def objective() -> torch.Tensor:
        opt.zero_grad()
        z = Xt @ w + b
        loss = 0.5 * (w * w).sum() + C * torch.nn.functional.softplus(
            -s * z).sum()
        loss.backward()
        return loss

    opt.step(objective)
    return LogisticModel(w.detach().cpu().numpy(), float(b.detach()))
