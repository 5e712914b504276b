"""Device-resident dataset and whole-epoch training on it.

Counterpart of ``graphinvent_tpu/train/device_data.py``.  The reference
moves every batch host-to-device inside the epoch loop
(Workflow.py:781-783).  Here the *entire* preprocessed dataset (int8: nodes
+ edges + APDs) is copied to the device once, and a batch is a row gather
there with the int8 -> compute-dtype cast inside the step.  Where the JAX
package runs an epoch as one ``lax.scan`` in one compiled program, the port
runs an eager loop: the shuffled row ids are uploaded once per epoch, every
step's loss stays on the device, and the ONLY host synchronisation of an
epoch is one ``.item()`` of the summed loss at its end.

A dataset that exceeds ``cfg.device_data_gb`` takes the streamed
``BlockLoader`` path instead (workflow.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data.loader import HDFDataset
from graphinvent_tpu_torch.train.optim import Adam, OneCycle
from graphinvent_tpu_torch.train.step import (
    make_eval_step, make_likelihood_step, make_train_step,
)


class DeviceDataset:
    """A whole dataset as int8 tensors on ``device``."""

    def __init__(self, ds: HDFDataset, device: torch.device) -> None:
        self.n_rows = len(ds)
        self.device = device

        def put(a) -> torch.Tensor:
            return torch.from_numpy(np.array(a[:], np.int8)).to(device)
        self.nodes = put(ds.nodes)
        self.edges = put(ds.edges)
        self.apds = put(ds.apds)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nodes, self.edges, self.apds))

    @staticmethod
    def nbytes_of(ds: HDFDataset) -> int:
        """int8 device footprint of ``ds`` without loading it."""
        row = (int(np.prod(ds.nodes.shape[1:]))
               + int(np.prod(ds.edges.shape[1:]))
               + int(np.prod(ds.apds.shape[1:])))
        return row * len(ds)


def _padded_batches(order: np.ndarray, batch_size: int) -> np.ndarray:
    n = len(order)
    n_batches = (n + batch_size - 1) // batch_size
    padded = np.full(n_batches * batch_size, -1, np.int32)
    padded[:n] = order
    return padded.reshape(n_batches, batch_size)


def epoch_permutation(n_rows: int, batch_size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(n_batches, batch_size) int32 shuffled row ids; the remainder is
    padded with -1 (masked out of the loss).  The same numpy calls as the
    JAX package's, so the same rng gives the same batches."""
    return _padded_batches(rng.permutation(n_rows).astype(np.int32),
                           batch_size)


def nll_row_batches(n_total: int, max_rows: int, batch_size: int,
                    rng: np.random.Generator) -> np.ndarray:
    """(n_batches, batch_size) int32 row ids for an NLL evaluation pass:
    ``min(n_total, max_rows)`` rows drawn uniformly without replacement
    from the WHOLE dataset, a fresh draw per call (a fixed leading-rows
    sample would bias the UC-JSD's train and valid arms).  Padding slots
    are -1."""
    n = min(n_total, max_rows)
    return _padded_batches(rng.permutation(n_total)[:n].astype(np.int32),
                           batch_size)


def _gather_batch(data: DeviceDataset, idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Rows ``idx`` (int64 on the device, -1 = padding) as a plain-wire
    batch, still int8: ``step.batch_arrays`` casts it.  A padding slot
    reads row 0 and is masked by ``valid``."""
    safe = idx.clamp(min=0)
    return {
        "nodes": data.nodes.index_select(0, safe),
        "edges": data.edges.index_select(0, safe),
        "apds": data.apds.index_select(0, safe),
        "valid": (idx >= 0).to(torch.float32),
    }


def _upload_perm(perm: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(perm)).to(
        device, torch.int64)


def make_epoch_train_fn(cfg: GraphInventConfig, schedule: OneCycle,
                        data: DeviceDataset, model: nn.Module, adam: Adam
                        ) -> Callable[[np.ndarray,
                                       Optional[torch.Generator]], float]:
    """Returns ``(perm, generator) -> mean loss``: a full epoch over the
    index batches of ``perm``, updating ``model`` and ``adam`` in place."""
    train_step = make_train_step(cfg, schedule, model, adam)

    def run(perm: np.ndarray,
            generator: Optional[torch.Generator] = None) -> float:
        batches = _upload_perm(perm, data.device)
        total = torch.zeros((), dtype=torch.float32, device=data.device)
        for idx in batches:
            total += train_step(_gather_batch(data, idx), generator)
        return total.item() / len(batches)

    return run


def make_epoch_eval_fn(cfg: GraphInventConfig, data: DeviceDataset,
                       model: nn.Module) -> Callable[[np.ndarray], float]:
    """Returns ``perm -> mean validation loss`` over index batches:
    grad-free forwards, which the fused kernel serves."""

    eval_step = make_eval_step(cfg, model)

    def run(perm: np.ndarray) -> float:
        batches = _upload_perm(perm, data.device)
        total = torch.zeros((), dtype=torch.float32, device=data.device)
        for idx in batches:
            total += eval_step(_gather_batch(data, idx))
        return total.item() / len(batches)

    return run


def make_epoch_nll_fn(cfg: GraphInventConfig, data: DeviceDataset,
                      model: nn.Module
                      ) -> Callable[[np.ndarray],
                                    Tuple[np.ndarray, np.ndarray]]:
    """Returns ``perm -> (nlls, valid)`` flattened over the index batches
    (correct-action NLL per row), fetched in one copy."""

    nll_step = make_likelihood_step(cfg, model)

    def run(perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        batches = _upload_perm(perm, data.device)
        nlls = [nll_step(_gather_batch(data, idx)) for idx in batches]
        return (torch.cat(nlls).cpu().numpy(),
                (perm.reshape(-1) >= 0).astype(np.float32))

    return run
