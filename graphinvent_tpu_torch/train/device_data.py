"""Device-resident dataset and whole-epoch training on it.

Counterpart of ``graphinvent_tpu/train/device_data.py``.  The reference
moves every batch host-to-device inside the epoch loop
(Workflow.py:781-783).  Here the *entire* preprocessed dataset (int8: nodes
+ edges + APDs) is copied to the device once, and a batch is a row gather
there with the int8 -> compute-dtype cast inside the step.  Where the JAX
package runs an epoch as one ``lax.scan`` in one compiled program, the port
uploads the shuffled row ids once per epoch and, on a CUDA device with one
process and no mesh, replays each step (gather, cast, forward, backward,
OneCycle's staged scalars, Adam) from one captured CUDA graph
(``train/step_graphs.py``); elsewhere it runs the same step eagerly.
Every step's loss stays on the device, and the ONLY host synchronisation
of an epoch is one ``.item()`` of the summed loss at its end.

A dataset that exceeds ``cfg.device_data_gb`` takes the streamed
``BlockLoader`` path instead (workflow.py).

On one process's mesh (``parallel/mesh.py``) every rank holds the whole
dataset, as every device of the JAX package's mesh is handed it: only the
computation is split.  Each step gathers this rank's rows of the global
batch's ids and runs the mesh's step on them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data.loader import HDFDataset
from graphinvent_tpu_torch.train.optim import Adam, OneCycle
from graphinvent_tpu_torch.train.step import (
    make_eval_step, make_likelihood_step, make_train_step,
)
from graphinvent_tpu_torch.train.step_graphs import StepGraphs, replays_steps


def _mesh_steps(cfg: GraphInventConfig, mesh) -> Tuple[slice, bool]:
    """(this rank's rows of a batch of ids, whether the mesh has members)."""
    if mesh is None or mesh.size == 1:
        return slice(None), False
    from graphinvent_tpu_torch.parallel.mesh import data_rows
    return data_rows(cfg.batch_size, mesh), True


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
                        data: DeviceDataset, model: nn.Module, adam: Adam,
                        mesh=None, *, _eager: bool = False
                        ) -> Callable[..., float]:
    """Returns ``(perm, generator, step_losses=None) -> mean loss``: a full
    epoch over the index batches of ``perm``, updating ``model`` and
    ``adam`` in place; on ``mesh``, this rank's rows of each batch.  A
    ``step_losses`` list receives each step's loss (a tensor on the
    device: nothing is read back).  Where ``step_graphs.replays_steps``
    holds (and not ``_eager``), the steps are replays of a captured graph
    (``run.graphs``, a ``StepGraphs``; None on the eager loop)."""
    rows, sharded = _mesh_steps(cfg, mesh)
    if sharded:
        from graphinvent_tpu_torch.parallel.mesh import (
            make_sharded_train_step,
        )
        train_step = make_sharded_train_step(cfg, schedule, model, adam,
                                             mesh)
    else:
        train_step = make_train_step(cfg, schedule, model, adam)
    graphs = None
    if not _eager and replays_steps(data.device, mesh):
        graphs = StepGraphs(cfg, schedule, model, adam, data,
                            lambda idx: _gather_batch(data, idx), train_step)

    def run(perm: np.ndarray, generator: Optional[torch.Generator] = None,
            step_losses: Optional[List[torch.Tensor]] = None) -> float:
        batches = _upload_perm(perm[:, rows], data.device)
        total = torch.zeros((), dtype=torch.float32, device=data.device)
        if graphs is None:
            losses = (train_step(_gather_batch(data, idx), generator)
                      for idx in batches)
        else:
            losses = graphs.steps(batches, generator)
        for loss in losses:
            if step_losses is not None:
                step_losses.append(loss)
            total += loss
        return total.item() / len(batches)

    run.graphs = graphs
    return run


def make_epoch_eval_fn(cfg: GraphInventConfig, data: DeviceDataset,
                       model: nn.Module, mesh=None
                       ) -> Callable[[np.ndarray], float]:
    """Returns ``perm -> mean validation loss`` over index batches:
    grad-free forwards, which the fused kernel serves (on ``mesh``, this
    rank's node shards and head slices of its rows)."""
    rows, sharded = _mesh_steps(cfg, mesh)
    if sharded:
        from graphinvent_tpu_torch.parallel.mesh import make_sharded_eval_step
        eval_step = make_sharded_eval_step(cfg, model, mesh)
    else:
        eval_step = make_eval_step(cfg, model)

    def run(perm: np.ndarray) -> float:
        batches = _upload_perm(perm[:, rows], data.device)
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
