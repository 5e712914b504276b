"""What the port's measuring tools share: the model to run, a batch of
rows, the device's clock and the card the numbers come from."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.utils.device import (
    card_name_and_power_limit, resolve_device,
)


def load_model(cfg: GraphInventConfig, checkpoint: Optional[str] = None,
               seed: int = 0) -> torch.nn.Module:
    """A checkpoint (``.pth`` or the JAX package's ``.ckpt``), or seeded
    random weights, on ``cfg.device`` in eval mode."""
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.utils.weights import load_checkpoint
    device = resolve_device(cfg.device)
    model = (load_checkpoint(cfg, checkpoint) if checkpoint else
             build_model(cfg, torch.Generator().manual_seed(seed)))
    return model.to(device).eval()


def dataset_rows(cfg: GraphInventConfig, dataset_dir: str, n: int,
                 split: str = "train") -> Dict[str, np.ndarray]:
    """The first ``n`` rows of a preprocessed split (int8 ``nodes``,
    ``edges``, ``apds``) with ``valid`` ones, as the device-resident epoch
    path gathers them."""
    from graphinvent_tpu_torch.data import store
    with store.ReadStore(store.find_dataset(
            os.path.join(dataset_dir, split))) as ds:
        rows = {"nodes": np.asarray(ds.arrays["nodes"][:n]),
                "edges": np.asarray(ds.arrays["edges"][:n]),
                "apds": np.asarray(ds.arrays["APDs"][:n])}
    if rows["nodes"].shape[0] < n:
        raise ValueError(f"{dataset_dir}: {split} has fewer than {n} rows")
    if rows["nodes"].shape[1:] != tuple(cfg.dim_nodes):
        raise ValueError(f"{dataset_dir}: rows of shape "
                         f"{rows['nodes'].shape[1:]} do not fit the config's "
                         f"{tuple(cfg.dim_nodes)}")
    rows["valid"] = np.ones(n, np.float32)
    return rows


def synthetic_rows(cfg: GraphInventConfig, n: int, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Seeded random graphs (``utils/synthetic.synthetic_graphs``) with one
    random action target a row, in the dataset's int8 wire."""
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    nodes, edges = synthetic_graphs(cfg, n, seed=seed)
    apds = np.zeros((n, cfg.dim_apd), np.int8)
    apds[np.arange(n), np.random.default_rng(seed).integers(
        0, cfg.dim_apd, n)] = 1
    return {"nodes": nodes.astype(np.int8), "edges": edges.astype(np.int8),
            "apds": apds, "valid": np.ones(n, np.float32)}


def to_device(rows: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in rows.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device: torch.device) -> float:
    """Seconds of ``fn()`` on the host clock, the device synchronised
    before and after."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def device_report(device: torch.device) -> Dict[str, Optional[str]]:
    """Where the numbers were taken: the card's name and its power limit
    as ``nvidia-smi`` prints them, or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None}
    return {"device": torch.cuda.get_device_name(device),
            "card": card_name_and_power_limit()}
