"""Weight bridge and checkpoints.

* The JAX package's GGNN param pytree, given as numpy arrays, becomes the
  port's GGNN (:func:`ggnn_from_jax_params`).
* The port's ``state_dict`` already has the reference GraphINVENT layout
  (``msg_nns.{e}.seq.{3l}.weight``, ``gru.weight_ih``,
  ``gather.att_nn.seq.{3l}.*``, ``APDReadout.fAddNet1.*``, ...), the layout
  the JAX package imports in ``utils/torch_import.py``.
* The way back, for tests and tools: a reference-layout state_dict becomes
  the JAX package's GGNN pytree as numpy arrays
  (:func:`jax_params_from_state_dict`); Adam's moments cross the same two
  bridges, since they have the parameters' names and shapes.
* Checkpoints are ``model_restart_{epoch}.pth`` files holding that
  state_dict, which the JAX package reads through
  ``checkpoint_path(..., allow_torch=True)`` and ``load_params_any``.  A
  train job writes Adam's ``step``, ``mu`` and ``nu`` beside each as
  ``optimizer_restart_{epoch}.pth``, a name the JAX package's
  ``latest_checkpoint`` does not match.  Both are written to a ``.tmp``
  file and moved into place.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.models import build_model

# JAX param subtree -> reference module prefix
_GATHER = {"att_nn": "att_nn", "emb_nn": "emb_nn"}
_APD = {"f_add_1": "fAddNet1", "f_conn_1": "fConnNet1",
        "f_add_2": "fAddNet2", "f_conn_2": "fConnNet2",
        "f_term_2": "fTermNet2"}
_GRU = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
        "b_hh": "bias_hh"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _mlp_items(prefix: str, params: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for l, lp in enumerate(params["layers"]):
        out[f"{prefix}.seq.{3 * l}.weight"] = _t(lp["w"])
        out[f"{prefix}.seq.{3 * l}.bias"] = _t(lp["b"])
    return out


def state_dict_from_jax_params(cfg: GraphInventConfig, params: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's GGNN pytree -> reference-layout state_dict."""
    if cfg.model != "GGNN":
        raise NotImplementedError(f"weight bridge for {cfg.model!r} is not "
                                  f"ported yet (see ROADMAP.md)")
    sd: Dict[str, torch.Tensor] = {}
    for l, lp in enumerate(params["msg_nns"]["layers"]):
        for e in range(np.shape(lp["w"])[0]):
            sd[f"msg_nns.{e}.seq.{3 * l}.weight"] = _t(lp["w"][e])
            sd[f"msg_nns.{e}.seq.{3 * l}.bias"] = _t(lp["b"][e])
    for ours, theirs in _GRU.items():
        sd[f"gru.{theirs}"] = _t(params["gru"][ours])
    for ours, theirs in _GATHER.items():
        sd.update(_mlp_items(f"gather.{theirs}", params["gather"][ours]))
    for ours, theirs in _APD.items():
        sd.update(_mlp_items(f"APDReadout.{theirs}", params["apd"][ours]))
    return sd


def _mlp_tree(prefix: str, sd: Mapping[str, Any]) -> Dict[str, list]:
    layers = []
    while f"{prefix}.seq.{3 * len(layers)}.weight" in sd:
        l = 3 * len(layers)
        layers.append({"w": _np(sd[f"{prefix}.seq.{l}.weight"]),
                       "b": _np(sd[f"{prefix}.seq.{l}.bias"])})
    return {"layers": layers}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, dtype=np.float32)


def jax_params_from_state_dict(cfg: GraphInventConfig, sd: Mapping[str, Any]
                               ) -> Dict[str, Any]:
    """Reference-layout state_dict (tensors or arrays) -> the JAX package's
    GGNN pytree as float32 numpy arrays: the inverse of
    :func:`state_dict_from_jax_params`."""
    if cfg.model != "GGNN":
        raise NotImplementedError(f"weight bridge for {cfg.model!r} is not "
                                  f"ported yet (see ROADMAP.md)")
    towers = [_mlp_tree(f"msg_nns.{e}", sd)["layers"]
              for e in range(cfg.n_edge_features)]
    return {
        "msg_nns": {"layers": [
            {k: np.stack([t[l][k] for t in towers]) for k in ("w", "b")}
            for l in range(len(towers[0]))]},
        "gru": {ours: _np(sd[f"gru.{theirs}"])
                for ours, theirs in _GRU.items()},
        "gather": {ours: _mlp_tree(f"gather.{theirs}", sd)
                   for ours, theirs in _GATHER.items()},
        "apd": {ours: _mlp_tree(f"APDReadout.{theirs}", sd)
                for ours, theirs in _APD.items()},
    }


def model_from_state_dict(cfg: GraphInventConfig,
                          sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Reference-layout state_dict (``module.`` prefixes allowed) -> the
    port's model on the CPU; every key must match."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def ggnn_from_jax_params(cfg: GraphInventConfig, params: Mapping) -> nn.Module:
    return model_from_state_dict(cfg, state_dict_from_jax_params(cfg, params))


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's weights as f32 CPU tensors in the reference layout."""
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in model.state_dict().items()}


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def checkpoint_path(job_dir: str, epoch: int) -> str:
    return os.path.join(job_dir, f"model_restart_{epoch}.pth")


def optimizer_path(job_dir: str, epoch: int) -> str:
    return os.path.join(job_dir, f"optimizer_restart_{epoch}.pth")


def latest_checkpoint(job_dir: str) -> Optional[Tuple[str, int]]:
    """(path, epoch) of the newest ``model_restart_<epoch>.pth`` in the
    dir, or None."""
    best: Optional[Tuple[str, int]] = None
    if not os.path.isdir(job_dir):
        return None
    for name in os.listdir(job_dir):
        m = re.match(r"model_restart_(\d+)\.pth$", name)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (os.path.join(job_dir, name), int(m.group(1)))
    return best


def _save_atomic(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(model: nn.Module, job_dir: str, epoch: int,
                    optimizer_state: Optional[Mapping[str, Any]] = None
                    ) -> str:
    """Writes the model's state_dict and, when given, the optimizer's
    (``train.optim.Adam.state_dict()``) beside it."""
    path = checkpoint_path(job_dir, epoch)
    _save_atomic(reference_state_dict(model), path)
    if optimizer_state is not None:
        _save_atomic(dict(optimizer_state), optimizer_path(job_dir, epoch))
    return path


def load_optimizer_state(job_dir: str, epoch: int
                         ) -> Optional[Dict[str, Any]]:
    """The optimizer state saved with ``epoch``'s checkpoint, or None where
    there is none (a reference checkpoint: Adam then starts fresh)."""
    path = optimizer_path(job_dir, epoch)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(cfg: GraphInventConfig, path: str) -> nn.Module:
    """A ``.pth`` state_dict (the port's, or a reference v2.0 one) -> the
    port's model on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return model_from_state_dict(cfg, sd)
