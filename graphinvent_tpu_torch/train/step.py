"""Train, validation-loss and likelihood steps on one batch.

Counterpart of ``graphinvent_tpu/train/step.py``.  A batch is a dict of
tensors on the model's device in one of three wire formats
(:func:`batch_arrays`).  The train step differentiates through
``models/core`` (autograd) and never takes the fused kernel, which has no
backward; the two grad-free steps run under ``torch.inference_mode`` with
``train=False``, where ``fused_enn.fused_gate`` sends every MLP through the
kernel.  No step reads a value back to the host: each returns a tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.train.loss import (
    apd_kl_loss, correct_action_likelihoods,
)
from graphinvent_tpu_torch.train.optim import Adam, OneCycle
from graphinvent_tpu_torch.utils.device import compute_dtype

Batch = Mapping[str, torch.Tensor]


def unpackbits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """(B, n_bytes) uint8 -> (B, count) uint8 0/1, most significant bit
    first: ``np.unpackbits(packed, axis=1, count=count)`` on the tensor's
    device, by shift and mask."""
    if packed.dtype != torch.uint8:
        raise TypeError(f"unpackbits takes uint8, got {packed.dtype}")
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :count]


def as_tensor(a: np.ndarray) -> torch.Tensor:
    """A wire array as a CPU tensor sharing its memory.  uint16 (the sparse
    APD indices) travels as its int16 bit pattern, which every torch op
    takes; :func:`batch_arrays` undoes it."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def batch_arrays(cfg: GraphInventConfig, batch: Batch, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Decodes a batch in any wire format into (nodes, edges, apds, valid).

    Plain: "nodes"/"edges"/"apds" in any number type (float32 from the
    block loader, int8 gathered from a device-resident dataset).  Packed
    (``data/loader.pack_rows``): bit-packed uint8 "nodes_p"/"edges_p" +
    int8 "apds", unpacked here ON THE DEVICE; packing 0/1 one-hots is
    exact.  Sparse (``data/loader.sparse_apds``): "apds_i"/"apds_v" slots
    beside the packed graphs, rebuilt by a scatter-add; padded (0, 0)
    slots add zero at column 0, so the targets are the dense wire's."""
    if "nodes_p" in batch:
        M, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
        B = batch["nodes_p"].shape[0]
        nodes = unpackbits(batch["nodes_p"], M * Fn).reshape(B, M, Fn).to(dtype)
        edges = unpackbits(batch["edges_p"], M * M * E
                           ).reshape(B, M, M, E).to(dtype)
    else:
        nodes = batch["nodes"].to(dtype)
        edges = batch["edges"].to(dtype)
    if "apds_i" in batch:
        idx = batch["apds_i"].to(torch.int64) & 0xFFFF
        val = batch["apds_v"].to(torch.float32)
        apds = torch.zeros(idx.shape[0], cfg.dim_apd, dtype=torch.float32,
                           device=idx.device)
        apds.scatter_add_(1, idx, val)
    else:
        apds = batch["apds"].to(torch.float32)
    return nodes, edges, apds, batch.get("valid")


class BatchUploader:
    """numpy wire batches -> tensors on ``device``.

    On a CUDA device each array is staged in a pinned host buffer (kept
    per key and shape, reused) and copied with ``non_blocking=True`` on a
    copy stream of its own, so a worker thread can upload batch k+1 while
    the default stream computes step k.  The call returns after the copy
    has finished (only the calling thread waits), so the buffers are free
    to reuse and the tensors are ready on any stream."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._pinned: Dict[tuple, torch.Tensor] = {}

    def __call__(self, batch: Mapping[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        if not self._cuda:
            return {k: as_tensor(v) for k, v in batch.items()}
        out = {}
        consumer = torch.cuda.default_stream(self.device)
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                src = as_tensor(v)
                key = (k, tuple(src.shape), src.dtype)
                buf = self._pinned.get(key)
                if buf is None:
                    buf = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    self._pinned[key] = buf
                buf.copy_(src)
                t = buf.to(self.device, non_blocking=True)
                # allocated on the copy stream, read on the default one
                t.record_stream(consumer)
                out[k] = t
        self._stream.synchronize()
        return out


def train_loss(cfg: GraphInventConfig, model: nn.Module, batch: Batch,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training forward: unfused ``core`` path, dropout masks from
    ``generator``, loss in float32."""
    nodes, edges, apds, valid = batch_arrays(cfg, batch, compute_dtype(cfg))
    logits = model(nodes, edges, train=True, generator=generator)
    return apd_kl_loss(logits.float(), apds, valid)


def make_train_step(cfg: GraphInventConfig, schedule: OneCycle,
                    model: nn.Module, adam: Adam
                    ) -> Callable[[Batch, Optional[torch.Generator]],
                                  torch.Tensor]:
    """Returns ``(batch, generator) -> loss``: gradient, OneCycle and Adam,
    updating ``model`` and ``adam`` in place.  lr and beta1 come from the
    host's step count; the loss stays on the device."""

    def train_step(batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        adam.zero_grad()
        loss = train_loss(cfg, model, batch, generator)
        loss.backward()
        lr, beta1 = schedule(adam.step)
        adam.update(lr, beta1)
        return loss.detach()

    return train_step


def _eval_logits(cfg: GraphInventConfig, model: nn.Module, batch: Batch
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """A grad-free forward (under ``torch.inference_mode``): the fused
    kernel serves it where ``cfg.fused_inference_enn`` allows.
    -> (float32 logits, apds, valid)."""
    nodes, edges, apds, valid = batch_arrays(cfg, batch, compute_dtype(cfg))
    return model(nodes, edges, train=False).float(), apds, valid


def make_eval_step(cfg: GraphInventConfig, model: nn.Module
                   ) -> Callable[[Batch], torch.Tensor]:
    """Returns the validation-loss step (no dropout, no grad)."""

    def eval_step(batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            logits, apds, valid = _eval_logits(cfg, model, batch)
            return apd_kl_loss(logits, apds, valid)

    return eval_step


def make_likelihood_step(cfg: GraphInventConfig, model: nn.Module
                         ) -> Callable[[Batch], torch.Tensor]:
    """Per-row correct-action NLL (for the UC-JSD; reference
    Analyzer.py:708-778).  Padded rows give a finite value that the caller
    drops by the ``valid`` mask."""

    def nll_step(batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            logits, apds, _ = _eval_logits(cfg, model, batch)
            p = correct_action_likelihoods(logits, apds)
            return -torch.log(p.clamp(min=1e-30))

    return nll_step
