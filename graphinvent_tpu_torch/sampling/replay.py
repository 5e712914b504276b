"""Replay of sampled action trajectories: the log-likelihood of each.

Counterpart of ``graphinvent_tpu/sampling/replay.py``.  The sampler runs
grad-free and records each graph's action ids; :func:`trajectory_loglik`
rebuilds the graph states from those actions, step by step, and sums the
chosen actions' log-probabilities under a model.  Under autograd the sum
is differentiable with respect to the model's parameters, which is all the
policy-gradient loss needs (reference Workflow.py:862-898): the states are
functions of the fixed actions alone and carry no gradient.

Two uses, one function:

* under autograd (the RL loss), each step's forward is rematerialised in
  the backward pass (``torch.utils.checkpoint``, non-reentrant), so that
  the activations of one step, or of ``cfg.rl_remat_segment`` steps, are
  alive at a time and not those of all L.  Grad is on in the forward and
  in its recompute, so the model takes its plain path (the kernel has no
  backward);
* under ``torch.inference_mode`` (the prior's and the best agent's
  likelihoods, data for the loss targets), nothing is checkpointed and the
  model's grad-free forward launches the fused kernel, as the sampler's.

The loop stops after ``max(t_counts)`` steps: every later step is inert
(no row is active, no action applied, nothing added), as the JAX package's
L-step scan runs them.  A caller that knows the length on the host passes
``stop`` and nothing is read back; a longer ``stop`` (up to L) runs inert
steps, which add +0 to each sum and send zero gradients back: the same
loss and gradients up to the sign of a zero.  :func:`replay_step` is one
step with its index on the device, as a captured CUDA graph replays it
(``rl/step_graphs.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.sampling.actions import (
    apply_actions, decode_actions, select_rows,
)
from graphinvent_tpu_torch.utils.device import compute_dtype

Params = Any


def replay_step(cfg: GraphInventConfig, apply_fn: Callable, model: Params,
                actions: torch.Tensor, t_counts: torch.Tensor, s,
                acc: torch.Tensor, nodes: torch.Tensor, edges: torch.Tensor,
                n_nodes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Step ``s`` (an int, or a 0-d long tensor on the device) from the
    carry (acc, nodes, edges, n_nodes): adds its active rows' chosen log p
    to ``acc`` and applies their actions.  Returns the carry after it."""
    active = s < t_counts
    logits = apply_fn(model, nodes, edges)
    # f32 for bf16 and f32 logits, float64 for a float64 model's
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=1)
    a = (actions[:, s] if isinstance(s, int)
         else actions.index_select(1, s.reshape(1))[:, 0])
    acc = acc + torch.where(active, select_rows(logp, a),
                            torch.zeros_like(acc))
    dec = decode_actions(cfg, a, n_nodes, edges)
    dec = dec._replace(is_add=dec.is_add & active,
                       is_conn=dec.is_conn & active)
    nodes, edges, n_nodes = apply_actions(cfg, dec, nodes, edges, n_nodes)
    # the states depend on the fixed actions only
    return acc, nodes.detach(), edges.detach(), n_nodes


def _steps(cfg: GraphInventConfig, apply_fn: Callable, model: Params,
           actions: torch.Tensor, t_counts: torch.Tensor, first: int,
           last: int, *carry: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Steps ``first`` .. ``last - 1`` from the carry (acc, nodes, edges,
    n_nodes); returns the carry after them."""
    for s in range(first, last):
        carry = replay_step(cfg, apply_fn, model, actions, t_counts, s,
                            *carry)
    return carry


def initial_carry(cfg: GraphInventConfig, batch: int, device: torch.device
                  ) -> Tuple[torch.Tensor, ...]:
    """(acc, nodes, edges, n_nodes) before the first step: empty graphs."""
    N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
    dt = compute_dtype(cfg)
    return (torch.zeros(batch, dtype=torch.float32, device=device),
            torch.zeros(batch, N, Fn, dtype=dt, device=device),
            torch.zeros(batch, N, N, E, dtype=dt, device=device),
            torch.zeros(batch, dtype=torch.long, device=device))


def trajectory_loglik(cfg: GraphInventConfig, model: Params,
                      actions: torch.Tensor, t_counts: torch.Tensor,
                      apply_fn: Optional[Callable] = None,
                      stop: Optional[int] = None) -> torch.Tensor:
    """actions (B, L) action ids, t_counts (B,) how many are real, both on
    the model's device.  Returns (B,): the sum of log p over each
    trajectory under ``model``, in float32 (float64 where ``apply_fn``
    returns float64 logits).  ``stop``: the steps to run, at least
    ``max(t_counts)`` (by default that, read from the device)."""
    apply_fn = apply_fn or (lambda m, nodes, edges: m(nodes, edges))
    B, L = actions.shape
    actions = actions.long()
    t_counts = t_counts.long()
    carry = initial_carry(cfg, B, actions.device)
    if stop is None:
        stop = min(int(t_counts.max()), L) if B else 0
    seg = max(int(cfg.rl_remat_segment), 1)
    remat = torch.is_grad_enabled()
    # the last segment may be shorter: the JAX package pads it with inert
    # steps, which add nothing
    for first in range(0, stop, seg):
        args = (cfg, apply_fn, model, actions, t_counts, first,
                min(first + seg, stop), *carry)
        if remat:
            # the model draws no random numbers in a train=False forward
            carry = checkpoint(_steps, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = _steps(*args)
    return carry[0]
