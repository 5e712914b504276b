"""Adam + OneCycle learning-rate/momentum schedule.

Counterpart of ``graphinvent_tpu/train/optim.py``.  The reference trains
with torch Adam + OneCycleLR (Workflow.py:191-261), which also cycles
Adam's beta1 between max_momentum=0.95 and base_momentum=0.85; the
schedule is cosine with

  phase 1 (pct_start):  initial_lr = max_lr/div_factor  ->  max_lr
  phase 2:              max_lr  ->  initial_lr/final_div_factor

Training jobs use the torch defaults (pct_start=0.3, div=25, final_div=1e4);
fine-tune jobs use pct_start=0.05, div=1/max_rel_lr, final_div=1/min_rel_lr
(Workflow.py:198-206).  ``torch.optim.lr_scheduler.OneCycleLR`` itself is
not used: it raises past ``total_steps``, where this schedule clips and
stays at its final value (a restarted job may run past its plan).

The step count is known on the host, so ``lr`` and ``beta1`` are Python
floats computed there: no device value is read.  Adam is written out so
that the *current* beta1 enters both the first-moment update and its bias
correction (torch's semantics under a cycled momentum), as one
multi-tensor update over all leaves (``torch._foreach_*``), in place: the
parameters' version counters move, which the fused kernel's weight cache
keys on.  The moments are checkpointed beside the model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig


@dataclass(frozen=True)
class OneCycle:
    max_lr: float
    total_steps: int
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    cycle_momentum: bool = True

    def __call__(self, step: float) -> Tuple[float, float]:
        """step (0-based) -> (lr, beta1)."""
        return onecycle_eval(self, step)


def onecycle_eval(sched: OneCycle, step: float) -> Tuple[float, float]:
    """(lr, beta1) of ``sched`` at ``step``; steps outside the plan clip to
    its ends."""
    step = float(step)
    up_steps = max(float(sched.pct_start) * sched.total_steps - 1.0, 1.0)
    down_steps = max(sched.total_steps - up_steps - 1.0, 1.0)
    initial_lr = sched.max_lr / sched.div_factor
    min_lr = initial_lr / sched.final_div_factor

    def anneal(start: float, end: float, pct: float) -> float:
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def clip(x: float) -> float:
        return min(max(x, 0.0), 1.0)

    rising = step <= up_steps
    pct = clip(step / up_steps) if rising else clip(
        (step - up_steps) / down_steps)
    lr = (anneal(initial_lr, sched.max_lr, pct) if rising
          else anneal(sched.max_lr, min_lr, pct))
    if not sched.cycle_momentum:
        return lr, 0.9
    b1 = (anneal(sched.max_momentum, sched.base_momentum, pct) if rising
          else anneal(sched.base_momentum, sched.max_momentum, pct))
    return lr, b1


def onecycle_for_config(cfg: GraphInventConfig, steps_per_epoch: int
                        ) -> OneCycle:
    """The two scheduler shapes of Workflow.define_model_and_optimizer."""
    max_lr = cfg.max_rel_lr * cfg.init_lr
    # schedule_epochs: a restart trains cfg.epochs MORE epochs, and the LR
    # plan must still span the original total
    total_epochs = cfg.schedule_epochs or cfg.epochs
    if cfg.job_type == "fine-tune":
        return OneCycle(max_lr=max_lr, total_steps=total_epochs,
                        pct_start=0.05, div_factor=1.0 / cfg.max_rel_lr,
                        final_div_factor=1.0 / cfg.min_rel_lr)
    return OneCycle(max_lr=max_lr, total_steps=steps_per_epoch * total_epochs)


class Adam:
    """torch-style Adam over a model's parameters with a scheduled lr and
    beta1.  ``step`` counts the updates made; ``mu`` and ``nu`` are the
    moments, one tensor per parameter in ``named_parameters`` order."""

    def __init__(self, model: nn.Module, beta2: float = 0.999,
                 eps: float = 1e-8) -> None:
        named = list(model.named_parameters())
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.beta2 = beta2
        self.eps = eps

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def update(self, lr: float, beta1: float = 0.9) -> None:
        """One step from the parameters' ``.grad``, in place."""
        grads = [p.grad for p in self.params]
        missing = [n for n, g in zip(self.names, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient for {missing}")
        self.step += 1
        bc1 = 1.0 - beta1 ** self.step
        bc2 = 1.0 - self.beta2 ** self.step
        torch._foreach_mul_(self.mu, beta1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - beta1)
        torch._foreach_mul_(self.nu, self.beta2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.beta2)
        # p -= lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / bc1)

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        def named(ts):
            return {n: t.detach().to("cpu", torch.float32).clone()
                    for n, t in zip(self.names, ts)}
        return {"step": self.step, "mu": named(self.mu), "nu": named(self.nu)}

    def load_state_dict(self, state: Mapping[str, object]) -> None:
        for key in ("mu", "nu"):
            if sorted(state[key]) != sorted(self.names):
                raise ValueError(f"optimizer state {key!r} does not match "
                                 "the model's parameters")
        self.step = int(state["step"])
        with torch.no_grad():
            for n, m, v in zip(self.names, self.mu, self.nu):
                m.copy_(state["mu"][n])
                v.copy_(state["nu"][n])
