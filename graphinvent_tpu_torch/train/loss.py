"""Training loss: KL divergence between target and predicted APDs.

Counterpart of ``graphinvent_tpu/train/loss.py`` (reference Workflow.loss,
Workflow.py:833-860):
``KLDivLoss(reduction="batchmean")(LogSoftmax(output), target/target.sum())``.
Targets may hold more than one correct action (duplicate subgraphs have
their APDs summed in preprocessing), hence the renormalisation.  Both
functions take float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def apd_kl_loss(logits: torch.Tensor, targets: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, A) raw APD output; targets (B, A) non-negative counts.

    ``valid`` masks padded rows (all-zero targets) of fixed-shape batches;
    the sum is divided by the number of valid rows ("batchmean" over the
    true batch).  The ``clamp`` inside the log and the outer ``where`` both
    stay: without the first, the backward of ``log`` at t == 0 is inf and
    the ``where`` turns it into 0 * inf = NaN.
    """
    logp = torch.log_softmax(logits, dim=1)
    tsum = targets.sum(dim=1, keepdim=True)
    t = targets / tsum.clamp(min=1e-30)
    elt = torch.where(t > 0, t * (torch.log(t.clamp(min=1e-30)) - logp),
                      torch.zeros_like(t))
    per_row = elt.sum(dim=1)
    if valid is None:
        return per_row.sum() / logits.shape[0]
    valid = valid.to(per_row.dtype)
    return (per_row * valid).sum() / valid.sum().clamp(min=1.0)


def correct_action_likelihoods(logits: torch.Tensor, targets: torch.Tensor
                               ) -> torch.Tensor:
    """Probability mass the model gives to the correct action(s) of each
    row (reference Analyzer.get_validation_likelihood, Analyzer.py:754-766).
    Returns (B,) probabilities; the caller applies -log."""
    probs = torch.softmax(logits, dim=1)
    tsum = targets.sum(dim=1, keepdim=True)
    t = targets / tsum.clamp(min=1e-30)
    return (t * probs).sum(dim=1)
