"""SELU MLPs, stacked MLPs and the GRU cell as PyTorch modules and functions.

Counterpart of ``graphinvent_tpu/models/core.py``.  Parameters live in
``nn.Module``s whose ``state_dict`` has the reference GraphINVENT layout
(gnn/modules.py:111-170): every linear is followed by SELU and AlphaDropout
in one ``nn.Sequential``, so linears sit at indices 0, 3, 6, ...  The
forward functions do not call the Sequential: they keep the JAX package's
numerics, where the activations run in the compute dtype and weights stay
float32 and are cast at use.

bf16 rule (XLA's, ``core.py:91-130`` of the JAX package): the product
accumulates in f32 and is rounded to the compute dtype, then the bias is
added and SELU applied in the compute dtype.

Init conventions match the JAX package (and PyTorch): Xavier-uniform
weights, U(-1/sqrt(fan_in), ..) biases; GRU U(-1/sqrt(hidden), ..) with
torch gate order [r, z, n].  The numbers differ (another RNG); the
distributions do not.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# SELU constants (match torch.nn.SELU / AlphaDropout)
SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805
ALPHA_PRIME = -SELU_ALPHA * SELU_SCALE


def init_linear_(linear: nn.Linear, generator: torch.Generator) -> None:
    out_f, in_f = linear.weight.shape
    limit = math.sqrt(6.0 / (in_f + out_f))
    blim = 1.0 / math.sqrt(in_f)
    with torch.no_grad():
        linear.weight.uniform_(-limit, limit, generator=generator)
        linear.bias.uniform_(-blim, blim, generator=generator)


class MLP(nn.Module):
    """SELU after every layer, including the last (reference
    gnn/modules.py:111-170)."""

    def __init__(self, in_features: int, hidden_layer_sizes: Sequence[int],
                 out_features: int, dropout_p: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        sizes = [in_features, *hidden_layer_sizes, out_features]
        mods: List[nn.Module] = []
        for i, o in zip(sizes[:-1], sizes[1:]):
            mods += [nn.Linear(i, o), nn.SELU(), nn.AlphaDropout(dropout_p)]
        self.seq = nn.Sequential(*mods)
        self.dropout_p = dropout_p
        if generator is not None:
            for lin in self.linears:
                init_linear_(lin, generator)

    @property
    def linears(self) -> List[nn.Linear]:
        return [self.seq[i] for i in range(0, len(self.seq), 3)]


def alpha_dropout_masked(x: torch.Tensor, keep: torch.Tensor, p: float
                         ) -> torch.Tensor:
    """torch.nn.AlphaDropout written out, given the keep mask: dropped
    entries take SELU's negative saturation value, and an affine map
    restores zero mean and unit variance (``alpha_dropout`` of the JAX
    package, same arithmetic)."""
    q = 1.0 - p
    a = (q + ALPHA_PRIME ** 2 * q * p) ** -0.5
    b = -a * (1.0 - q) * ALPHA_PRIME
    return a * torch.where(keep, x, ALPHA_PRIME) + b


def alpha_dropout(x: torch.Tensor, p: float, generator: torch.Generator
                  ) -> torch.Tensor:
    """SELU-preserving dropout whose keep mask (probability 1 - p) is drawn
    from ``generator``, which lives on x's device: the same generator state
    gives the same mask."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return alpha_dropout_masked(x, keep, p)


def _dropout(x: torch.Tensor, p: float, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout only on training forwards that were handed a generator, as
    the JAX package drops out only when it is handed a key."""
    if train and p > 0.0 and generator is not None:
        return alpha_dropout(x, p, generator)
    return x


def mlp(module: MLP, x: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x (..., I) -> (..., O), activations in x's dtype."""
    dt = x.dtype
    for lin in module.linears:
        x = F.selu(torch.matmul(x, lin.weight.to(dt).t()) + lin.bias.to(dt))
        x = _dropout(x, module.dropout_p, train, generator)
    return x


def stacked_layers(mlps: Sequence[MLP]) -> List[tuple]:
    """Per layer, the towers' weights stacked as ((E, O, I), (E, O))."""
    per = [m.linears for m in mlps]
    return [(torch.stack([p[l].weight for p in per]),
             torch.stack([p[l].bias for p in per]))
            for l in range(len(per[0]))]


def stacked_mlp(mlps: Sequence[MLP], x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x (..., I) shared input -> (E, ..., O): every tower on the same
    input, one batched product per layer."""
    dt = x.dtype
    lead = x.shape[:-1]
    y = x.reshape(1, -1, x.shape[-1])
    for w, b in stacked_layers(mlps):
        # (E, R, K) @ (E, K, O): the library accumulates a bf16 product in
        # f32 and rounds it to bf16 once, as XLA's preferred_element_type
        prod = torch.matmul(y, w.to(dt).transpose(1, 2))
        y = F.selu(prod + b.to(dt)[:, None, :])
        y = _dropout(y, mlps[0].dropout_p, train, generator)
    return y.reshape(y.shape[0], *lead, y.shape[-1])


class GRUCellParams(nn.GRUCell):
    """Parameter holder with torch.nn.GRUCell's names (``weight_ih``,
    ``weight_hh``, ``bias_ih``, ``bias_hh``); :func:`gru_cell` runs it."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size)
        if generator is not None:
            limit = 1.0 / math.sqrt(hidden_size)
            with torch.no_grad():
                for p in (self.weight_ih, self.weight_hh, self.bias_ih,
                          self.bias_hh):
                    p.uniform_(-limit, limit, generator=generator)


def gru_cell(cell: nn.GRUCell, x: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
    """torch.nn.GRUCell in x's dtype: gates ordered [reset, update, new]."""
    dt = x.dtype
    gi = torch.matmul(x, cell.weight_ih.to(dt).t()) + cell.bias_ih.to(dt)
    gh = torch.matmul(h, cell.weight_hh.to(dt).t()) + cell.bias_hh.to(dt)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h
