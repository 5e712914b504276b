"""GraphGather and the tiered APD head (GlobalReadout).

Counterpart of ``graphinvent_tpu/models/readout.py`` (reference
gnn/modules.py:12-52 and 173-281).  Module attribute names give the
reference's ``state_dict`` keys: ``gather.att_nn``, ``gather.emb_nn``,
``APDReadout.fAddNet1`` ... ``fTermNet2``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graphinvent_tpu_torch.models.core import MLP, mlp


class GraphGather(nn.Module):
    def __init__(self, node_features: int, hidden_node_features: int,
                 out_features: int, att_depth: int, att_hidden_dim: int,
                 emb_depth: int, emb_hidden_dim: int, att_dropout_p: float = 0.0,
                 emb_dropout_p: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.att_nn = MLP(node_features + hidden_node_features,
                          [att_hidden_dim] * att_depth, out_features,
                          att_dropout_p, generator)
        self.emb_nn = MLP(hidden_node_features, [emb_hidden_dim] * emb_depth,
                          out_features, emb_dropout_p, generator)


class GlobalReadout(nn.Module):
    def __init__(self, f_add_elems: int, f_conn_elems: int, f_term_elems: int,
                 mlp1_depth: int, mlp1_hidden_dim: int, mlp2_depth: int,
                 mlp2_hidden_dim: int, graph_emb_size: int, max_n_nodes: int,
                 node_emb_size: int, mlp1_dropout_p: float = 0.0,
                 mlp2_dropout_p: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        h1 = [mlp1_hidden_dim] * mlp1_depth
        h2 = [mlp2_hidden_dim] * mlp2_depth
        self.fAddNet1 = MLP(node_emb_size, h1, f_add_elems, mlp1_dropout_p,
                            generator)
        self.fConnNet1 = MLP(node_emb_size, h1, f_conn_elems, mlp1_dropout_p,
                             generator)
        self.fAddNet2 = MLP(max_n_nodes * f_add_elems + graph_emb_size, h2,
                            f_add_elems * max_n_nodes, mlp2_dropout_p,
                            generator)
        self.fConnNet2 = MLP(max_n_nodes * f_conn_elems + graph_emb_size, h2,
                             f_conn_elems * max_n_nodes, mlp2_dropout_p,
                             generator)
        self.fTermNet2 = MLP(graph_emb_size, h2, f_term_elems, mlp2_dropout_p,
                             generator)


def _mlp(module: MLP, x: torch.Tensor, train: bool, fused: bool,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inference-path dispatch: the fused kernel when the caller's gate
    (models/fused_enn.fused_gate) allowed it, ``core.mlp`` otherwise."""
    if fused:
        from graphinvent_tpu_torch.models.fused_enn import fused_mlp
        return fused_mlp(module, x)
    return mlp(module, x, train, generator)


def graph_gather(gather: GraphGather, hidden_nodes: torch.Tensor,
                 input_nodes: torch.Tensor, node_mask: torch.Tensor,
                 big_positive: float, train: bool = False,
                 fused: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """hidden_nodes (B,N,H), input_nodes (B,N,Fn), node_mask (B,N) -> (B,G).
    A node takes part iff it has degree >= 1; softmax over the node axis
    per output channel."""
    cat = torch.cat([hidden_nodes, input_nodes], dim=2)
    energy_mask = (1.0 - node_mask.to(cat.dtype)) * big_positive
    energies = _mlp(gather.att_nn, cat, train, fused, generator
                    ) - energy_mask[..., None]
    attention = torch.softmax(energies, dim=1)
    embedding = _mlp(gather.emb_nn, hidden_nodes, train, fused, generator)
    return torch.sum(attention * embedding, dim=1)


def global_readout(head: GlobalReadout, node_level_output: torch.Tensor,
                   graph_embedding: torch.Tensor, train: bool = False,
                   fused: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """node_level_output (B,N,H), graph_embedding (B,G) -> APD logits
    (B, N*f_add_elems + N*f_conn_elems + 1), no final activation."""
    B = node_level_output.shape[0]
    g = generator
    f_add_1 = _mlp(head.fAddNet1, node_level_output, train, fused, g
                   ).reshape(B, -1)
    f_conn_1 = _mlp(head.fConnNet1, node_level_output, train, fused, g
                    ).reshape(B, -1)
    f_add_2 = _mlp(head.fAddNet2, torch.cat([f_add_1, graph_embedding], 1),
                   train, fused, g)
    f_conn_2 = _mlp(head.fConnNet2, torch.cat([f_conn_1, graph_embedding], 1),
                    train, fused, g)
    f_term_2 = _mlp(head.fTermNet2, graph_embedding, train, fused, g)
    return torch.cat([f_add_2, f_conn_2, f_term_2], dim=1)
