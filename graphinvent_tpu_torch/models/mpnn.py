"""Message-passing networks; GGNN is ported, the other five are not yet.

Counterpart of ``graphinvent_tpu/models/mpnn.py``: every model runs over
the padded dense tensors, nodes (B, N, Fn) and edges (B, N, N, E), and
returns APD logits (B, dim_apd).  Per-edge-type message MLPs are applied
to all node states, Y_e = f_e(H), and the messages are the adjacency
contraction m = sum_e A_e @ Y_e.  Nodes of degree 0 keep their state.

The GGNN's ``state_dict`` has the reference GraphINVENT layout
(gnn/mpnn.py:229-303): ``msg_nns.{e}.seq.{3l}.*``, ``gru.*``,
``gather.*``, ``APDReadout.*``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.models.core import (
    MLP, GRUCellParams, gru_cell, stacked_mlp,
)
from graphinvent_tpu_torch.models.fused_enn import (
    fused_gate, fused_stacked_mlp,
)
from graphinvent_tpu_torch.models.readout import (
    GlobalReadout, GraphGather, global_readout, graph_gather,
)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _prepare(cfg: GraphInventConfig, nodes: torch.Tensor, edges: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (hidden0 (B,N,H), adjacency (B,N,N), degree (B,N), node_mask (B,N))."""
    adjacency = edges.sum(dim=3)
    degree = adjacency.sum(dim=-1)
    node_mask = degree != 0
    B, N, Fn = nodes.shape
    hidden = nodes.new_zeros(B, N, cfg.hidden_node_features)
    hidden[:, :, :Fn] = nodes
    return hidden, adjacency, degree, node_mask


def _masked_update(gru: nn.GRUCell, messages: torch.Tensor,
                   hidden: torch.Tensor, node_mask: torch.Tensor
                   ) -> torch.Tensor:
    """GRU update applied only to nodes with degree >= 1."""
    updated = gru_cell(gru, messages, hidden)
    return torch.where(node_mask[..., None], updated, hidden)


def _edge_type_contraction(edges: torch.Tensor, per_type: torch.Tensor
                           ) -> torch.Tensor:
    """m_i = sum_e sum_j edges[b,i,j,e] * per_type[e,b,j,m], accumulated in
    f32 and rounded to per_type's dtype (a plain batched product, left to
    the library as the JAX package leaves it to XLA)."""
    B, N, _, E = edges.shape
    lhs = edges.reshape(B, N, N * E).float()
    rhs = per_type.permute(1, 2, 0, 3).reshape(B, N * E, -1).float()
    return torch.bmm(lhs, rhs).to(per_type.dtype)


def _enn_stack(cfg: GraphInventConfig, msg_nns: nn.ModuleList,
               hidden: torch.Tensor, train: bool,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stacked per-edge-type MLP towers: the fused kernel on grad-free
    forwards, ``core.stacked_mlp`` when training."""
    if fused_gate(cfg, train):
        return fused_stacked_mlp(msg_nns, hidden)
    return stacked_mlp(list(msg_nns), hidden, train, generator)


# --------------------------------------------------------------------------
# GGNN (reference gnn/mpnn.py:229-303)
# --------------------------------------------------------------------------

class GGNN(nn.Module):
    def __init__(self, cfg: GraphInventConfig,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        g = generator
        self.msg_nns = nn.ModuleList(
            MLP(cfg.hidden_node_features, [cfg.enn_hidden_dim] * cfg.enn_depth,
                cfg.message_size, cfg.enn_dropout_p, g)
            for _ in range(cfg.n_edge_features))
        self.gru = GRUCellParams(cfg.message_size, cfg.hidden_node_features, g)
        self.gather = GraphGather(
            cfg.n_node_features, cfg.hidden_node_features, cfg.gather_width,
            cfg.gather_att_depth, cfg.gather_att_hidden_dim,
            cfg.gather_emb_depth, cfg.gather_emb_hidden_dim,
            cfg.gather_att_dropout_p, cfg.gather_emb_dropout_p, g)
        self.APDReadout = GlobalReadout(
            cfg.len_f_add_per_node, cfg.len_f_conn_per_node, 1,
            cfg.mlp1_depth, cfg.mlp1_hidden_dim,
            cfg.mlp2_depth, cfg.mlp2_hidden_dim,
            graph_emb_size=cfg.gather_width, max_n_nodes=cfg.max_n_nodes,
            node_emb_size=cfg.hidden_node_features,
            mlp1_dropout_p=cfg.mlp1_dropout_p,
            mlp2_dropout_p=cfg.mlp2_dropout_p, generator=g)

    def forward(self, nodes: torch.Tensor, edges: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (on the tensors' device) draws the dropout masks
        of a training forward, layer by layer in forward order."""
        cfg = self.cfg
        hidden, _, _, node_mask = _prepare(cfg, nodes, edges)
        for _ in range(cfg.message_passes):
            per_type = _enn_stack(cfg, self.msg_nns, hidden, train, generator)
            messages = _edge_type_contraction(edges, per_type)
            hidden = _masked_update(self.gru, messages, hidden, node_mask)
        fused = fused_gate(cfg, train)
        graph_emb = graph_gather(self.gather, hidden, nodes, node_mask,
                                 cfg.big_positive, train, fused, generator)
        return global_readout(self.APDReadout, hidden, graph_emb, train,
                              fused, generator)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {"GGNN": GGNN}


def build_model(cfg: GraphInventConfig,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The port's model for ``cfg.model`` (f32 weights on the CPU; move
    it with ``.to(device)``)."""
    if cfg.model not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported to PyTorch yet; the port "
            f"has {sorted(MODEL_REGISTRY)} (see ROADMAP.md, queue A)")
    return MODEL_REGISTRY[cfg.model](cfg, generator)
