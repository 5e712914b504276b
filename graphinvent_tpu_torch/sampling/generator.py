"""Batched autoregressive graph generation on the device.

Counterpart of ``graphinvent_tpu/sampling/generator.py`` (reference
GraphGenerator, GraphGenerator.py:21-657).  The batch state -- node/edge
tensors, node counts, per-action log-likelihood slots and action ids,
done flags -- stays on the device; each round runs one model forward,
draws one action per row, decodes it against the seven invalid-action
classes and applies it.  The same contract as the JAX sampler:

  * each slot builds exactly one graph and freezes when it terminates or
    takes an invalid action;
  * a graph that reaches its action budget (cfg.gen_action_budget, slot
    L-1) without terminating is invalidated; at most L+4 rounds run;
  * the final log-likelihood is the sum of the per-action log p;
  * outputs are packed into one uint8 buffer with the JAX sampler's byte
    layout and fetched in one device-to-host copy.

Actions are drawn by Gumbel-max with an explicit ``torch.Generator``, in
place of ``jax.random.categorical`` with a key: the same distribution,
other numbers.  The early exit checks ``done.all()`` on the host once per
round, as the JAX while_loop's condition does on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from graphinvent_tpu_torch.chem.molgraph import MolGraph
from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.sampling.actions import (
    apply_actions, decode_actions, select_rows,
)
from graphinvent_tpu_torch.utils.device import compute_dtype, resolve_device

Params = Any


@dataclass
class SampleResult:
    graphs: List[MolGraph]               # batch_size generated graphs
    action_nlls: np.ndarray              # concatenated -log p per action
    final_loglikelihoods: np.ndarray     # (batch_size,) sum of log p
    properly_terminated: np.ndarray      # (batch_size,) 0/1
    n_rounds: int
    elapsed_s: float
    actions: Optional[np.ndarray] = None   # (batch_size, L) action ids
    t_counts: Optional[np.ndarray] = None  # (batch_size,) actions per graph
    done: Optional[np.ndarray] = None      # 0/1 per row


# what a generator is for: the fourth entry of its seed sequence
(STREAM_GENERATE, STREAM_EVALUATE, STREAM_DROPOUT, STREAM_TEST,
 STREAM_FINE_TUNE, STREAM_CONTINUATION) = range(6)


def seeded_generator(entropy: Sequence[int], device: torch.device,
                     stream: int = STREAM_GENERATE) -> torch.Generator:
    """A generator on ``device`` seeded from up to three integers and the
    ``stream`` it serves (the port's nested ``fold_in``).  numpy's
    SeedSequence ignores trailing zeros, so ``[s, k]`` and ``[s, k, 0]``
    would be one stream: the entropy is zero-padded to three entries and
    ``stream`` goes fourth, which keeps the uses apart whatever their
    counters are."""
    entropy = list(entropy)
    if len(entropy) > 3:
        raise ValueError("seeded_generator takes at most three integers")
    state = np.random.SeedSequence(
        entropy + [0] * (3 - len(entropy)) + [stream]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def batch_generator(seed: int, batch_idx: int, device: torch.device
                    ) -> torch.Generator:
    """The generator for sampling batch ``batch_idx`` of a job seeded with
    ``seed`` (the port's ``fold_in(PRNGKey(seed), batch_idx)``)."""
    return seeded_generator([seed, batch_idx], device)


def _sample_loop(cfg: GraphInventConfig, params: Params,
                 generator: torch.Generator, batch_size: int,
                 apply_fn: Callable, device: torch.device,
                 stop_round: Optional[int] = None,
                 init_state: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """``stop_round`` / ``init_state`` are the two-phase sampler's hooks
    (``sampling/two_phase.py``): phase 1 stops after ``stop_round`` rounds
    (rows still live then come back with done=0); the continuation starts
    the same loop from ``init_state``, the carried state of a batch of such
    rows (nodes, edges, n_nodes, t, ll, acts, done, term), with rounds
    counted from 0 again.  A carried row's actions are drawn from the same
    distribution as in one uninterrupted loop."""
    B = batch_size
    N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
    L = cfg.gen_action_budget
    max_rounds = L + 4
    if stop_round is not None:
        max_rounds = min(max_rounds, stop_round)
    dt = compute_dtype(cfg)

    state = dict(
        nodes=torch.zeros(B, N, Fn, dtype=dt, device=device),
        edges=torch.zeros(B, N, N, E, dtype=dt, device=device),
        n_nodes=torch.zeros(B, dtype=torch.long, device=device),
        t=torch.zeros(B, dtype=torch.long, device=device),  # actions taken
        ll=torch.zeros(B, L, dtype=torch.float32, device=device),
        acts=torch.zeros(B, L, dtype=torch.long, device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        term=torch.zeros(B, dtype=torch.bool, device=device))
    if init_state is not None:
        state.update({k: v.to(device, state[k].dtype, copy=True)
                      for k, v in init_state.items()})
    nodes, edges, n_nodes, t, ll, acts, done, term = state.values()
    rounds = 0

    while rounds < max_rounds and not bool(done.all()):
        logits = apply_fn(params, nodes, edges).float()
        logp = torch.log_softmax(logits, dim=1)
        u = torch.rand(logits.shape, generator=generator, device=device)
        action = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
        logp_sel = select_rows(logp, action)

        live = ~done
        dec = decode_actions(cfg, action, n_nodes, edges)
        overflow = t >= (L - 1)
        invalid = live & (dec.invalid | (overflow & ~dec.is_term))
        done_term = live & dec.is_term & ~invalid

        # record this action's log-likelihood and id in slot t (live rows)
        slot = t.clamp(0, L - 1)[:, None]
        ll.scatter_(1, slot, torch.where(
            live, logp_sel, ll.gather(1, slot)[:, 0])[:, None])
        acts.scatter_(1, slot, torch.where(
            live, action, acts.gather(1, slot)[:, 0])[:, None])
        t = t + live.long()

        # apply actions only to live, continuing graphs
        cont = live & ~invalid & ~dec.is_term
        dec = dec._replace(is_add=dec.is_add & cont,
                           is_conn=dec.is_conn & cont)
        nodes, edges, n_nodes = apply_actions(cfg, dec, nodes, edges, n_nodes)

        done = done | done_term | invalid
        term = term | done_term
        rounds += 1
    return (nodes.to(torch.uint8), edges.to(torch.uint8), n_nodes, ll, acts,
            term.to(torch.uint8), done.to(torch.uint8), t, rounds)


def _packbits(x: torch.Tensor) -> torch.Tensor:
    """(B, n) 0/1 -> (B, ceil(n/8)) uint8, most significant bit first
    (``np.packbits``' order)."""
    B, n = x.shape
    x = F.pad(x.to(torch.int32), (0, (-n) % 8)).reshape(B, -1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=x.device)
    return (x * weights).sum(dim=2).to(torch.uint8)


def _pack_outputs(nodes, edges, n_nodes, ll, acts, term, done, t, rounds
                  ) -> torch.Tensor:
    """All sampler outputs in ONE uint8 buffer, the JAX sampler's layout:
    bit-packed nodes and edges, n_nodes, term, done, t (lo, hi), action ids
    (all lo bytes, then all hi bytes), ll as little-endian f32 bytes,
    rounds (lo, hi)."""
    B = nodes.shape[0]

    def col(v):
        return v.to(torch.uint8).reshape(B, 1)

    rounds_col = torch.full((B, 1), int(rounds), dtype=torch.int32,
                            device=nodes.device)
    return torch.cat([
        _packbits(nodes.reshape(B, -1)), _packbits(edges.reshape(B, -1)),
        col(n_nodes), col(term), col(done),
        col(t & 0xFF), col(t >> 8),
        (acts & 0xFF).to(torch.uint8), (acts >> 8).to(torch.uint8),
        ll.contiguous().view(torch.uint8).reshape(B, -1),
        col(rounds_col & 0xFF), col(rounds_col >> 8),
    ], dim=1)


def _row_layout(cfg: GraphInventConfig) -> Dict[str, Tuple[int, int]]:
    """Byte ranges of the fields of a packed row (``_pack_outputs``), and
    its length under ``row_bytes``."""
    N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
    L = cfg.gen_action_budget
    off: Dict = {}
    o = 0
    for name, width in (("nodes", (N * Fn + 7) // 8),
                        ("edges", (N * N * E + 7) // 8), ("n_nodes", 1),
                        ("term", 1), ("done", 1), ("t_lo", 1), ("t_hi", 1),
                        ("acts_lo", L), ("acts_hi", L), ("ll", 4 * L),
                        ("rounds", 2)):
        off[name] = (o, o + width)
        o += width
    off["row_bytes"] = o
    return off


def _packed_rounds(cfg: GraphInventConfig, packed: np.ndarray) -> int:
    """The rounds a packed batch ran (a field every row carries)."""
    lo, hi = packed[0, slice(*_row_layout(cfg)["rounds"])]
    return int(lo) | (int(hi) << 8)


class GraphSampler:
    """Batched on-device sampler (reference: GraphGenerator.sample,
    GraphGenerator.py:48-96)."""

    def __init__(self, cfg: GraphInventConfig, batch_size: int,
                 apply_fn: Optional[Callable] = None,
                 device: Optional[torch.device] = None) -> None:
        """``apply_fn(params, nodes, edges) -> logits``; by default the
        model forward ``params(nodes, edges)``."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device if device is not None else resolve_device(
            cfg.device)
        self.apply_fn = apply_fn or (lambda model, nodes, edges:
                                     model(nodes, edges))

    def sample_packed(self, params: Params, generator: torch.Generator,
                      stop_round: Optional[int] = None,
                      init_state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> np.ndarray:
        """Runs one batch; returns the packed buffer on the host.
        ``stop_round`` / ``init_state``: the two-phase sampler's hooks
        (``_sample_loop``)."""
        with torch.inference_mode():
            packed = _pack_outputs(*_sample_loop(
                self.cfg, params, generator, self.batch_size, self.apply_fn,
                self.device, stop_round=stop_round, init_state=init_state))
            return packed.cpu().numpy()                 # single transfer

    def sample(self, params: Params, generator: torch.Generator,
               quiet: bool = False) -> SampleResult:
        t0 = time.time()
        packed = self.sample_packed(params, generator)
        return self._decode_packed(packed, time.time() - t0, quiet)

    def _decode_packed(self, packed: np.ndarray, elapsed: float,
                       quiet: bool = False) -> SampleResult:
        cfg = self.cfg
        B = self.batch_size
        N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
        L = cfg.gen_action_budget

        off = _row_layout(cfg)

        def field(k):
            return packed[:, off[k][0]:off[k][1]]

        def bits(k, n):
            return np.unpackbits(np.ascontiguousarray(field(k)), axis=1,
                                 count=n)

        def lo_hi(lo, hi):
            return (field(lo).astype(np.uint16)
                    | (field(hi).astype(np.uint16) << 8)).astype(np.int32)
        nodes = bits("nodes", N * Fn).reshape(B, N, Fn).astype(np.float32)
        edges = bits("edges", N * N * E).reshape(B, N, N, E).astype(np.float32)
        n_nodes = field("n_nodes")[:, 0].astype(np.int32)
        term = field("term")[:, 0].astype(np.int8)
        done = field("done")[:, 0].astype(np.int8)
        t_count = lo_hi("t_lo", "t_hi")[:, 0]
        acts = lo_hi("acts_lo", "acts_hi")
        ll = np.ascontiguousarray(field("ll")).view(np.float32).reshape(B, L)
        rounds = _packed_rounds(cfg, packed)

        graphs = [MolGraph(cfg, nodes[i], edges[i], int(n_nodes[i]))
                  for i in range(B)]
        # per-action NLLs: only the slots actually used by each graph
        mask = np.arange(L)[None, :] < t_count[:, None]
        action_nlls = -ll[mask]
        final_ll = ll.sum(axis=1)

        if not quiet:
            print(f"Generated {B} molecules in {elapsed:.4} s "
                  f"({B / max(elapsed, 1e-9):.5} molecules/s)", flush=True)
        return SampleResult(graphs=graphs, action_nlls=action_nlls,
                            final_loglikelihoods=final_ll,
                            properly_terminated=term, n_rounds=rounds,
                            elapsed_s=elapsed, actions=acts,
                            t_counts=t_count, done=done)
