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

On one process's mesh (``mesh``) the rows of a batch split over the
``data`` axis and are replicated over ``model`` and ``graph``, as in the
JAX package (no graph-axis split in the rollout): each rank draws the
global batch's uniforms and keeps its rows, ``done.all()`` is reduced
over the group each round so that every rank runs the same rounds, and the
packed rows are gathered in row order, so that a batch's bytes are a
one-device batch's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
)

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


class SampleHandle(NamedTuple):
    """A batch from ``GraphSampler.sample_async``: its packed buffer on the
    host (pinned; complete once ``copied`` has fired, None on the CPU) and
    the host clock when the batch started."""
    packed: torch.Tensor
    copied: Optional[Any]
    started: float


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
                 init_state: Optional[Dict[str, torch.Tensor]] = None,
                 mesh: Any = None) -> Tuple[torch.Tensor, ...]:
    """``stop_round`` / ``init_state`` are the two-phase sampler's hooks
    (``sampling/two_phase.py``): phase 1 stops after ``stop_round`` rounds
    (rows still live then come back with done=0); the continuation starts
    the same loop from ``init_state``, the carried state of a batch of such
    rows (nodes, edges, n_nodes, t, ll, acts, done, term), with rounds
    counted from 0 again.  A carried row's actions are drawn from the same
    distribution as in one uninterrupted loop.  ``mesh``: this rank's rows
    of the batch on the data axis (the module docstring)."""
    rows = slice(0, batch_size)
    if mesh is not None and mesh.size > 1:
        from graphinvent_tpu_torch.parallel.mesh import data_rows
        rows = data_rows(batch_size, mesh)
    B = rows.stop - rows.start
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

    while rounds < max_rounds and not _all_done(done, mesh):
        logits = apply_fn(params, nodes, edges).float()
        logp = torch.log_softmax(logits, dim=1)
        u = torch.rand((batch_size, logits.shape[1]), generator=generator,
                       device=device)[rows]
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


def _all_done(done: torch.Tensor, mesh: Any) -> bool:
    """True once every row of the batch is done, on every rank alike."""
    if mesh is None or mesh.size == 1:
        return bool(done.all())
    import torch.distributed as dist
    flag = done.all().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


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
                 device: Optional[torch.device] = None,
                 mesh: Any = None) -> None:
        """``apply_fn(params, nodes, edges) -> logits``; by default the
        model forward ``params(nodes, edges)``.  ``mesh``: one process's
        mesh, whose ranks all sample every batch together (rows over
        ``data``); every rank gets the whole batch."""
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.batch_size = batch_size
        self.device = device if device is not None else resolve_device(
            cfg.device)
        self.apply_fn = apply_fn or (lambda model, nodes, edges:
                                     model(nodes, edges))

    def sample_async(self, params: Params, generator: torch.Generator,
                     stop_round: Optional[int] = None,
                     init_state: Optional[Dict[str, torch.Tensor]] = None
                     ) -> "SampleHandle":
        """Runs one batch and starts its packed buffer's copy to the host
        without waiting for it; pair with :meth:`finish`.  The counterpart
        of the JAX sampler's ``sample_async`` / ``finish``
        (``graphinvent_tpu/sampling/generator.py:241-256``).

        What differs from JAX: the JAX program runs its whole rollout
        ahead of the host, while this round loop reads ``done`` on the
        host every round (``_all_done``), so the rollout itself has run
        when this returns; only the pack's device-to-host copy (into
        pinned memory, ``non_blocking``, behind a CUDA event) is still in
        flight.  A caller overlaps host work with the device by running it
        on another thread (``rl/workflow_rl.FineTuner.step``).  On a mesh
        the rows are gathered here, on the calling thread.
        ``stop_round`` / ``init_state``: the two-phase sampler's hooks
        (``_sample_loop``)."""
        t0 = time.time()
        with torch.inference_mode():
            packed = _pack_outputs(*_sample_loop(
                self.cfg, params, generator, self.batch_size, self.apply_fn,
                self.device, stop_round=stop_round, init_state=init_state,
                mesh=self.mesh))
            if self.mesh is not None:
                from graphinvent_tpu_torch.parallel.mesh import (
                    gather_data_rows,
                )
                packed = gather_data_rows(packed, self.mesh)
            if packed.device.type != "cuda":
                return SampleHandle(packed, None, t0)
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)     # single transfer
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(packed.device))
            return SampleHandle(host, copied, t0)

    @staticmethod
    def fetch(handle: "SampleHandle") -> np.ndarray:
        """The packed buffer of a :meth:`sample_async` handle on the host,
        once its copy has landed."""
        if handle.copied is not None:
            handle.copied.synchronize()
        return handle.packed.numpy()

    def finish(self, handle: "SampleHandle", quiet: bool = False
               ) -> SampleResult:
        """Waits for a :meth:`sample_async` handle's copy and decodes it."""
        packed = self.fetch(handle)
        return self._decode_packed(packed, time.time() - handle.started,
                                   quiet)

    def sample_packed(self, params: Params, generator: torch.Generator,
                      stop_round: Optional[int] = None,
                      init_state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> np.ndarray:
        """Runs one batch; returns the packed buffer on the host."""
        return self.fetch(self.sample_async(params, generator, stop_round,
                                            init_state))

    def sample(self, params: Params, generator: torch.Generator,
               quiet: bool = False) -> SampleResult:
        return self.finish(self.sample_async(params, generator), quiet)

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
