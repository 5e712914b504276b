"""Two-phase straggler harvest for the sampling loop.

Counterpart of ``graphinvent_tpu/sampling/two_phase.py``.  The sampler
runs each batch until every row has terminated, so its last rounds pay a
full forward for a few live rows.  The two-phase scheme:

* **phase 1**: the sampler's loop, stopped after ``phase1_rounds`` rounds.
  Rows still live then come back frozen mid-build, with done=0 in the
  packed buffer;
* **continuation**: the live rows of several phase-1 batches are compacted
  into full batches of their carried state (the packed rows, uploaded as
  they are and unpacked on the device by :func:`_device_unpack_state`),
  and the same loop resumes them to completion.

This continues a row's state; it resamples nothing.  Each action of a
carried row is drawn from the distribution of one uninterrupted loop, so
there is no bias towards short molecules.  A row that finishes in phase 1
is byte-equal to the sampler's row for the same generator.  The kernel
serves phase 1 and the continuation as it serves the sampler.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_CONTINUATION, GraphSampler, Params, SampleResult, _packed_rounds,
    _row_layout, batch_generator, seeded_generator,
)

GeneratorFor = Callable[[int], torch.Generator]


def _unpackbits(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, nbytes) uint8 -> (B, n) 0/1 uint8, most significant bit first
    (``np.unpackbits``' order)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(x.shape[0], -1)[:, :n]


def _device_unpack_state(cfg: GraphInventConfig, packed: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Packed uint8 rows on the device -> the sampler loop's carried state
    (``_sample_loop``'s ``init_state``), on the device: the inverse of the
    fields ``_pack_outputs`` writes."""
    N, Fn, E = cfg.max_n_nodes, cfg.n_node_features, cfg.n_edge_features
    L = cfg.gen_action_budget
    B = packed.shape[0]
    off = _row_layout(cfg)

    def sl(k: str) -> torch.Tensor:
        return packed[:, off[k][0]:off[k][1]]

    def lo_hi(lo: str, hi: str) -> torch.Tensor:
        return sl(lo).long() | (sl(hi).long() << 8)

    return dict(
        nodes=_unpackbits(sl("nodes"), N * Fn).reshape(B, N, Fn),
        edges=_unpackbits(sl("edges"), N * N * E).reshape(B, N, N, E),
        n_nodes=sl("n_nodes")[:, 0].long(),
        t=lo_hi("t_lo", "t_hi")[:, 0],
        ll=sl("ll").contiguous().view(torch.float32).reshape(B, L),
        acts=lo_hi("acts_lo", "acts_hi"),
        done=sl("done")[:, 0] != 0,
        term=sl("term")[:, 0] != 0)


def window_generator(seed: int, start: int, n_batches: int,
                     device: torch.device) -> GeneratorFor:
    """The generators of a generate job's window of ``n_batches`` batches
    from batch ``start``: phase-1 batch i is the sampler's batch
    ``start + i`` (``batch_generator``), continuation c has a stream of its
    own."""
    def generator_for(i: int) -> torch.Generator:
        if i < n_batches:
            return batch_generator(seed, start + i, device)
        return seeded_generator([seed, start, i - n_batches], device,
                                STREAM_CONTINUATION)
    return generator_for


class TwoPhaseSampler(GraphSampler):
    """Phase-1 rollouts capped at ``phase1_rounds`` rounds and compacted
    continuations of their stragglers.

    In place of a loop over :meth:`GraphSampler.sample`:
    :meth:`sample_many` gives the same ``n_batches`` x ``batch_size``
    molecules, one SampleResult a batch (rows finished in phase 1
    byte-equal), at the cost of one more upload and loop per continuation
    batch for the tail rounds it saves."""

    def __init__(self, cfg: GraphInventConfig, batch_size: int,
                 phase1_rounds: int, apply_fn: Optional[Callable] = None,
                 device: Optional[torch.device] = None) -> None:
        super().__init__(cfg, batch_size, apply_fn, device)
        self.phase1_rounds = phase1_rounds
        self._off = _row_layout(cfg)

    def sample_many(self, params: Params, generator_for: GeneratorFor,
                    n_batches: int, quiet: bool = True
                    ) -> Tuple[List[SampleResult], Dict[str, float]]:
        """``n_batches`` batches; ``generator_for(i)`` gives phase-1 batch
        i's generator for i < n_batches and continuation batch
        i - n_batches's after.  Returns one SampleResult a batch (as
        ``GraphSampler.sample``'s, ``elapsed_s`` the window's share and
        ``n_rounds`` the batch's phase-1 rounds: per-row work is in
        ``t_counts``) and stats: stragglers, continuation batches, the
        rounds of every loop run, wall seconds."""
        B = self.batch_size
        d0 = self._off["done"][0]
        r0, r1 = self._off["rounds"]
        t0 = time.time()
        rounds = 0
        buffers: List[np.ndarray] = []
        pool: List[Tuple[int, int]] = []         # (batch, row) of stragglers
        for b in range(n_batches):
            packed = self.sample_packed(params, generator_for(b),
                                        stop_round=self.phase1_rounds)
            rounds += _packed_rounds(self.cfg, packed)
            buffers.append(packed)
            pool += [(b, int(i)) for i in np.nonzero(packed[:, d0] == 0)[0]]

        n_stragglers = len(pool)
        n_cont = 0
        while pool:
            take, pool = pool[:B], pool[B:]
            rows = np.stack([buffers[b][i] for b, i in take])
            if len(take) < B:                    # pad with done rows
                pad = np.repeat(rows[-1:], B - len(take), axis=0)
                pad[:, d0] = 1
                rows = np.concatenate([rows, pad])
            out = self.sample_packed(
                params, generator_for(n_batches + n_cont),
                init_state=_device_unpack_state(
                    self.cfg, torch.from_numpy(rows).to(self.device)))
            rounds += _packed_rounds(self.cfg, out)
            for k, (b, i) in enumerate(take):
                # keep the batch's phase-1 rounds field: the decoder reads
                # n_rounds from row 0, and the continuation's own count is
                # not this batch's
                phase1 = buffers[b][i, r0:r1].copy()
                buffers[b][i] = out[k]
                buffers[b][i, r0:r1] = phase1
            n_cont += 1

        wall = time.time() - t0
        per_batch = wall / max(n_batches, 1)
        results = [self._decode_packed(buf, per_batch, quiet)
                   for buf in buffers]
        stats = dict(n_stragglers=n_stragglers, n_continuation=n_cont,
                     rounds=rounds, wall_s=wall,
                     straggler_frac=n_stragglers / max(n_batches * B, 1))
        return results, stats
