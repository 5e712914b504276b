"""A/B: the single-phase sampler against the two-phase straggler harvest.

Counterpart of the JAX package's ``tools/ab_two_phase.py``: runs
``sampling/two_phase.TwoPhaseSampler`` (phase 1 capped at R rounds, the
stragglers continued in compacted batches) against the plain
``GraphSampler`` on one checkpoint and reports molecules/s both ways,
the stragglers, the rounds each way and the action-count distribution.

    python -m graphinvent_tpu_torch.tools.ab_two_phase <ckpt> \\
        [batch_size] [dtype] [max_atoms] [aromatic] [R] [n_batches] \\
        [--device cuda|cpu]

``ckpt`` is a ``.pth`` or the JAX package's ``.ckpt``; use a trained one,
since random weights end their rows in a few rounds and leave no tail.
Both ways draw the same phase-1 batches (``batch_generator(17, b)``), so
rows finished in phase 1 are the same rows.  Each way runs once to warm
up, then three times in turns; the fastest of the three counts.  R
defaults to about the median action count (the JAX package's occupancy
study: 16 at N=13, 37 at N=40, 57 at N=80).  The last line printed is one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from graphinvent_tpu_torch.config import GraphInventConfig, preset
from graphinvent_tpu_torch.tools.common import device_report, load_model, sync
from graphinvent_tpu_torch.utils.device import resolve_device

DEFAULT_R = {13: 16, 40: 37, 80: 57}
SEED = 17


def checkpoint_config(max_atoms: int, aromatic: bool, dtype: str,
                      batch_size: int, device: str) -> GraphInventConfig:
    """The GGNN preset at ``max_atoms`` nodes; ``aromatic`` adds the
    aromatic bond type (ChEMBL-proxy data)."""
    return preset("GGNN", compute_dtype=dtype, max_n_nodes=max_atoms,
                  use_aromatic_bonds=aromatic, batch_size=batch_size,
                  device=device)


def action_counts(t_counts: np.ndarray) -> Dict[str, float]:
    return {"mean": float(t_counts.mean()),
            "p50": float(np.percentile(t_counts, 50)),
            "p90": float(np.percentile(t_counts, 90)),
            "p99": float(np.percentile(t_counts, 99)),
            "max": int(t_counts.max())}


def ab(cfg: GraphInventConfig, model: torch.nn.Module, R: int,
       n_batches: int, repeats: int = 3) -> Dict[str, object]:
    """Both samplers on ``n_batches`` batches of ``cfg.batch_size``."""
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    from graphinvent_tpu_torch.sampling.two_phase import (
        TwoPhaseSampler, window_generator,
    )
    device = resolve_device(cfg.device)
    B = cfg.batch_size
    single = GraphSampler(cfg, B, device=device)
    two = TwoPhaseSampler(cfg, B, R, device=device)

    def run_single():
        sync(device)
        t0 = time.perf_counter()
        res = [single.sample(model, batch_generator(SEED, b, device),
                             quiet=True) for b in range(n_batches)]
        return time.perf_counter() - t0, res

    def run_two():
        sync(device)
        t0 = time.perf_counter()
        res, stats = two.sample_many(
            model, window_generator(SEED, 0, n_batches, device), n_batches)
        return time.perf_counter() - t0, res, stats

    n_mols = B * n_batches
    best_s = best_t = float("inf")
    for rep in range(repeats + 1):
        dt_s, res_s = run_single()
        dt_t, res_t, stats = run_two()
        if rep:                          # rep 0 warms both up
            best_s, best_t = min(best_s, dt_s), min(best_t, dt_t)
    t_counts = np.concatenate([r.t_counts for r in res_s])
    return {"batch": B, "n": cfg.max_n_nodes, "dtype": cfg.compute_dtype,
            "R": R, "n_batches": n_batches, "molecules": n_mols,
            "single_s": best_s, "two_phase_s": best_t,
            "single_molecules_per_s": n_mols / best_s,
            "two_phase_molecules_per_s": n_mols / best_t,
            "speedup": best_s / best_t,
            "single_rounds": int(sum(r.n_rounds for r in res_s)),
            "two_phase_rounds": int(stats["rounds"]),
            "n_stragglers": int(stats["n_stragglers"]),
            "straggler_frac": float(stats["straggler_frac"]),
            "n_continuation": int(stats["n_continuation"]),
            "terminated_single": int(sum(int(r.properly_terminated.sum())
                                         for r in res_s)),
            "terminated_two_phase": int(sum(int(r.properly_terminated.sum())
                                            for r in res_t)),
            "actions": action_counts(t_counts), **device_report(device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("batch_size", nargs="?", type=int, default=500)
    ap.add_argument("dtype", nargs="?", default="bfloat16")
    ap.add_argument("max_atoms", nargs="?", type=int, default=80)
    ap.add_argument("aromatic", nargs="?", default="true")
    ap.add_argument("R", nargs="?", type=int, default=None)
    ap.add_argument("n_batches", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    aromatic = args.aromatic.lower() in ("1", "true", "aromatic")
    cfg = checkpoint_config(args.max_atoms, aromatic, args.dtype,
                            args.batch_size, args.device)
    model = load_model(cfg, args.checkpoint)
    R = args.R or DEFAULT_R.get(args.max_atoms, int(args.max_atoms * 0.72))
    out = ab(cfg, model, R, args.n_batches)
    print(f"B={out['batch']} N={out['n']} dtype={out['dtype']} R={R} "
          f"n_batches={args.n_batches} [{out['card'] or out['device']}]")
    print(f"single-phase : {out['single_s']:7.3f} s "
          f"{out['single_molecules_per_s']:9.1f} mol/s "
          f"({out['single_rounds']} rounds)")
    print(f"two-phase    : {out['two_phase_s']:7.3f} s "
          f"{out['two_phase_molecules_per_s']:9.1f} mol/s "
          f"({out['two_phase_rounds']} rounds, {out['speedup']:.2f}x)")
    print(f"stragglers   : {out['n_stragglers']}/{out['molecules']} "
          f"({100 * out['straggler_frac']:.1f}%), "
          f"{out['n_continuation']} continuation batches; actions a row "
          f"{out['actions']}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
