"""The sampler's round occupancy: how many rows are still live per round.

Counterpart of the JAX package's ``tools/occupancy.py``.  The sampler
runs its loop until every row of the batch is done, so late rounds pay a
whole forward for mostly finished rows.  A row taking T actions is live
in rounds 0 .. T-1, so the live-row curve follows from the batch's
``t_counts`` with no extra device work.

    python -m graphinvent_tpu_torch.tools.occupancy <ckpt> [batch] \\
        [dtype] [max_atoms] [aromatic] [batches] [--device cuda|cpu]

Prints the live fraction per round and, for caps R at which 50 ... 99% of
rows are done, the amortized rounds of a two-phase scheme (phase 1 runs R
rounds, the rows live at R are continued in compacted batches):

    rounds(R) = R + f(R) * (T_obs - R)        f(R) = live fraction at R

The best cap's speedup is the ceiling such a scheme could reach before
the cost of carrying rows over; ``tools/ab_two_phase.py`` measures the
scheme itself.  The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.tools.ab_two_phase import (
    action_counts, checkpoint_config,
)
from graphinvent_tpu_torch.tools.common import device_report, load_model, sync
from graphinvent_tpu_torch.utils.device import resolve_device


def occupancy_curve(t_counts: np.ndarray, n_rounds: int) -> np.ndarray:
    """live_fraction[r] = fraction of rows still sampling at round r."""
    r = np.arange(n_rounds)
    return (t_counts[:, None] > r[None, :]).mean(axis=0)


def caps(live: np.ndarray, n_rounds: int) -> list:
    """(R, done fraction at R, amortized rounds, projected speedup) for the
    caps at which 50, 75, 90, 95 and 99% of rows are done."""
    out = []
    for frac in (0.5, 0.75, 0.9, 0.95, 0.99):
        R = int(np.searchsorted(-live, -(1 - frac)))
        R = min(max(R, 1), n_rounds)
        f = float(live[min(R, n_rounds - 1)])
        amort = R + f * (n_rounds - R)
        out.append({"R": R, "done": 1 - f, "rounds": amort,
                    "speedup": n_rounds / amort})
    return out


def occupancy(cfg: GraphInventConfig, model: torch.nn.Module,
              batches: int = 3) -> Dict[str, object]:
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    device = resolve_device(cfg.device)
    sampler = GraphSampler(cfg, cfg.batch_size, device=device)
    all_t, n_rounds = [], 0
    sync(device)
    t0 = time.perf_counter()
    for k in range(batches):
        res = sampler.sample(model, batch_generator(0, k, device), quiet=True)
        all_t.append(res.t_counts)
        n_rounds = max(n_rounds, res.n_rounds)
    wall = time.perf_counter() - t0
    t_counts = np.concatenate(all_t)
    live = occupancy_curve(t_counts, n_rounds)
    return {"batch": cfg.batch_size, "n": cfg.max_n_nodes,
            "dtype": cfg.compute_dtype, "batches": batches, "wall_s": wall,
            "rounds": n_rounds, "budget": cfg.gen_action_budget + 4,
            "actions": action_counts(t_counts),
            "live": [float(x) for x in live],
            "mean_occupancy": float(live.mean()),
            "caps": caps(live, n_rounds), **device_report(device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("batch", nargs="?", type=int, default=1000)
    ap.add_argument("dtype", nargs="?", default="bfloat16")
    ap.add_argument("max_atoms", nargs="?", type=int, default=40)
    ap.add_argument("aromatic", nargs="?", default="true")
    ap.add_argument("batches", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    aromatic = args.aromatic.lower() in ("1", "true", "aromatic")
    cfg = checkpoint_config(args.max_atoms, aromatic, args.dtype, args.batch,
                            args.device)
    out = occupancy(cfg, load_model(cfg, args.checkpoint), args.batches)
    print(f"N={out['n']} B={out['batch']} {out['dtype']} aromatic={aromatic}"
          f" ({out['batches']} batches, {out['wall_s']:.1f} s incl. warm-up)"
          f" [{out['card'] or out['device']}]")
    print(f"rounds run: {out['rounds']}  budget: {out['budget']}; actions a "
          f"row {out['actions']}")
    print("round  live%")
    live = out["live"]
    for r in range(0, len(live), max(1, len(live) // 20)):
        print(f"{r:5d}  {100 * live[r]:5.1f}  {'#' * int(live[r] * 40)}")
    print(f"mean occupancy {100 * out['mean_occupancy']:.1f}%")
    for c in out["caps"]:
        print(f"cap R={c['R']:4d}  done {100 * c['done']:5.1f}%  rounds "
              f"{c['rounds']:8.1f}  projected {c['speedup']:.2f}x")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
