"""Scores generated molecules with the local MOSES-style metric suite.

Counterpart of the JAX package's ``tools/moses_metrics.py`` on
``eval/moses.py`` (validity, uniqueness@1k/@10k, novelty, Bemis-Murcko
scaffold uniqueness / novelty, IntDiv1/2, structural-alert pass rate, W1
property distances against the held-out split).  The reference leaves
this scoring to the external molsets/moses package
(tutorials/5_benchmarking_with_moses.md:1-6).  IntDiv's Gram matrix runs
on ``--device``; the host passes on ``--jobs`` worker processes.

    python -m graphinvent_tpu_torch.tools.moses_metrics \\
        "jobs/train-ggnn/generation/epoch_20_gen*.smi" \\
        --train data/train.smi [--test data/test.smi] [--jobs 8] \\
        [--n-intdiv 10000] [--device cuda|cpu] [--out metrics.json]

Prints a table and one final JSON line (NaN written as null).
"""

from __future__ import annotations

import argparse
import glob
import json
import time
from typing import Optional, Sequence

from graphinvent_tpu_torch.eval.moses import compute_metrics, read_smi


def clean(metrics: dict) -> dict:
    """Floats rounded to 4 places; NaN (an empty marginal) as None, since
    NaN is not JSON."""
    return {k: (None if isinstance(v, float) and v != v else
                round(v, 4) if isinstance(v, float) else v)
            for k, v in metrics.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("generated", nargs="+",
                    help=".smi files (globs ok) of generated molecules")
    ap.add_argument("--train", required=True, help="training-set .smi")
    ap.add_argument("--test", default=None, help="held-out .smi for the "
                    "property-W1 reference (defaults to --train)")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--n-intdiv", type=int, default=10000)
    ap.add_argument("--n-props", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    gen = []
    for pat in args.generated:
        for p in sorted(glob.glob(pat)) or [pat]:
            gen.extend(read_smi(p))
    train = read_smi(args.train)
    test = read_smi(args.test) if args.test else None
    print(f"generated={len(gen)} train={len(train)} "
          f"test={len(test) if test is not None else 0}", flush=True)

    t0 = time.time()
    metrics = compute_metrics(gen, train, test, n_jobs=args.jobs,
                              n_intdiv=args.n_intdiv, n_props=args.n_props,
                              seed=args.seed, device=args.device)
    metrics["wall_s"] = round(time.time() - t0, 1)
    for k, v in metrics.items():
        print(f"  {k:22s} {v:.4f}" if isinstance(v, float) else
              f"  {k:22s} {v}")
    out = clean(metrics)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
