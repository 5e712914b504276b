"""Stage breakdown of the RL fine-tune step.

Counterpart of the JAX package's ``tools/profile_rl.py``:

    python -m graphinvent_tpu_torch.tools.profile_rl [batch_size] [steps] \\
        [--preset GGNN] [--checkpoint path.pth|.ckpt] [--max-atoms N] \\
        [--aromatic] [--dtype bfloat16] [--score QED] [--remat-segment 1] \\
        [--device cuda|cpu]

Runs a fine-tune job through ``Workflow`` in a temporary job dir, for
``steps`` + 1 learning steps, and reports the mean of each piece of
``FineTuner.step_timings`` over the last ``steps`` (the first step warms
up): agent_rollout, prior_replay (forward-only, the kernel),
basf_rollout_and_replay, scoring (the rest of the host scoring, which
runs on a worker thread beside the replays and the BASF rollout, and the
targets), grad_forward and grad_backward (the gradient replay, plain
path, checkpointed every ``--remat-segment`` steps) and adam.  On the card
each piece runs between CUDA events recorded at its end.  The JSON line
also carries ``scoring_wait_s``, the mean host seconds the step waited for
that worker.  The JAX tool times
its jitted programs one by one; here the pieces are the job's own.
Without ``--checkpoint`` the model has seeded random weights, whose
rollouts are mostly invalid, so scoring is cheaper than on a trained
model's.  The last line printed is one JSON object with the pieces'
means.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from graphinvent_tpu_torch.config import preset
from graphinvent_tpu_torch.tools.common import device_report, load_model


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_size", nargs="?", type=int, default=500)
    ap.add_argument("steps", nargs="?", type=int, default=3)
    ap.add_argument("--preset", default="GGNN")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--max-atoms", type=int, default=13)
    ap.add_argument("--aromatic", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--score", default="QED",
                    help="comma-joined score_components")
    ap.add_argument("--remat-segment", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    from graphinvent_tpu_torch.utils.weights import save_checkpoint
    from graphinvent_tpu_torch.workflow import Workflow

    comps = tuple(args.score.split(","))
    with tempfile.TemporaryDirectory(prefix="profile_rl_") as tmp:
        pre, job = os.path.join(tmp, "pretrained"), os.path.join(tmp, "job")
        os.makedirs(pre)
        os.makedirs(job)
        cfg = preset(args.preset, job_type="fine-tune",
                     batch_size=args.batch_size, max_n_nodes=args.max_atoms,
                     compute_dtype=args.dtype,
                     use_aromatic_bonds=args.aromatic,
                     score_components=comps, score_type="continuous",
                     score_thresholds=tuple(0.0 for _ in comps),
                     qsar_models={}, rl_remat_segment=args.remat_segment,
                     epochs=args.steps + 1, sample_every=args.steps + 2,
                     pretrained_model_dir=pre + "/", dataset_dir=pre + "/",
                     job_dir=job + "/", tensorboard_dir="",
                     device=args.device)
        save_checkpoint(load_model(cfg, args.checkpoint).cpu(), pre, 1)
        workflow = Workflow(cfg)
        workflow.run()
        tuner = workflow.fine_tuner
        timed = tuner.step_timings[1:]
        means = {k: float(np.mean([t[k] for t in timed])) for k in timed[0]}
        report = device_report(workflow.device)
    print(f"preset={args.preset} B={cfg.batch_size} N={cfg.max_n_nodes} "
          f"score={comps} ckpt={bool(args.checkpoint)} {report}")
    print(f"per-step pieces (mean of {len(timed)} steps after a warm-up "
          "step):")
    for name, secs in means.items():
        print(f"  {name:26s} {secs * 1e3:9.1f} ms")
    total = sum(means.values())
    print(f"  {'TOTAL':26s} {total * 1e3:9.1f} ms/step")
    out = {"preset": args.preset, "batch": cfg.batch_size,
           "n": cfg.max_n_nodes, "steps": len(timed), "pieces_s": means,
           "step_s": total, "replay_steps": tuner.replay_steps[2:],
           "scoring_wait_s": float(np.mean(tuner.scoring_waits[1:])),
           **report}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
