"""Job submission: writes a job dir's ``input.csv`` and runs the job.

Counterpart of the JAX package's ``tools/submit.py`` (which replaces the
reference's submit-pre-training.py / submit-fine-tuning.py): writes the
job's ``input.csv`` into ``--job-dir``, then runs it with
``python -m graphinvent_tpu_torch.main`` or writes a SLURM batch file.

    python -m graphinvent_tpu_torch.tools.submit --job-dir jobs/my-run \\
        --job-type train --dataset-dir data/gdb13_1K/ --model GGNN \\
        [--device cuda|cpu] [--set epochs=400 --set batch_size=1000] \\
        [--pipeline preprocess,train,generate,test] [--slurm out.sh]

``--pipeline`` runs several stages in one process over the same job dir
(the checkpoints ``train`` writes are what ``generate`` and ``test``
load): the kernel's library and the native chemistry are loaded once.
``--slurm`` writes a batch file that runs this tool again with the same
arguments.  The last line printed is one JSON object: the job dir, the
stages and the seconds each took.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from graphinvent_tpu_torch.config import GraphInventConfig

STAGES = ("preprocess", "train", "generate", "test", "fine-tune")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def module_env() -> Dict[str, str]:
    """This process's environment with the repo on ``PYTHONPATH``, for
    ``python -m graphinvent_tpu_torch...`` subprocesses from any
    directory."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ,
                PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def run_pipeline(cfg: GraphInventConfig, stages: Sequence[str]
                 ) -> Dict[str, float]:
    """Runs ``stages`` one after the other in this process over
    ``cfg.job_dir``; -> seconds per stage.  Every stage's config is
    validated before the first one runs."""
    from graphinvent_tpu_torch.workflow import Workflow
    stage_cfgs = {stage: cfg.replace(job_type=stage) for stage in stages}
    seconds = {}
    for stage in stages:
        stage_cfg = stage_cfgs[stage]
        # the running stage's input.csv stays behind for a restart
        stage_cfg.write_csv(os.path.join(cfg.job_dir, "input.csv"))
        t0 = time.time()
        print(f"== pipeline stage [{stage}] -> {cfg.job_dir}", flush=True)
        Workflow(stage_cfg).run()
        seconds[stage] = time.time() - t0
        print(f"== [{stage}] done in {seconds[stage]:.1f} s", flush=True)
    return seconds


def parse_sets(pairs: Sequence[str]) -> Dict[str, object]:
    """``["key=value", ...]`` -> overrides, values parsed as in input.csv."""
    out = {}
    for kv in pairs:
        key, _, value = kv.partition("=")
        out[key] = GraphInventConfig._parse_value(value)
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job-dir", required=True)
    ap.add_argument("--job-type", default="train")
    ap.add_argument("--pipeline", default=None,
                    help="comma-separated stages to run in ONE process, "
                         "e.g. preprocess,train,generate,test "
                         "(overrides --job-type)")
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--model", default="GGNN")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", action="append", default=[],
                    help="key=value config override (repeatable)")
    ap.add_argument("--slurm", default=None,
                    help="write a SLURM script here instead of running")
    ap.add_argument("--time", default="1-00:00:00")
    ap.add_argument("--dry-run", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    stages: List[str] = []
    if args.pipeline:
        stages = [s.strip() for s in args.pipeline.split(",") if s.strip()]
        unknown = [s for s in stages if s not in STAGES]
        if unknown:
            raise SystemExit(f"unknown pipeline stage(s) {unknown}; "
                             f"choose from {STAGES}")

    overrides = {"job_type": stages[0] if stages else args.job_type,
                 "dataset_dir": args.dataset_dir, "model": args.model,
                 "device": args.device}
    overrides.update(parse_sets(args.set))
    job_dir = args.job_dir if args.job_dir.endswith("/") else args.job_dir + "/"
    overrides["job_dir"] = job_dir
    cfg = GraphInventConfig.from_overrides(overrides)
    os.makedirs(job_dir, exist_ok=True)
    cfg.write_csv(os.path.join(job_dir, "input.csv"))
    print(f"wrote {job_dir}input.csv", flush=True)

    result = {"job_dir": job_dir, "stages": stages or [cfg.job_type],
              "device": cfg.device, "seconds": {}}
    if args.slurm:
        # the batch job runs this tool again, minus the SLURM options
        rerun, skip = [], 0
        for a in argv:
            if skip:
                skip -= 1
            elif a in ("--slurm", "--time"):
                skip = 1
            elif not a.startswith(("--slurm=", "--time=")):
                rerun.append(a)
        cmd = [sys.executable, "-m", "graphinvent_tpu_torch.tools.submit",
               *rerun]
        with open(args.slurm, "w") as fh:
            fh.write("#!/bin/bash\n"
                     f"#SBATCH --job-name=graphinvent-{cfg.job_type}\n"
                     f"#SBATCH --time={args.time}\n"
                     "#SBATCH --nodes=1\n"
                     + ("#SBATCH --gres=gpu:1\n" if cfg.device == "cuda"
                        else "") + "\n"
                     + shlex.join(cmd) + "\n")
        print(f"wrote {args.slurm}; submit with: sbatch {args.slurm}")
        result["slurm"] = args.slurm
    elif args.dry_run:
        pass
    elif stages:
        result["seconds"] = run_pipeline(cfg, stages)
    else:
        t0 = time.time()
        rc = subprocess.call([sys.executable, "-m",
                              "graphinvent_tpu_torch.main",
                              "--job-dir", job_dir], env=module_env())
        if rc != 0:
            raise SystemExit(rc)
        result["seconds"] = {cfg.job_type: time.time() - t0}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
