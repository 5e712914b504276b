"""CLI entry point: ``python -m graphinvent_tpu_torch.main --job-dir <dir>``.

The same single-flag interface as ``graphinvent_tpu.main`` (reference
graphinvent/main.py:23-72): the job directory may hold an ``input.csv``
overriding any config field, including ``job_type`` (``preprocess``,
``train``, ``generate``, ``test`` or ``fine-tune``) and ``device``
(``cuda``, the default, or ``cpu``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.workflow import Workflow


def main(argv: Optional[Sequence[str]] = None) -> Workflow:
    parser = argparse.ArgumentParser(description="graphinvent-tpu (PyTorch)")
    parser.add_argument("--job-dir", default="./output/",
                        help="Job directory (may contain input.csv).")
    parser.add_argument("--job-type", default=None,
                        help="Override job_type from input.csv: preprocess, "
                        "train, generate, test or fine-tune.")
    parser.add_argument("--dataset-dir", default=None)
    parser.add_argument("--model", default=None)
    args = parser.parse_args(argv)

    cfg = GraphInventConfig.from_job_dir(args.job_dir)
    overrides = {}
    if args.job_type:
        overrides["job_type"] = args.job_type
    if args.dataset_dir:
        overrides["dataset_dir"] = args.dataset_dir
    if args.model:
        overrides["model"] = args.model
    if overrides:
        cfg = cfg.replace(**overrides)

    print(f"* Running {cfg.job_type} job ({cfg.model}) in {cfg.job_dir}",
          flush=True)
    workflow = Workflow(cfg)
    workflow.run()
    return workflow


if __name__ == "__main__":
    main()
