"""The ChEMBL-scale acceptance campaign, end to end, in one command.

Counterpart of the JAX package's ``tools/campaign_chembl.py``.  The
reference's acceptance test is "train on MOSES, generate 30k, evaluate"
(reference: tutorials/5_benchmarking_with_moses.md:1-6) on datasets of
<= 80 heavy atoms with charges {-1, 0, 1} (tools/tdc-create-dataset.py).
With nothing downloaded, the campaign synthesizes a ChEMBL-proxy dataset
(C, N, O, S, Cl; charges -1/0/+1; aromatic bonds, so E = 4) and runs the
job flow of a MOSES campaign: sharded preprocess -> combine -> train ->
generate -> test -> score.  Every stage is an ordinary job of the port.

    python -m graphinvent_tpu_torch.tools.campaign_chembl --root runs/c40 \\
        [--n 6000] [--min-atoms 25] [--max-atoms 40] [--shards 4] \\
        [--epochs 40] [--model GGNN] [--n-generate 30000] \\
        [--device cuda|cpu] [--in-process] [--stage all] [--set key=value]

Stages: data, preprocess, train, generate, test, score.
* data: ``utils/synthetic.synthesize_smiles`` (``raw.smi``), then the
  JAX package's ``tools/create_dataset.py`` filter and split (parse,
  connected, <= max atoms, charges, canonical, sorted, shuffled by
  ``random.Random(0)``, 5% valid, 5% test);
* preprocess: one ``python -m graphinvent_tpu_torch.tools.submit``
  process per shard, then the shards merged with
  ``tools/combine_hdfs.combine`` into whichever back end ``data/store.py``
  picks here (``train.h5`` with h5py, else ``train.npd``);
* train / generate / test: ``tools/submit`` processes, or with
  ``--in-process`` ``Workflow`` runs in this process;
* score: ``tools/moses_metrics`` over the generated set, IntDiv on
  ``--device``.

data, preprocess, train and generate skip when their outputs exist (the
splits; a dataset of either back end; ``model_restart_<epochs>.pth``; the
last generation batch), so an interrupted campaign resumes; test and
score always re-run.  The last line printed is one JSON object: the
seconds of each stage run and the MOSES metrics, if scored.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.tools.submit import module_env, parse_sets

STAGES = ("data", "preprocess", "train", "generate", "test", "score")
SPLITS = ("train", "valid", "test")
MOSES_JOBS = 8             # the score stage's worker processes


def log(msg: str) -> None:
    print(f"== {msg}", flush=True)


def run(cmd: List[str], tag: str) -> None:
    log(f"[{tag}] {' '.join(map(str, cmd))}")
    subprocess.run([str(c) for c in cmd], env=module_env(), check=True)


def dataset_sets(args) -> List[str]:
    """The campaign's featurization, device budget and the caller's
    ``--set`` overrides, as submit's ``--set`` pairs for every job."""
    return ['atom_types=["C","N","O","S","Cl"]', "formal_charge=[-1,0,1]",
            f"max_n_nodes={args.max_atoms}", "use_aromatic_bonds=True",
            f"device_data_gb={args.device_data_gb}", *args.set]


def _filter_one(smi: str, max_atoms: int, charges: frozenset
                ) -> Optional[str]:
    from graphinvent_tpu_torch.chem import mol_from_smiles, mol_to_smiles
    try:
        mol = mol_from_smiles(smi)
    except Exception:
        return None
    if not mol.is_connected() or mol.n_atoms > max_atoms:
        return None
    if any(a.charge not in charges for a in mol.atoms):
        return None
    return mol_to_smiles(mol)


def create_splits(raw: Sequence[str], out_dir: str, max_atoms: int,
                  charges: Sequence[int] = (-1, 0, 1),
                  valid_frac: float = 0.05, test_frac: float = 0.05,
                  seed: int = 0) -> Dict[str, int]:
    """The JAX package's ``tools/create_dataset.py`` filter and split:
    the same files from the same input."""
    from graphinvent_tpu_torch.tools.synthesize_smiles import write_smi
    canon = [_filter_one(s, max_atoms, frozenset(charges)) for s in raw]
    keep = sorted({c for c in canon if c})
    random.Random(seed).shuffle(keep)
    n = len(keep)
    n_valid, n_test = int(n * valid_frac), int(n * test_frac)
    splits = {"valid": keep[:n_valid],
              "test": keep[n_valid:n_valid + n_test],
              "train": keep[n_valid + n_test:]}
    os.makedirs(out_dir, exist_ok=True)
    for name, rows in splits.items():
        write_smi(os.path.join(out_dir, f"{name}.smi"), rows)
    return {name: len(rows) for name, rows in splits.items()}


def stage_data(args) -> None:
    from graphinvent_tpu_torch.tools.synthesize_smiles import write_smi
    from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles
    data = os.path.join(args.root, "data")
    if os.path.exists(os.path.join(data, "train.smi")):
        log("[data] train.smi exists, skipping")
        return
    raw = synthesize_smiles(args.n, args.min_atoms, args.max_atoms,
                            seed=args.seed, aromatic=True)
    os.makedirs(args.root, exist_ok=True)
    write_smi(os.path.join(args.root, "raw.smi"), raw)
    sizes = create_splits(raw, data, args.max_atoms)
    log(f"[data] {len(raw)} synthesized -> {sizes}")


def dataset_exists(data: str) -> bool:
    """A finished training set of either back end (``store.find_dataset``):
    a machine without h5py writes ``train.npd``."""
    try:
        store.find_dataset(os.path.join(data, "train"))
    except FileNotFoundError:
        return False
    return True


def stage_preprocess(args) -> None:
    from graphinvent_tpu_torch.tools.combine_hdfs import combine
    data = os.path.join(args.root, "data")
    if dataset_exists(data):
        log("[preprocess] the training set exists, skipping")
        return
    # one OS process per shard: the reference's split / merge SLURM flow
    # (submit-split-preprocessing-supercloud.py) as plain config
    procs = []
    for k in range(args.shards):
        cmd = [sys.executable, "-m", "graphinvent_tpu_torch.tools.submit",
               "--job-dir", os.path.join(args.root, "jobs", f"pre{k}"),
               "--job-type", "preprocess", "--dataset-dir", data + "/",
               "--model", args.model, "--device", args.device]
        for kv in dataset_sets(args) + [
                f"preprocess_num_shards={args.shards}",
                f"preprocess_shard_index={k}"]:
            cmd += ["--set", kv]
        log(f"[preprocess] shard {k}: {' '.join(cmd)}")
        procs.append(subprocess.Popen(cmd, env=module_env()))
    failed = [p.wait() != 0 for p in procs]
    if any(failed):
        # every shard has been waited on: none is left to race a re-run
        raise RuntimeError(f"preprocess shard(s) failed: "
                           f"{[k for k, f in enumerate(failed) if f]}")
    suffix = store.default_suffix()
    cfg = GraphInventConfig.from_job_dir(os.path.join(args.root, "jobs",
                                                      "pre0"))
    for split in SPLITS:
        out = os.path.join(data, f"{split}.{suffix}")
        shards = [f"{out}.shard{k}" for k in range(args.shards)]
        res = combine(out, shards, cfg)
        log(f"[combine] {res}")


def job_overrides(args, name: str, job_type: str,
                  extra: Sequence[str]) -> Dict[str, object]:
    overrides = {"job_type": job_type,
                 "dataset_dir": os.path.join(args.root, "data") + "/",
                 "job_dir": os.path.join(args.root, "jobs", name) + "/",
                 "model": args.model, "device": args.device,
                 "batch_size": args.batch_size, "compute_dtype": "bfloat16"}
    overrides.update(parse_sets(dataset_sets(args) + list(extra)))
    return overrides


def job(args, name: str, job_type: str, *extra: str):
    """A device stage: a ``tools/submit`` process, or with ``--in-process``
    a ``Workflow`` in this process (-> the Workflow, for callers that read
    its stats)."""
    if not args.in_process:
        cmd = [sys.executable, "-m", "graphinvent_tpu_torch.tools.submit",
               "--job-dir", os.path.join(args.root, "jobs", name),
               "--job-type", job_type,
               "--dataset-dir", os.path.join(args.root, "data") + "/",
               "--model", args.model, "--device", args.device,
               "--set", f"batch_size={args.batch_size}",
               "--set", "compute_dtype=bfloat16"]
        for kv in dataset_sets(args) + list(extra):
            cmd += ["--set", kv]
        run(cmd, job_type)
        return None
    from graphinvent_tpu_torch.workflow import Workflow
    cfg = GraphInventConfig.from_overrides(job_overrides(args, name,
                                                         job_type, extra))
    os.makedirs(cfg.job_dir, exist_ok=True)
    cfg.write_csv(os.path.join(cfg.job_dir, "input.csv"))
    log(f"[{job_type}] in-process -> {cfg.job_dir}")
    workflow = Workflow(cfg)
    workflow.run()
    return workflow


def train_dir(args) -> str:
    return os.path.join(args.root, "jobs", f"train-{args.model.lower()}")


def run_stage(args, stage: str):
    """Runs one stage; -> the Workflow of an in-process device stage, the
    metrics of ``score``, else None."""
    name = os.path.basename(train_dir(args))
    if stage == "data":
        return stage_data(args)
    if stage == "preprocess":
        return stage_preprocess(args)
    if stage == "train":
        final = os.path.join(train_dir(args),
                             f"model_restart_{args.epochs}.pth")
        if os.path.exists(final):
            log(f"[train] {final} exists, skipping")
            return None
        return job(args, name, "train", f"epochs={args.epochs}",
                   f"sample_every={args.sample_every}", "n_samples=2000")
    if stage == "generate":
        # last batch by ceiling division: a partial last batch runs too
        last = (args.n_generate + args.batch_size - 1) // args.batch_size - 1
        done = os.path.join(train_dir(args), "generation",
                            f"epoch_{args.epochs}_gen{last}.smi")
        if os.path.exists(done):
            log("[generate] last batch exists, skipping")
            return None
        return job(args, name, "generate", f"generation_epoch={args.epochs}",
                   f"n_samples={args.n_generate}")
    if stage == "test":
        # always re-run: its scores are the campaign's final artifact
        return job(args, name, "test", f"generation_epoch={args.epochs}")
    if stage == "score":
        data = os.path.join(args.root, "data")
        argv = [os.path.join(train_dir(args), "generation",
                             f"epoch_{args.epochs}_gen*.smi"),
                "--train", os.path.join(data, "train.smi"),
                "--test", os.path.join(data, "test.smi"),
                "--jobs", str(MOSES_JOBS), "--device", args.device,
                "--out", os.path.join(train_dir(args), "moses_metrics.json")]
        if not args.in_process:
            run([sys.executable, "-m",
                 "graphinvent_tpu_torch.tools.moses_metrics", *argv],
                "score")
            with open(argv[-1]) as fh:
                return json.load(fh)
        from graphinvent_tpu_torch.tools.moses_metrics import main as score
        return score(argv)
    raise ValueError(f"unknown stage {stage!r}; choose from {STAGES}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="runs/chembl40")
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--min-atoms", type=int, default=25)
    ap.add_argument("--max-atoms", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--model", default="GGNN")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--sample-every", type=int, default=10,
                    help="evaluate (sample + UC-JSD) every k train epochs")
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--n-generate", type=int, default=30000)
    ap.add_argument("--stage", default="all", choices=("all",) + STAGES)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-data-gb", type=float, default=6.0,
                    help="device memory for device-resident epochs")
    ap.add_argument("--set", action="append", default=[],
                    help="key=value config override for every job "
                         "(repeatable), e.g. tensorboard_dir=")
    ap.add_argument("--in-process", action="store_true",
                    help="run train / generate / test / score in this "
                         "process (the kernel's library and the native "
                         "chemistry load once)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    stages = STAGES if args.stage == "all" else (args.stage,)
    seconds: Dict[str, float] = {}
    metrics = None
    for stage in stages:
        t0 = time.time()
        out = run_stage(args, stage)
        seconds[stage] = time.time() - t0
        log(f"[{stage}] done in {seconds[stage]:.1f} s")
        if stage == "score":
            metrics = out
    log("campaign complete")
    result = {"root": args.root, "device": args.device, "seconds": seconds,
              "metrics": metrics}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
