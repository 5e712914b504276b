"""Speed-of-light study of the train step and the sampler round on the
card.

Counterpart of the JAX package's ``tools/roofline.py``, with the rows it
reports, against the H100's data-sheet peaks (``utils/device.py``: 989
TFLOP/s bf16 dense, 67 TFLOP/s float32, 3.35 TB/s):

    python -m graphinvent_tpu_torch.tools.roofline [--models GGNN] \\
        [--batch 1000] [--nodes 13,40] [--dtype bfloat16] [--steps 20] \\
        [--repeats 3] [--sampler] [--aromatic] [--dataset 40=DIR] \\
        [--checkpoint 40=PATH] [--device cuda|cpu] [--json FILE]

* **flops**: the products of one step (or one round) counted by
  ``torch.utils.flop_counter.FlopCounterMode``: matmul-type operations
  only (the JAX tool takes XLA's cost analysis, which also counts
  elementwise work).  The train step runs forward, backward and Adam on
  the plain path.  The sampler round's forward runs the fused kernel,
  which a ctypes call hides from the counter, so its FLOPs are counted on
  the plain path, which does the same products: one seeded batch with
  ``fused_inference_enn`` off under the counter, over its rounds.  (XLA's
  "loop body counted once" has no counterpart here.)
* **step_time_s / round_time_s**: the median of ``--repeats`` timings of
  ``--steps`` train steps (host clock, the device synchronised), and of
  seeded sampler batches (wall over rounds).
* **mfu**: FLOP/s over the bf16 peak (the float32 peak for float32).
* **hbm_min_bytes**: the JAX tool's analytic traffic floor, 28 bytes a
  parameter (float32 weights, gradients and two Adam moments read and
  written) plus one read of the batch; a sampler round reads its weights
  once in the compute dtype.
* **sol_step_time_s** = max(flops / peak, hbm_min_bytes / bandwidth);
  **sol_fraction** its share of the measured time; **bound**
  ``operations`` or ``bytes``, whichever sets it.

Rows are at the preset widths; ``--dataset N=DIR`` takes the batch from a
preprocessed dataset at N nodes (else seeded synthetic graphs), and
``--checkpoint N=PATH`` the sampler's weights (else seeded random ones,
whose rollouts end after a few rounds).  Every row carries the card's
name and power limit.  The last line printed is one JSON object with the
rows.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from graphinvent_tpu_torch.config import GraphInventConfig, preset
from graphinvent_tpu_torch.tools.common import (
    dataset_rows, device_report, load_model, synthetic_rows, to_device, wall,
)
from graphinvent_tpu_torch.utils.device import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, resolve_device,
)

# float32 weights, gradients and two Adam moments: each read and written
ADAM_BYTES_PER_PARAM = 28


def peak_flops(cfg: GraphInventConfig) -> float:
    return (PEAK_BF16_FLOPS if cfg.compute_dtype == "bfloat16"
            else PEAK_F32_FLOPS)


def n_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def sol(flops: float, nbytes: float, seconds: float,
        cfg: GraphInventConfig) -> Dict[str, object]:
    """The speed-of-light fields of a row measured in ``seconds`` on the
    card; a CPU run has none (None: the peaks are the card's)."""
    if resolve_device(cfg.device).type != "cuda":
        return {"mfu": None, "sol_step_time_s": None, "sol_fraction": None,
                "bound": None}
    t_ops, t_bytes = flops / peak_flops(cfg), nbytes / PEAK_BYTES
    bound_s = max(t_ops, t_bytes)
    return {"mfu": flops / seconds / peak_flops(cfg),
            "sol_step_time_s": bound_s, "sol_fraction": bound_s / seconds,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}


def step_flops(cfg: GraphInventConfig, model: torch.nn.Module,
               batch: Dict[str, torch.Tensor]) -> float:
    """Matmul FLOPs of one train step (forward, backward, Adam) on
    ``batch``; the step runs, and updates ``model``."""
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.train.step import make_train_step
    step = make_train_step(cfg, onecycle_for_config(cfg, 100), model,
                           Adam(model))
    with FlopCounterMode(display=False) as counter:
        step(batch)
    return float(counter.get_total_flops())


def measure_step(cfg: GraphInventConfig, rows: Dict[str, np.ndarray],
                 n_steps: int = 20, n_repeats: int = 3, seed: int = 0
                 ) -> Dict[str, object]:
    """The train step at ``cfg``'s widths on ``rows`` (one batch)."""
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.train.step import make_train_step
    device = resolve_device(cfg.device)
    model = load_model(cfg, seed=seed).train()
    batch = to_device(rows, device)
    flops = step_flops(cfg, model, batch)
    step = make_train_step(cfg, onecycle_for_config(cfg, 10 * n_steps),
                           model, Adam(model))

    def run() -> None:
        for _ in range(n_steps):
            step(batch)

    run()                                           # warm-up
    times = sorted(wall(run, device) / n_steps
                   for _ in range(max(1, n_repeats)))
    params = n_params(model)
    batch_bytes = sum(v.nbytes for v in rows.values())
    return {"flops": flops, "step_time_s": float(np.median(times)),
            "step_time_min_s": times[0], "step_time_max_s": times[-1],
            "n_repeats": len(times), "n_params": params,
            "batch_bytes": batch_bytes,
            "hbm_min_bytes": ADAM_BYTES_PER_PARAM * params + batch_bytes,
            "edges_per_batch": float(rows["edges"].sum() / 2)}


def roofline_row(cfg: GraphInventConfig, rows: Dict[str, np.ndarray],
                 n_steps: int = 20, n_repeats: int = 3) -> Dict[str, object]:
    m = measure_step(cfg, rows, n_steps, n_repeats)
    row = dict(kind="train_step", model=cfg.model, batch=cfg.batch_size,
               n=cfg.max_n_nodes, dtype=cfg.compute_dtype, **m)
    row["graphs_per_s"] = cfg.batch_size / m["step_time_s"]
    row["edges_per_s"] = m["edges_per_batch"] / m["step_time_s"]
    row.update(sol(m["flops"], m["hbm_min_bytes"], m["step_time_s"], cfg))
    row.update(device_report(resolve_device(cfg.device)))
    return row


def sampler_flops_per_round(cfg: GraphInventConfig, model: torch.nn.Module,
                            seed: int = 0) -> Dict[str, float]:
    """Matmul FLOPs of a sampler round, counted on the plain path (the
    kernel's ctypes launch is invisible to the counter; the plain path
    does the same products): one seeded batch under the counter."""
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    device = resolve_device(cfg.device)
    plain = cfg.replace(fused_inference_enn=False)
    old, model.cfg = model.cfg, plain
    try:
        sampler = GraphSampler(plain, cfg.batch_size, device=device)
        with FlopCounterMode(display=False) as counter:
            res = sampler.sample(model, batch_generator(seed, 0, device),
                                 quiet=True)
    finally:
        model.cfg = old
    return {"flops_per_round": counter.get_total_flops() / res.n_rounds,
            "flop_count_rounds": res.n_rounds}


def measure_sampler(cfg: GraphInventConfig, model: torch.nn.Module,
                    n_batches: int = 3, seed: int = 0) -> Dict[str, object]:
    """Seconds a round of ``n_batches`` seeded batches (after one
    warm-up batch), each batch's wall over its rounds."""
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    device = resolve_device(cfg.device)
    sampler = GraphSampler(cfg, cfg.batch_size, device=device)
    sampler.sample(model, batch_generator(seed, 99, device), quiet=True)
    per_round, rounds, secs = [], 0, 0.0
    for k in range(n_batches):
        res = sampler.sample(model, batch_generator(seed, 100 + k, device),
                             quiet=True)
        per_round.append(res.elapsed_s / res.n_rounds)
        rounds += res.n_rounds
        secs += res.elapsed_s
    per_round.sort()
    return {"round_time_s": float(np.median(per_round)),
            "round_time_min_s": per_round[0],
            "round_time_max_s": per_round[-1], "n_rounds": rounds,
            "molecules_per_s": n_batches * cfg.batch_size / secs}


def sampler_row(cfg: GraphInventConfig, model: torch.nn.Module,
                n_batches: int = 3, seed: int = 0) -> Dict[str, object]:
    row = dict(kind="sampler_round", model=cfg.model, batch=cfg.batch_size,
               n=cfg.max_n_nodes, dtype=cfg.compute_dtype)
    row.update(measure_sampler(cfg, model, n_batches, seed))
    row.update(sampler_flops_per_round(cfg, model, seed))
    params = n_params(model)
    esize = 2 if cfg.compute_dtype == "bfloat16" else 4
    row.update(n_params=params, hbm_min_bytes=esize * params)
    row.update(sol(row["flops_per_round"], row["hbm_min_bytes"],
                   row["round_time_s"], cfg))
    row.update(device_report(resolve_device(cfg.device)))
    return row


def fmt_row(r: Dict[str, object]) -> str:
    if r["kind"] == "train_step":
        base = (f"train step {r['model']:8s} B={r['batch']:<5d} "
                f"N={r['n']:<3d} {r['step_time_s'] * 1e3:8.3f} ms  "
                f"{r['flops'] / 1e9:8.1f} GF")
    else:
        base = (f"sampler    {r['model']:8s} B={r['batch']:<5d} "
                f"N={r['n']:<3d} {r['round_time_s'] * 1e3:8.3f} ms/round  "
                f"{r['flops_per_round'] / 1e9:8.1f} GF/round")
    if r["mfu"] is None:
        return base + f"  MFU, SoL: not measured  [{r['device']}]"
    return (base + f"  MFU {100 * r['mfu']:6.2f}%  SoL "
            f"{100 * r['sol_fraction']:6.2f}% ({r['bound']})  "
            f"[{r['card']}]")


def _by_n(pairs: Sequence[str]) -> Dict[int, str]:
    out = {}
    for kv in pairs:
        n, _, path = kv.partition("=")
        out[int(n)] = path
    return out


def config_for(model: str, n: int, args) -> GraphInventConfig:
    kw = dict(batch_size=args.batch, max_n_nodes=n,
              compute_dtype=args.dtype, device=args.device)
    if args.aromatic:
        kw["use_aromatic_bonds"] = True
    return preset(model, **kw)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="GGNN")
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--nodes", default="13")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sampler", action="store_true",
                    help="roofline the sampler round instead of the train "
                         "step")
    ap.add_argument("--aromatic", action="store_true",
                    help="aromatic bond type (E = 4), as ChEMBL-proxy data")
    ap.add_argument("--dataset", action="append", default=[],
                    help="N=DIR: take the batch from this dataset at N")
    ap.add_argument("--checkpoint", action="append", default=[],
                    help="N=PATH: the sampler's weights at N")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None,
                    help="append one JSON line per row to this file")
    args = ap.parse_args(argv)
    datasets, checkpoints = _by_n(args.dataset), _by_n(args.checkpoint)

    rows = []
    for model_name in args.models.split(","):
        for n in (int(x) for x in args.nodes.split(",")):
            cfg = config_for(model_name.strip(), n, args)
            if args.sampler:
                model = load_model(cfg, checkpoints.get(n))
                row = sampler_row(cfg, model, n_batches=args.repeats)
            else:
                data = (dataset_rows(cfg, datasets[n], cfg.batch_size)
                        if n in datasets else
                        synthetic_rows(cfg, cfg.batch_size))
                row = roofline_row(cfg, data, args.steps, args.repeats)
            rows.append(row)
            print(fmt_row(row), flush=True)
            if args.json:
                with open(args.json, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
    result = {"rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
