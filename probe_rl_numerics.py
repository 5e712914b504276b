#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s bf16 bar for the forward-only
replay (phase 13b): how far a trajectory's bf16 log-likelihood lies from
its f32 one, on preset("GGNN") widths.

    python3 probe_rl_numerics.py [--seeds 4] [--rows 256] [--device cpu]

It runs on the card unless ``--device cpu`` asks for the CPU; the bar's
readings were taken with ``--device cpu``.

For each seed it builds a seeded preset GGNN whose head favours "add to
node 0" and "terminate" (an untrained head takes an invalid first action
almost always; with it, graphs grow for several rounds), with the heads'
last layers scaled by each ``--sharpen`` factor (a trained model's
distributions are sharper than a seeded one's), samples ``--rows``
trajectories in f32 and replays them grad-free four ways: f32 and bf16,
each on the plain path (``fused_inference_enn=False``, ``models/core``)
and on the kernel's path (on the CPU the kernel's plain version, which
keeps f32 through bias and SELU as the kernel does).  It prints, per
seed, the largest per-trajectory |difference| of

  bf16 plain - f32 plain      what bf16 costs on the plain path;
  bf16 kernel - bf16 plain    the quantity that phase 13b bounds on the card;
  bf16 kernel - f32 plain     what bf16 costs on the kernel's path;
  f32 kernel - f32 plain      summation order alone (phase 13b: 1e-3);

and the bar rule: twice the largest "bf16 plain - f32 plain" (the kernel's
path lies no further from f32 than the plain path does, so the two bf16
paths lie within twice that of each other).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def boosted_model(cfg, seed: int, sharpen: float):
    from graphinvent_tpu_torch.models import build_model
    model = build_model(cfg, torch.Generator().manual_seed(seed))
    head = model.APDReadout
    with torch.no_grad():
        for net in (head.fAddNet2, head.fConnNet2, head.fTermNet2):
            last = net.linears[-1]
            last.weight.mul_(sharpen)
            last.bias.mul_(sharpen)
        head.fAddNet2.linears[-1].bias[:cfg.len_f_add_per_node] += 6.0
        head.fTermNet2.linears[-1].bias[:] += 8.0
    return model.eval()


def replays(cfg, model, actions, t_counts) -> dict:
    from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
    out = {}
    for dt in ("float32", "bfloat16"):
        for fused in (False, True):
            run = cfg.replace(compute_dtype=dt, fused_inference_enn=fused)
            model.cfg = run
            with torch.inference_mode():
                out[(dt, fused)] = trajectory_loglik(
                    run, model, actions, t_counts).double().cpu().numpy()
    model.cfg = cfg
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--sharpen", type=float, nargs="+", default=[1.0, 3.0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    dev = torch.device(args.device)
    cfg = preset("GGNN", device=args.device, compute_dtype="float32")
    worst = 0.0
    print(f"preset GGNN, {args.rows} trajectories a seed, {dev}")
    for sharpen in args.sharpen:
        for seed in range(args.seeds):
            model = boosted_model(cfg, seed, sharpen).to(dev)
            res = GraphSampler(cfg, args.rows, device=dev).sample(
                model, batch_generator(seed, 0, dev), quiet=True)
            ll = replays(cfg, model, torch.from_numpy(res.actions).to(dev),
                         torch.from_numpy(res.t_counts).to(dev))
            d = lambda a, b: float(np.abs(ll[a] - ll[b]).max())
            bf_plain = d(("bfloat16", False), ("float32", False))
            worst = max(worst, bf_plain)
            print(f"sharpen {sharpen:g} seed {seed}: actions mean "
                  f"{res.t_counts.mean():.2f} max {res.t_counts.max()}, "
                  f"ll mean {ll[('float32', False)].mean():.3f}; max |diff| "
                  f"bf16 plain - f32 plain {bf_plain:.4g}, bf16 kernel - "
                  f"bf16 plain {d(('bfloat16', True), ('bfloat16', False)):.4g}"
                  f", bf16 kernel - f32 plain "
                  f"{d(('bfloat16', True), ('float32', False)):.4g}, f32 "
                  f"kernel - f32 plain "
                  f"{d(('float32', True), ('float32', False)):.3g}",
                  flush=True)
    print(f"bar rule: 2 x largest |bf16 plain - f32 plain| = {2 * worst:.4g}")


if __name__ == "__main__":
    main()
