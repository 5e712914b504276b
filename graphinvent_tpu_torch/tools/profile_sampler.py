"""Breakdown of the sampler's cost on the card.

Counterpart of the JAX package's ``tools/profile_sampler.py``:

    python -m graphinvent_tpu_torch.tools.profile_sampler [batch_size] \\
        [dtype] [max_atoms] [aromatic] [checkpoint] [--device cuda|cpu]

Each stage is timed alone (host clock, the device synchronised before
and after; the minimum of 5 repeats after a warm-up):

  (a) the model's forward at B x N (kernel path), per round;
  (b) the sampling loop with the model stubbed to "add an atom to node
      0", forced through every round: decode, apply and the loop's
      per-round host read of ``done``;
  (c) the loop with the real forward added to the stub, every round: (c)
      minus (b) is the forward inside the loop;
  (d) a real batch split into its stages: the device loop
      (``_sample_loop``), packing (``_pack_outputs``), the one
      device-to-host copy, host decode (``_decode_packed``), and the
      device's busy share over one ``sample()`` from ``torch.profiler``.

The JAX tool scans (a) 20 times in one program so that XLA cannot hoist
it; here the forward is a loop of eager calls.  Pass a trained checkpoint
(``.pth`` or ``.ckpt``): random weights end their rows in a few rounds.
The last line printed is one JSON object with every stage's seconds.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from graphinvent_tpu_torch.config import preset
from graphinvent_tpu_torch.tools.common import (
    device_report, load_model, synthetic_rows, to_device, wall,
)
from graphinvent_tpu_torch.utils.device import compute_dtype, resolve_device


def best_of(fn, device: torch.device, repeats: int = 5) -> float:
    """Minimum wall seconds of ``repeats`` calls after one warm-up."""
    fn()
    return min(wall(fn, device) for _ in range(repeats))


def busy_share(fn, device: torch.device) -> Optional[float]:
    """Device-busy seconds over wall seconds of one ``fn()`` from
    ``torch.profiler``; None on the CPU or when no device event is
    traced."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        seconds = wall(fn, device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e6 / seconds


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_size", nargs="?", type=int, default=1000)
    ap.add_argument("dtype", nargs="?", default="bfloat16")
    ap.add_argument("max_atoms", nargs="?", type=int, default=13)
    ap.add_argument("aromatic", nargs="?", default="")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    from graphinvent_tpu_torch.sampling.generator import (
        GraphSampler, _pack_outputs, _sample_loop, batch_generator,
    )
    B = args.batch_size
    cfg = preset("GGNN", compute_dtype=args.dtype, max_n_nodes=args.max_atoms,
                 use_aromatic_bonds=args.aromatic == "aromatic",
                 batch_size=B, device=args.device)
    device = resolve_device(cfg.device)
    model = load_model(cfg, args.checkpoint)
    print(f"batch={B} dtype={args.dtype} N={cfg.max_n_nodes} "
          f"E={cfg.n_edge_features} ckpt={bool(args.checkpoint)} "
          f"{device_report(device)}", flush=True)
    out = {"batch": B, "n": cfg.max_n_nodes, "dtype": args.dtype,
           "checkpoint": bool(args.checkpoint), **device_report(device)}

    # (a) the forward alone, on graphs shaped like the sampler's state
    rows = to_device(synthetic_rows(cfg, B), device)
    nodes = rows["nodes"].to(compute_dtype(cfg))
    edges = rows["edges"].to(compute_dtype(cfg))
    with torch.inference_mode():
        out["forward_s"] = best_of(lambda: model(nodes, edges), device)
    print(f"bare forward                  {out['forward_s'] * 1e3:8.3f} ms"
          "/round", flush=True)

    def stub(params, nodes, edges):
        # "add an atom to node 0" always: rows build until the action
        # budget's guard stops them, so every round runs
        logits = torch.full((nodes.shape[0], cfg.dim_apd), -30.0,
                            device=nodes.device)
        logits[:, 0] = 30.0
        return logits

    def forced(params, nodes, edges):
        return stub(params, nodes, edges) + 1e-30 * model(
            nodes, edges).float()

    def loop(apply_fn, k: int):
        with torch.inference_mode():
            return _sample_loop(cfg, model, batch_generator(0, k, device),
                                B, apply_fn, device)

    # (b), (c): every round, the stub alone and with the forward
    for tag, fn in (("stub", stub), ("forced", forced)):
        rounds = loop(fn, 0)[-1]
        secs = best_of(lambda: loop(fn, 0), device)
        out[f"{tag}_loop_s"], out[f"{tag}_rounds"] = secs, rounds
        print(f"{tag} loop, every round        {secs * 1e3:8.3f} ms total, "
              f"{rounds} rounds, {secs / rounds * 1e3:8.3f} ms/round",
              flush=True)
    out["forward_in_loop_s_per_round"] = (
        (out["forced_loop_s"] - out["stub_loop_s"]) / out["forced_rounds"])

    # (d) a real batch, stage by stage
    sampler = GraphSampler(cfg, B, device=device)
    sampler.sample(model, batch_generator(0, 1, device), quiet=True)
    state = {}

    def device_loop():
        state["loop"] = loop(lambda p, n, e: model(n, e), 1)

    def pack():
        with torch.inference_mode():
            state["packed"] = _pack_outputs(*state["loop"])

    def copy():
        state["host"] = state["packed"].cpu().numpy()

    stages = {"device_loop_s": device_loop, "pack_s": pack,
              "device_to_host_s": copy}
    for key, fn in stages.items():
        out[key] = wall(fn, device)
    t0 = time.perf_counter()
    res = sampler._decode_packed(state["host"], 0.0, quiet=True)
    out["host_decode_s"] = time.perf_counter() - t0
    out["rounds"] = res.n_rounds
    out["packed_bytes"] = int(state["host"].nbytes)
    out["sample_s"] = wall(lambda: sampler.sample(
        model, batch_generator(0, 1, device), quiet=True), device)
    out["molecules_per_s"] = B / out["sample_s"]
    out["busy_share"] = busy_share(lambda: sampler.sample(
        model, batch_generator(0, 1, device), quiet=True), device)
    print(f"full: device loop             {out['device_loop_s'] * 1e3:8.3f} "
          f"ms ({res.n_rounds} rounds)\n"
          f"full: pack                    {out['pack_s'] * 1e3:8.3f} ms\n"
          f"full: device-to-host copy     {out['device_to_host_s'] * 1e3:8.3f}"
          f" ms ({out['packed_bytes'] / 1e6:.2f} MB)\n"
          f"full: host decode             {out['host_decode_s'] * 1e3:8.3f} "
          f"ms\nfull: sample()                {out['sample_s'] * 1e3:8.3f} "
          f"ms, {out['molecules_per_s']:.1f} molecules/s, device busy "
          f"{out['busy_share']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
