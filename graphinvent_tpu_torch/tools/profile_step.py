"""Breakdown of the GGNN train step on the card.

Counterpart of the JAX package's ``tools/profile_step.py``:

    python -m graphinvent_tpu_torch.tools.profile_step [batch_size] \\
        [dtype] [filter] [--iters 30] [--device cuda|cpu]

Times, per iteration over ``--iters`` iterations after a warm-up (host
clock, the device synchronised around each section): the training
forward (plain path, autograd on), the message passes alone, the APD
head alone, the graph gather alone, forward + backward, the Adam update
alone, and the grad-free forward on the kernel path that validation and
sampling run.  Then one train step split at CUDA events into forward /
backward / Adam.  The JAX tool scans each section 30 times in one
program and feeds the carry into the inputs so XLA cannot hoist the
work; here each iteration is a loop of eager calls, so nothing is
hoisted.  ``filter`` keeps the sections whose name holds it.  The last
line printed is one JSON object with the seconds of each section.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

from graphinvent_tpu_torch.config import preset
from graphinvent_tpu_torch.tools.common import (
    device_report, load_model, synthetic_rows, to_device, wall,
)
from graphinvent_tpu_torch.utils.device import compute_dtype, resolve_device


def step_split(step_parts, device: torch.device) -> Dict[str, float]:
    """Seconds of each piece of one train step between events recorded at
    the pieces' ends (host clock on the CPU)."""
    from graphinvent_tpu_torch.rl.workflow_rl import StepClock
    clock = StepClock(device)
    for name, fn in step_parts:
        fn()
        clock.mark(name)
    return clock.seconds()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch_size", nargs="?", type=int, default=1000)
    ap.add_argument("dtype", nargs="?", default="bfloat16")
    ap.add_argument("only", nargs="?", default=None,
                    help="time only the sections whose name holds this")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    from graphinvent_tpu_torch.models.mpnn import (
        _edge_type_contraction, _enn_stack, _masked_update, _prepare,
    )
    from graphinvent_tpu_torch.models.readout import (
        global_readout, graph_gather,
    )
    from graphinvent_tpu_torch.train.loss import apd_kl_loss
    from graphinvent_tpu_torch.train.optim import Adam

    B = args.batch_size
    cfg = preset("GGNN", batch_size=B, compute_dtype=args.dtype,
                 device=args.device)
    device = resolve_device(cfg.device)
    dt = compute_dtype(cfg)
    model = load_model(cfg)
    rows = to_device(synthetic_rows(cfg, B), device)
    nodes, edges = rows["nodes"].to(dt), rows["edges"].to(dt)
    apds, valid = rows["apds"].float(), rows["valid"]
    adam = Adam(model)
    print(f"batch={B} dtype={args.dtype} {device_report(device)}", flush=True)
    out: Dict[str, object] = {"batch": B, "dtype": args.dtype,
                              **device_report(device)}

    def messages():
        hidden, _, _, node_mask = _prepare(cfg, nodes, edges)
        for _ in range(cfg.message_passes):
            per_type = _enn_stack(cfg, model.msg_nns, hidden, True)
            m = _edge_type_contraction(edges, per_type)
            hidden = _masked_update(model.gru, m, hidden, node_mask)
        return hidden, node_mask

    hidden0, node_mask0 = messages()
    hidden0 = hidden0.detach()
    gemb = graph_gather(model.gather, hidden0, nodes, node_mask0,
                        cfg.big_positive, True).detach()

    def loss():
        logits = model(nodes, edges, train=True)
        return apd_kl_loss(logits.float(), apds, valid)

    def forward_backward():
        adam.zero_grad()
        loss().backward()

    forward_backward()          # gradients for the Adam-only section

    def eval_forward():
        with torch.inference_mode():
            model(nodes, edges)

    sections = {
        "forward": lambda: model(nodes, edges, train=True),
        "message passes (x3)": messages,
        "APD head": lambda: global_readout(model.APDReadout, hidden0, gemb,
                                           True),
        "graph gather": lambda: graph_gather(
            model.gather, hidden0, nodes, node_mask0, cfg.big_positive,
            True),
        "forward+backward": forward_backward,
        "adam update": lambda: adam.update(1e-4, 0.9),
        "eval forward (kernel path)": eval_forward,
    }
    timings = {}
    for name, fn in sections.items():
        if args.only and args.only not in name:
            continue

        def run(fn=fn):
            for _ in range(args.iters):
                fn()

        run()
        timings[name] = wall(run, device) / args.iters
        print(f"{name:28s} {timings[name] * 1e3:8.3f} ms/iter", flush=True)
    out["sections_s"] = timings

    state = {}
    parts = [("forward", lambda: state.update(loss=loss())),
             ("backward", lambda: state["loss"].backward()),
             ("optimizer", lambda: adam.update(1e-4, 0.9))]
    adam.zero_grad()
    out["step_split_s"] = step_split(parts, device)
    print("one train step: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in out["step_split_s"].items()),
        flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
