#!/usr/bin/env python3
"""Two readings of the sampler's captured round
(``sampling/round_graphs.py``) on the card, at preset("GGNN"), B=1000, N=13,
bf16, seeded weights with the APD head's "add to node 0-2" and "terminate"
logits raised so that rollouts run ~15 rounds:

0. device memory allocated after an eager forward on the current stream,
   then after one on a new stream (the library's per-stream workspace,
   which the captured round's warm-up and captures take on PyTorch's one
   capture stream);
1. the cost of an edit in place: after an in-place weight update (a new
   version, as the fine-tune agent's after each Adam step, with a 256 MiB
   block freed just before, as its gradient replay leaves), one batch with
   the refresh of its captured round, the same batch replayed, and on the
   eager loop.

    python3 probe_sampler_graphs.py

Prints one line a reading and, last, one JSON object.
"""

import json
import sys
import time

import torch


def raised_model(cfg, device):
    from graphinvent_tpu_torch.models import build_model
    model = build_model(cfg, torch.Generator().manual_seed(0)).to(device)
    head = model.eval().APDReadout
    with torch.no_grad():
        head.fAddNet2.linears[-1].bias[:3 * cfg.len_f_add_per_node] += 3.0
        head.fTermNet2.linears[-1].bias[:] += 1.0
    return model


def stream_workspace(cfg, model, device) -> dict:
    from graphinvent_tpu_torch.sampling.generator import _initial_state
    st = _initial_state(cfg, cfg.batch_size, device, None)
    out = {}
    for where, stream in (("current stream", torch.cuda.current_stream()),
                          ("a new stream", torch.cuda.Stream(device))):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            model(st.nodes, st.edges)
        torch.cuda.synchronize()
        out[where] = torch.cuda.memory_allocated() / 2**20
        print(f"allocated after a forward on {where}: {out[where]:.2f} MiB",
              flush=True)
    return out


def refresh_cost(cfg, model, device) -> list:
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    graphed = GraphSampler(cfg, cfg.batch_size, device=device)
    eager = GraphSampler(cfg, cfg.batch_size, device=device, _eager=True)

    def timed(sampler, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sampler.sample(model, batch_generator(2, k, device), quiet=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res.n_rounds

    timed(graphed, 0)
    timed(eager, 0)
    out = []
    bias = model.APDReadout.fTermNet2.linears[-1].bias
    for step in range(4):
        block = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
        del block
        with torch.no_grad():
            bias.add_(0.0)
        (ref, rounds), (rep, _), (eag, _) = (
            timed(graphed, step), timed(graphed, step), timed(eager, step))
        out.append(dict(rounds=rounds, with_refresh_s=ref, replayed_s=rep,
                        eager_s=eag, refresh_s=ref - rep))
        print(f"edit {step}: {rounds} rounds; with the refresh {ref:.4f} s, "
              f"replayed {rep:.4f} s, eager {eag:.4f} s; the refresh about "
              f"{ref - rep:.4f} s ({graphed._graphs.captures} captures, "
              f"{graphed._graphs.refreshes} refreshes so far)", flush=True)
    return out


def main() -> None:
    from graphinvent_tpu_torch.config import preset
    device = torch.device("cuda")
    cfg = preset("GGNN", device="cuda")
    model = raised_model(cfg, device)
    with torch.inference_mode():
        memory = stream_workspace(cfg, model, device)
    cost = refresh_cost(cfg, model, device)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "allocated_mib": memory, "refresh": cost}),
          flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_sampler_graphs: no CUDA device")
    main()
