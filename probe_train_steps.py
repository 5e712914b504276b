#!/usr/bin/env python3
"""The train step's eager paths on the card, and the resident epoch's
replayed steps where the package has them, at preset("GGNN"), B=1000,
N=13, bf16, seeded weights and seeded synthetic rows (35 batches):

0. Adam's update right after a backward has been queued (not
   synchronised): its host time (an update that waits for the device
   reads the queued backward's time here) and the time between CUDA
   events around it (the update's device time where the device runs
   behind the host; where the host issues slower than the device runs,
   the host's issue time);
1. the resident epoch on the eager loop: ms a step on the host clock
   over a whole epoch, to its one read;
2. the streamed path's epoch (``workflow.py``): the same steps on batches
   uploaded from host memory by ``BatchUploader``, a batch ahead on a
   worker thread (``upload_ahead``);
3. where ``make_epoch_train_fn`` has the ``_eager`` switch, the resident
   epoch with its steps replayed from a captured graph;
4. after that capture, readings 0 and 1 again, and the device memory
   allocated then (``--drop before|after|none`` keeps only the drop of
   the library's workspaces before the capture, only the one after it,
   or neither, to tell their shares apart).

``--clear-test`` reads 1 only, then again after the library's workspaces
were dropped (``torch._C._cuda_clearCublasWorkspaces``, no capture), then
after ``torch.cuda.empty_cache()`` as well.

It imports the ``graphinvent_tpu_torch`` of the current directory, so the
same file reads two trees of the repo:

    python3 probe_train_steps.py [--epochs 4]
    (cd other_tree && python3 /path/to/probe_train_steps.py)

``--device cpu --rows 300 --batch 100`` runs the same code at a small
size on the CPU, where no device time is read.

Prints one line a reading and, last, one JSON object (medians over the
epochs after a warm-up epoch).
"""

import argparse
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(device, rows, batch):
    from types import SimpleNamespace
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    cfg = preset("GGNN", device=device.type, compute_dtype="bfloat16",
                 batch_size=batch)
    nodes, edges = synthetic_graphs(cfg, rows, seed=2)
    rng = np.random.default_rng(2)
    apds = np.zeros((rows, cfg.dim_apd), np.int8)
    apds[np.arange(rows), rng.integers(0, cfg.dim_apd, rows)] = 1
    host = dict(nodes=nodes.astype(np.int8), edges=edges.astype(np.int8),
                apds=apds)
    data = SimpleNamespace(
        device=device, n_rows=rows,
        **{k: torch.from_numpy(v).to(device) for k, v in host.items()})
    model = build_model(cfg, torch.Generator().manual_seed(0)).to(device)
    adam = Adam(model)
    schedule = onecycle_for_config(cfg, rows // batch)
    return cfg, data, host, model, adam, schedule


def perm_of(cfg, data, e):
    from graphinvent_tpu_torch.train.device_data import epoch_permutation
    return epoch_permutation(data.n_rows, cfg.batch_size,
                             np.random.default_rng(e))


def dropout(e, device):
    from graphinvent_tpu_torch.sampling.generator import (
        STREAM_DROPOUT, seeded_generator,
    )
    return seeded_generator([5, e], device, STREAM_DROPOUT)


def update_after_backward(cfg, data, model, adam, schedule, steps):
    """Reading 0: (host ms, device ms or None) of each update after the
    first."""
    from graphinvent_tpu_torch.train.device_data import _gather_batch
    from graphinvent_tpu_torch.train.step import train_loss
    batches = torch.from_numpy(perm_of(cfg, data, 0)).to(data.device)
    cuda = data.device.type == "cuda"
    host, events = [], []
    for i in range(min(steps, len(batches))):
        adam.zero_grad()
        loss = train_loss(cfg, model, _gather_batch(data, batches[i]),
                          dropout(0, data.device))
        loss.backward()
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        adam.update(*schedule(adam.step))
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            e1.record()
            events.append((e0, e1))
    sync(data.device)
    return host[1:], [a.elapsed_time(b) for a, b in events[1:]] or None


def timed_epochs(run, epochs, device):
    """ms a step of each epoch after the first (``run(e)`` -> steps)."""
    out = []
    for e in range(epochs + 1):
        sync(device)
        t0 = time.perf_counter()
        steps = run(e)
        sync(device)
        if e:
            out.append((time.perf_counter() - t0) * 1e3 / steps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--rows", type=int, default=35_000)
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--drop", default="both",
                    choices=("both", "before", "after", "none"))
    ap.add_argument("--clear-test", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from graphinvent_tpu_torch.train.device_data import make_epoch_train_fn
    from graphinvent_tpu_torch.train.step import (
        BatchUploader, make_train_step,
    )
    from graphinvent_tpu_torch.workflow import upload_ahead
    if args.drop != "both":
        from graphinvent_tpu_torch.utils import cuda_graphs
        drop, calls = cuda_graphs.drop_library_workspaces, [0]

        def some_drops():     # a capture drops twice: before, after
            calls[0] += 1
            if args.drop == ("before", "after")[(calls[0] + 1) % 2]:
                drop()
        cuda_graphs.drop_library_workspaces = some_drops
    cfg, data, host, model, adam, schedule = setup(device, args.rows,
                                                   args.batch)
    res = {"tree": os.getcwd()}

    def resident(fn):
        def run(e):
            perm = perm_of(cfg, data, e)
            fn(perm, dropout(e, device))
            return len(perm)
        return run

    if args.clear_test:
        kw = ({"_eager": True} if "_eager" in inspect.signature(
            make_epoch_train_fn).parameters else {})
        eager = make_epoch_train_fn(cfg, schedule, data, model, adam, **kw)
        for what in ("as started", "after the workspace drop",
                     "after empty_cache too"):
            if what == "after the workspace drop":
                torch._C._cuda_clearCublasWorkspaces()
            elif what == "after empty_cache too":
                torch.cuda.empty_cache()
            ms = timed_epochs(resident(eager), args.epochs, device)
            print(f"eager epoch {what}: ms a step {ms}", flush=True)
        return 0

    upd_host, upd_dev = update_after_backward(cfg, data, model, adam,
                                              schedule, 12)
    res["update_host_ms"] = statistics.median(upd_host)
    res["update_device_ms"] = upd_dev and statistics.median(upd_dev)
    print(f"0. update after a queued backward: host "
          f"{res['update_host_ms']:.4f} ms, device "
          f"{res['update_device_ms']} ms (medians of {len(upd_host)})",
          flush=True)

    graphed_switch = "_eager" in inspect.signature(
        make_epoch_train_fn).parameters
    kw = {"_eager": True} if graphed_switch else {}
    eager = make_epoch_train_fn(cfg, schedule, data, model, adam, **kw)
    res["eager_ms"] = timed_epochs(resident(eager), args.epochs, device)
    print(f"1. resident epoch, eager: ms a step {res['eager_ms']}",
          flush=True)

    train_step = make_train_step(cfg, schedule, model, adam)
    place = BatchUploader(device)

    def streamed(e):
        gen = dropout(e, device)
        total = torch.zeros((), device=device)
        steps = 0
        rows = (np.maximum(r, 0) for r in perm_of(cfg, data, e))
        batches = ({k: v[r] for k, v in host.items()} for r in rows)
        for b in upload_ahead(batches, place):
            total += train_step(b, gen)
            steps += 1
        total.item()
        return steps

    res["streamed_ms"] = timed_epochs(streamed, args.epochs, device)
    print(f"2. streamed epoch: ms a step {res['streamed_ms']}", flush=True)

    if graphed_switch and device.type == "cuda":
        graphed = make_epoch_train_fn(cfg, schedule, data, model, adam)
        res["graphed_ms"] = timed_epochs(resident(graphed), args.epochs,
                                         device)
        print(f"3. resident epoch, replayed: ms a step {res['graphed_ms']}",
              flush=True)
        upd_host, _ = update_after_backward(cfg, data, model, adam,
                                            schedule, 12)
        res["update_host_ms_after"] = statistics.median(upd_host)
        res["eager_ms_after"] = timed_epochs(resident(eager), args.epochs,
                                             device)
        sync(device)
        res["allocated_mib_after"] = torch.cuda.memory_allocated() / 2**20
        print(f"4. after the capture: update host "
              f"{res['update_host_ms_after']:.4f} ms; resident epoch, "
              f"eager: ms a step {res['eager_ms_after']}; allocated "
              f"{res['allocated_mib_after']:.2f} MiB", flush=True)
    for k in ("eager_ms", "streamed_ms", "graphed_ms", "eager_ms_after"):
        if k in res:
            res[k + "_median"] = statistics.median(res[k])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
