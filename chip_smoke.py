#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA GPU (H100) and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: name, count, power limit; TF32 off;
  2. build: compiles the fused ENN kernel from the repo's CUDA source and
     prints ptxas's register and spill report of each kernel;
  3. kernel against its plain version at every launch shape of the GGNN
     generate job (preset("GGNN"), B=1000, N=13), in f32 and bf16, plus a
     ragged row count and the ChEMBL-width message stack (N=40, E=4); in
     bf16 through the wrapper (its own launch plan) and under both kinds
     of plan forced (no cluster, the largest cluster);
  4. GGNN forward at B=1000, bf16 and f32: kernel path against the plain
     PyTorch path, and exactly 10 kernel launches per forward; the bf16
     forward's time on both paths;
  5. the generate job end to end through ``graphinvent_tpu_torch.main``
     (seeded random weights saved as model_restart_1.pth, n_samples=2000,
     batch_size=1000): files written, every round's forward through the
     kernel; then the sampler alone: time per round, and the device's busy
     share over one batch from torch.profiler;
  6. CUDA-event timings of the kernel (under its launch plan, and under
     the other kind of plan), its plain version and the unfused PyTorch
     path at each launch shape, against the card's bound.

The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  The job runs in a temporary directory,
removed at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data sheet: dense bf16 tensor-core and HBM3 rates
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.0 / 64}
LOGIT_TOL = {torch.bfloat16: 0.15, torch.float32: 2e-3}
REPLACES = "graphinvent_tpu/models/fused_enn.py:98"
SOURCE = "graphinvent_tpu_torch/models/csrc/fused_enn.cu"
B, N = 1000, 13
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {name}, {count} device(s)")
    log(smi.stdout.strip().splitlines()[0])
    return {"platform": "gpu", "kind": name, "count": count}


def ptxas_report(build_log: str) -> list:
    """(kernel, registers line, spill line) per entry function."""
    rows, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("wgmma_kernelILi64", "wgmma_kernelILi128",
                                     "f32_kernel") if k in mangled), mangled)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            rows.append((name, line.split(":", 1)[1].strip(), spill))
    return rows


def phase_build(fused_enn) -> None:
    t0 = time.time()
    path = fused_enn.build_library()
    log(f"[2 build] {os.path.relpath(path, ROOT)} in {time.time() - t0:.2f} s")
    report = ptxas_report(fused_enn.BUILD_LOG)
    for name, regs, spill in report:
        log(f"    {name:<20} {regs}; {spill}")
    if not report:
        log("    ptxas report: not printed (library already built)")
        return
    log("    ptxas warpgroup.arrive injections: "
        f"{fused_enn.BUILD_LOG.count('C7519')}, wgmma serialized: "
        f"{fused_enn.BUILD_LOG.count('are serialized')}")


def main_path_sites(model):
    """(name, wrapper, modules, rows, in_features) of every kernel launch of
    one GGNN forward at B x N."""
    cfg = model.cfg
    head = model.APDReadout
    R1 = B * N
    return [
        ("msg_nns", "fused_stacked_mlp", list(model.msg_nns), R1,
         cfg.hidden_node_features),
        ("gather.att_nn", "fused_mlp", [model.gather.att_nn], R1,
         cfg.hidden_node_features + cfg.n_node_features),
        ("gather.emb_nn", "fused_mlp", [model.gather.emb_nn], R1,
         cfg.hidden_node_features),
        ("APDReadout.fAddNet1", "fused_mlp", [head.fAddNet1], R1,
         cfg.hidden_node_features),
        ("APDReadout.fConnNet1", "fused_mlp", [head.fConnNet1], R1,
         cfg.hidden_node_features),
        ("APDReadout.fAddNet2", "fused_mlp", [head.fAddNet2], B,
         cfg.len_f_add + cfg.gather_width),
        ("APDReadout.fConnNet2", "fused_mlp", [head.fConnNet2], B,
         cfg.len_f_conn + cfg.gather_width),
        ("APDReadout.fTermNet2", "fused_mlp", [head.fTermNet2], B,
         cfg.gather_width),
    ]


def rand_rows(rows: int, width: int, seed: int, dtype) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(rows, width)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)


def kernel_check(fused_enn, name, wrapper, mlps, x2d, lead) -> float:
    """The wrapper the main path calls, against the plain version on the
    same inputs; returns max |kernel - plain|."""
    dt = x2d.dtype
    with torch.inference_mode():
        if wrapper == "fused_stacked_mlp":
            got = fused_enn.fused_stacked_mlp(
                torch.nn.ModuleList(mlps), x2d.reshape(*lead, -1))
            got = got.reshape(len(mlps), x2d.shape[0], -1)
        else:
            got = fused_enn.fused_mlp(mlps[0], x2d.reshape(*lead, -1))
            got = got.reshape(1, x2d.shape[0], -1)
        flat = fused_enn.flatten_weights(fused_enn.stacked_layers(mlps), dt,
                                         x2d.device)
        ref = fused_enn.fused_stacked_mlp_reference(flat, x2d)
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), atol=TOL[dt], rtol=TOL[dt])
    log(f"    {name:<24} {str(dt)[6:]:<8} R={x2d.shape[0]:<6} "
        f"max|kernel-plain| {err:.3g} (tol {TOL[dt]:.3g} abs + rel) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {dt}: kernel disagrees with its plain version")
    if dt == torch.bfloat16:
        for plan in fused_enn.plan_choices(flat.dims):
            with torch.inference_mode():
                got = fused_enn.fused_enn_cuda(flat, x2d, plan)
            torch.cuda.synchronize()
            e = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), atol=TOL[dt],
                                rtol=TOL[dt])
            log(f"      plan tile_rows={plan.tile_rows} cluster={plan.cluster}"
                f": max|kernel-plain| {e:.3g} {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} under {plan}: kernel disagrees with its plain "
                  "version")
            err = max(err, e)
    return err


def phase_kernels(fused_enn, model, cfg) -> dict:
    from graphinvent_tpu_torch.models.core import MLP
    log("[3 kernel vs plain]")
    errs = {}
    for i, (name, wrapper, mlps, R, I) in enumerate(main_path_sites(model)):
        lead = (B, N) if R == B * N else (B,)
        for dt in (torch.float32, torch.bfloat16):
            err = kernel_check(fused_enn, name, wrapper, mlps,
                               rand_rows(R, I, i, dt), lead)
            if dt == torch.bfloat16:
                errs[name] = err
    msg = list(model.msg_nns)
    g = torch.Generator().manual_seed(40)
    chembl = [MLP(cfg.hidden_node_features, [cfg.enn_hidden_dim] * 4,
                  cfg.message_size, generator=g).to("cuda") for _ in range(4)]
    for dt in (torch.float32, torch.bfloat16):
        kernel_check(fused_enn, "msg_nns ragged", "fused_stacked_mlp", msg,
                     rand_rows(12345, cfg.hidden_node_features, 90, dt),
                     (12345, 1))
        kernel_check(fused_enn, "msg_nns ChEMBL N=40 E=4",
                     "fused_stacked_mlp", chembl,
                     rand_rows(40000, cfg.hidden_node_features, 91, dt),
                     (1000, 40))
    return errs


def phase_forward(fused_enn, model, cfg) -> None:
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    log("[4 GGNN forward, B=1000]")
    nodes_np, edges_np = synthetic_graphs(cfg, B, seed=4)
    plain_cfg = cfg.replace(fused_inference_enn=False)
    for dt in (torch.bfloat16, torch.float32):
        nodes = torch.from_numpy(nodes_np).to("cuda", dt)
        edges = torch.from_numpy(edges_np).to("cuda", dt)
        with torch.inference_mode():
            fused_enn.reset_launch_counts()
            fused = model(nodes, edges).float()
            torch.cuda.synchronize()
            launches = sum(fused_enn.LAUNCHES.values())
            model.cfg = plain_cfg
            try:
                plain = model(nodes, edges).float()
            finally:
                model.cfg = cfg
            torch.cuda.synchronize()
        check(launches == 10, f"{dt}: {launches} kernel launches in one "
              f"forward, expected 10")
        check(fused.shape == (B, cfg.dim_apd), f"logits shape {fused.shape}")
        check(bool(torch.isfinite(fused).all()), "non-finite logits")
        err = (fused - plain).abs().max().item()
        log(f"    {str(dt)[6:]}: APD logits max|kernel path - plain path| "
            f"{err:.4g} (tol {LOGIT_TOL[dt]}), {launches} launches")
        check(err <= LOGIT_TOL[dt], f"{dt}: logits differ by {err}")
    nodes = torch.from_numpy(nodes_np).to("cuda", torch.bfloat16)
    edges = torch.from_numpy(edges_np).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        fused_ms = cuda_ms(lambda: model(nodes, edges))
        model.cfg = plain_cfg
        try:
            plain_ms = cuda_ms(lambda: model(nodes, edges))
        finally:
            model.cfg = cfg
    log(f"    bf16 forward: kernel path {fused_ms:.4f} ms, plain path "
        f"{plain_ms:.4f} ms (CUDA events, warm)")


def phase_generate(fused_enn, cfg, model) -> dict:
    log("[5 generate job: n_samples=2000, batch_size=1000]")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_job_") as job:
        return run_generate_job(fused_enn, cfg, model, job)


def run_generate_job(fused_enn, cfg, model, job: str) -> dict:
    from graphinvent_tpu_torch.main import main as port_main
    from graphinvent_tpu_torch.utils.weights import save_checkpoint
    job_cfg = cfg.replace(job_type="generate", job_dir=job + "/",
                          dataset_dir=job + "/", n_samples=2000,
                          batch_size=1000, generation_epoch=1,
                          tensorboard_dir="", device="cuda")
    job_cfg.write_csv(os.path.join(job, "input.csv"))
    save_checkpoint(model, job, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_enn.reset_launch_counts()
    t0 = time.time()
    workflow = port_main(["--job-dir", job])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(fused_enn.LAUNCHES_BY_LAYOUT)
    total = sum(fused_enn.LAUNCHES.values())
    rounds = [r for r, _ in workflow.batch_stats]
    sample_s = sum(s for _, s in workflow.batch_stats)
    check(total > 0, "the generate job launched no kernel")
    check(total == 10 * sum(rounds),
          f"{total} launches for {sum(rounds)} rounds (expected 10 a round)")
    for name in ("epoch_1_gen0", "epoch_1_gen1"):
        base = os.path.join(job, "generation", name)
        smiles = open(base + ".smi").read().splitlines()[1:]
        valid = np.loadtxt(base + ".valid", dtype=int)
        ll = np.loadtxt(base + ".likelihood")
        check(len(smiles) == len(valid) == len(ll) == 1000,
              f"{name}: {len(smiles)} SMILES, {len(valid)} flags")
        check(all((s != "[Xx]") == bool(v) for s, v in zip(smiles, valid)),
              f"{name}: SMILES lines disagree with the validity flags")
        check(bool(np.isfinite(ll).all()), f"{name}: non-finite likelihoods")
    check(os.path.exists(os.path.join(job, "generation.log")),
          "generation.log not written")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"    rounds per batch {rounds}, {total} kernel launches")
    log(f"    sampling {2000 / sample_s:.1f} molecules/s "
        f"({sample_s:.3f} s on the sampler), job end to end "
        f"{2000 / wall:.1f} molecules/s ({wall:.2f} s with host chemistry), "
        f"peak device memory {peak:.1f} MiB")
    return launches


def phase_sampler_alone(cfg, model) -> None:
    """The sampler without the job's host-chemistry thread: time per round,
    and the device's busy share over one batch from torch.profiler."""
    from torch.autograd import DeviceType
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    log("[5b sampler alone, B=1000]")
    sampler = GraphSampler(cfg, B, device=torch.device("cuda"))
    sampler.sample_packed(model, batch_generator(0, 99, torch.device("cuda")))
    rounds = secs = 0
    for k in range(3):
        res = sampler.sample(model, batch_generator(0, 100 + k,
                                                    torch.device("cuda")),
                             quiet=True)
        rounds += res.n_rounds
        secs += res.elapsed_s
    log(f"    {rounds} rounds in {secs:.4f} s: {1e3 * secs / rounds:.3f} ms "
        f"per round, {3 * B / secs:.1f} molecules/s")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        res = sampler.sample(model, batch_generator(0, 200,
                                                    torch.device("cuda")),
                             quiet=True)
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if not kernels:
        log("    device busy share: not measured (no device events traced)")
        return
    log(f"    profiled batch: {res.n_rounds} rounds, wall {wall:.4f} s, "
        f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"      {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:70]}")


def unfused_layers(mlps, dt):
    """Per layer (E, K, O) weights and (E, 1, O) biases in dt, for the
    per-layer library path."""
    from graphinvent_tpu_torch.models.core import stacked_layers
    return [(w.transpose(1, 2).to(dt).contiguous(), b.to(dt)[:, None, :])
            for w, b in stacked_layers(mlps)]


def unfused_forward(layers, x2d):
    y = x2d.unsqueeze(0).expand(layers[0][0].shape[0], -1, -1)
    for w, b in layers:
        y = torch.nn.functional.selu(torch.baddbmm(b, y, w))
    return y


def bound(flat, R: int, dt) -> tuple:
    esize = 2 if dt == torch.bfloat16 else 4
    dims = flat.dims
    macs = sum(k * o for k, o in zip(dims[:-1], dims[1:]))
    weight_bytes = flat.E * (macs * esize + sum(dims[1:]) * 4)
    nbytes = R * dims[0] * esize + weight_bytes + flat.E * R * dims[-1] * esize
    flops = 2.0 * R * flat.E * macs
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_timings(fused_enn, model, errs, launches) -> list:
    log("[6 timings, bf16, CUDA events, warm L2]")
    dt = torch.bfloat16
    rows = []
    for i, (name, wrapper, mlps, R, I) in enumerate(main_path_sites(model)):
        x = rand_rows(R, I, i, dt)
        flat = fused_enn.flatten_weights(fused_enn.stacked_layers(mlps), dt,
                                         x.device)
        layers = unfused_layers(mlps, dt)
        plan = fused_enn.launch_plan(R, flat.E, flat.dims)
        other = [p for p in fused_enn.plan_choices(flat.dims) if p != plan][0]
        with torch.inference_mode():
            ms = cuda_ms(lambda: fused_enn.fused_enn_cuda(flat, x))
            other_ms = cuda_ms(lambda: fused_enn.fused_enn_cuda(flat, x, other))
            plain_ms = cuda_ms(
                lambda: fused_enn.fused_stacked_mlp_reference(flat, x))
            library_ms = cuda_ms(lambda: unfused_forward(layers, x))
        bound_ms, bound_by = bound(flat, R, dt)
        check(launches.get(flat.layout, 0) > 0,
              f"{name}: the kernel never ran there on the main path")
        log(f"    {name:<22} kernel {ms:.4f} ms (tile {plan.tile_rows}, "
            f"cluster {plan.cluster}; {other_ms:.4f} ms at tile "
            f"{other.tile_rows}, cluster {other.cluster})  plain "
            f"{plain_ms:.4f} ms  unfused {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        rows.append({
            "name": f"{wrapper}[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches.get(flat.layout, 0),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "plan": {"tile_rows": plan.tile_rows, "cluster": plan.cluster},
            "bound_share": bound_ms / ms, "vs_library": ms / library_ms})
    per_forward = sum(r["ms"] * (3 if "msg_nns" in r["name"] else 1)
                      for r in rows)
    log(f"    sum of one forward's 10 launches: {per_forward:.4f} ms")
    return rows


def main() -> None:
    # the port first: without the repo around it, fail before any output
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model, fused_enn
    device = phase_device()
    phase_build(fused_enn)
    cfg = preset("GGNN", device="cuda", seed=0)
    model = build_model(cfg, torch.Generator().manual_seed(0)).to("cuda")
    model.eval()
    errs = phase_kernels(fused_enn, model, cfg)
    phase_forward(fused_enn, model, cfg)
    launches = phase_generate(fused_enn, cfg, model)
    phase_sampler_alone(cfg, model)
    rows = phase_timings(fused_enn, model, errs, launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    main()
