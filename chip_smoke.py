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
     path at each launch shape, against the card's bound;
  7. a dataset: seeded synthetic SMILES (train / valid / test), then the
     preprocess job through ``main``: the three datasets, train.csv,
     preprocessing_params.csv, row counts, int8;
  8. the train job through ``main`` at preset("GGNN") widths, bf16,
     batch_size=1000, two epochs with an evaluation after each: finite and
     falling losses, a UC-JSD per epoch, checkpoints with their optimizer
     sidecars, the device-resident epoch path, and 10 kernel launches per
     validation batch, NLL batch and sampler round; then one more epoch as
     a restarted job on the streamed path (packed + sparse wire,
     upload-ahead);
  8b. numerics on the card: a train epoch launches no kernel; one train
     step on the same rows in all three wire formats; one f32 train step
     on the card against the CPU (loss and every gradient leaf); the bf16
     validation loss on the kernel path against the plain path;
  8c. timings: a train step (CUDA events and wall; forward, backward,
     optimizer), the device's busy share over 5 profiled steps, a
     validation batch on the kernel path, peak device memory;
  9. the test job through ``main`` on phase 8's checkpoint: "Test" scores
     in validation.log, its NLL batches through the kernel.

The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  The jobs run in temporary directories,
removed at the end.
"""

from __future__ import annotations

import json
import math
import os
import shutil
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


# --------------------------------------------------------------------------
# phases 7-9: dataset, train job, test job
# --------------------------------------------------------------------------

N_MOLECULES = {"train": 4500, "valid": 300, "test": 300}
WIRE_TOL = 1e-6          # the three wire formats decode to the same bytes
# f32 train step, card vs CPU: the loss and each gradient leaf in relative
# L2.  Single entries get a wider bar: both f32 gradients sit some 1e-4 to
# 1e-3 of a leaf's largest entry away from the float64 gradient (three GRU
# passes and twelve SELU layers deep), which phase 8b prints beside it.
STEP_RTOL = 1e-3
STEP_ENTRY_TOL = 5e-3
VALID_LOSS_TOL = 0.05    # bf16 loss, kernel path vs plain path (logits 0.15)


def run_job(job_cfg, job: str):
    """Writes ``input.csv`` and runs the job through the port's ``main``;
    -> (workflow, wall seconds)."""
    from graphinvent_tpu_torch.main import main as port_main
    os.makedirs(job, exist_ok=True)
    job_cfg.replace(job_dir=job + "/").write_csv(
        os.path.join(job, "input.csv"))
    torch.cuda.synchronize()
    t0 = time.time()
    workflow = port_main(["--job-dir", job])
    torch.cuda.synchronize()
    return workflow, time.time() - t0


def phase_dataset(cfg, root: str) -> dict:
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles
    log("[7 dataset + preprocess job]")
    data = os.path.join(root, "data")
    os.makedirs(data)
    t0 = time.time()
    smiles = synthesize_smiles(sum(N_MOLECULES.values()), 9, 13, seed=7)
    check(len(smiles) == sum(N_MOLECULES.values()),
          f"synthesizer made {len(smiles)} molecules")
    lo = 0
    for name, n in N_MOLECULES.items():
        with open(os.path.join(data, name + ".smi"), "w") as fh:
            fh.write("SMILES\n" + "\n".join(smiles[lo:lo + n]) + "\n")
        lo += n
    synth_s = time.time() - t0
    pre_cfg = cfg.replace(job_type="preprocess", dataset_dir=data + "/",
                          batch_size=1000, tensorboard_dir="")
    _, wall = run_job(pre_cfg, os.path.join(root, "preprocess"))
    rows = {}
    for name in N_MOLECULES:
        ds = HDFDataset(store.find_dataset(os.path.join(data, name)))
        for arr, shape in ((ds.nodes, cfg.dim_nodes), (ds.edges, cfg.dim_edges),
                           (ds.apds, (cfg.dim_apd,))):
            check(arr.dtype == np.int8, f"{name}: dtype {arr.dtype}")
            check(tuple(arr.shape[1:]) == tuple(shape),
                  f"{name}: row shape {arr.shape[1:]}")
            check(arr.shape[0] == len(ds), f"{name}: ragged arrays")
        # every molecule ends in exactly one terminate target
        check(int(np.asarray(ds.apds[:, -1]).sum()) == N_MOLECULES[name],
              f"{name}: terminate targets != molecules")
        rows[name] = len(ds)
        backend = ds.backend
        ds.close()
    for name in ("train.csv", "preprocessing_params.csv"):
        check(os.path.exists(os.path.join(data, name)), f"{name} not written")
    check(rows["train"] >= 30000, f"train set has {rows['train']} rows")
    n_mol = sum(N_MOLECULES.values())
    log(f"    {n_mol} molecules synthesized in {synth_s:.2f} s; preprocess "
        f"job {wall:.2f} s ({n_mol / wall:.1f} molecules/s, host only, "
        f"{backend} back end); rows {rows}")
    return {"dir": data, "rows": rows}


def read_convergence(job: str) -> list:
    """[(epoch, lr, train loss, valid loss, score)] of convergence.log."""
    with open(os.path.join(job, "convergence.log")) as fh:
        lines = fh.read().splitlines()[1:]
    return [tuple(float(x) for x in line.split(",")) for line in lines]


def read_validation(job: str) -> dict:
    with open(os.path.join(job, "validation.log")) as fh:
        lines = fh.read().splitlines()[1:]
    return {line.split(",")[0]: [float(x) for x in line.split(",")[1:]]
            for line in lines}


def n_batches(rows: int, batch: int = B) -> int:
    return (rows + batch - 1) // batch


def per_forward(cfg) -> int:
    """Kernel launches of one grad-free GGNN forward: the message stack
    once a pass, two gather MLPs, five readout MLPs (10 at the preset)."""
    return cfg.message_passes + 7


def check_launches(fused_enn, cfg, what: str, forwards: int) -> dict:
    total = sum(fused_enn.LAUNCHES.values())
    check(total == per_forward(cfg) * forwards,
          f"{what}: {total} kernel launches for {forwards} grad-free "
          f"forwards (expected {per_forward(cfg)} each)")
    return dict(fused_enn.LAUNCHES_BY_LAYOUT)


def phase_train(fused_enn, cfg, root: str, data: dict):
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint, load_optimizer_state,
    )
    log("[8 train job: bf16, batch_size=1000, 2 epochs, n_samples=1000]")
    job = os.path.join(root, "train")
    train_cfg = cfg.replace(
        job_type="train", dataset_dir=data["dir"] + "/", batch_size=1000,
        block_size=10000, epochs=2, sample_every=1, n_samples=1000,
        tensorboard_dir="", device="cuda", compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(train_cfg, job)
    rounds = sum(r for r, _ in workflow.batch_stats)
    # per epoch: the validation epoch, then one NLL pass over min(1000,
    # rows) random rows of valid and of train; per sampled batch its rounds
    forwards = 2 * (n_batches(data["rows"]["valid"]) + 2) + rounds
    launches = check_launches(fused_enn, cfg, "train job", forwards)
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(workflow.data_path == "resident",
          f"the train job took the {workflow.data_path} path")
    conv = read_convergence(job)
    check([int(c[0]) for c in conv] == [1, 2], f"convergence.log: {conv}")
    check(all(math.isfinite(x) for c in conv for x in c),
          f"non-finite convergence.log: {conv}")
    check(conv[1][2] < conv[0][2], f"train loss did not fall: {conv}")
    scores = read_validation(job)
    for key in ("Epoch 1", "Epoch 2"):
        check(key in scores and all(math.isfinite(x) for x in scores[key]),
              f"validation.log {key}: {scores.get(key)}")
    reloaded = load_checkpoint(train_cfg, checkpoint_path(job, 2))
    state = load_optimizer_state(job, 2)
    steps = 2 * n_batches(data["rows"]["train"])
    check(state is not None and state["step"] == steps,
          f"optimizer sidecar: {state and state['step']} steps, expected "
          f"{steps}")
    check(sorted(state["mu"]) == sorted(
        n for n, _ in reloaded.named_parameters()),
        "optimizer sidecar does not match the model")
    log(f"    device-resident path; {steps} steps, job {wall:.2f} s; losses "
        f"train {conv[0][2]:.4f} -> {conv[1][2]:.4f}, valid {conv[0][3]:.4f}"
        f" -> {conv[1][3]:.4f}; UC-JSD {scores['Epoch 1'][3]:.4f}, "
        f"{scores['Epoch 2'][3]:.4f}; {rounds} sampler rounds, "
        f"{sum(launches.values())} kernel launches; peak device memory "
        f"{peak:.1f} MiB")

    # one more epoch as a restarted job on the streamed path
    stream_job = os.path.join(root, "train_streamed")
    os.makedirs(stream_job)
    for name in ("model_restart_2.pth", "optimizer_restart_2.pth"):
        shutil.copy(os.path.join(job, name), stream_job)
    stream_cfg = train_cfg.replace(restart=True, epochs=1, schedule_epochs=3,
                                   device_data_gb=0.0)
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(stream_cfg, stream_job)
    rounds = sum(r for r, _ in workflow.batch_stats)
    check_launches(fused_enn, cfg, "streamed train job",
                   n_batches(data["rows"]["valid"]) + 2 + rounds)
    check(workflow.data_path == "streamed",
          f"the second job took the {workflow.data_path} path")
    check(workflow.adam.step == steps + n_batches(data["rows"]["train"]),
          f"restart did not continue Adam: step {workflow.adam.step}")
    conv3 = read_convergence(stream_job)
    check(len(conv3) == 1 and int(conv3[0][0]) == 3
          and all(math.isfinite(x) for x in conv3[0]),
          f"streamed convergence.log: {conv3}")
    check(conv3[0][2] < conv[0][2],
          f"streamed epoch 3 loss {conv3[0][2]} not below epoch 1's")
    log(f"    streamed path (packed + sparse wire, upload-ahead), restarted "
        f"at epoch 3: job {wall:.2f} s, train {conv3[0][2]:.4f} valid "
        f"{conv3[0][3]:.4f}")
    return launches, job


def load_trained(cfg, job: str, dtype: str):
    """Phase 8's checkpoint on the card, and its config under
    ``compute_dtype`` ``dtype``."""
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    run_cfg = cfg.replace(batch_size=1000, compute_dtype=dtype, device="cuda")
    return run_cfg, load_checkpoint(run_cfg, checkpoint_path(job, 2)).to("cuda")


def resident(data: dict, name: str):
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.train.device_data import DeviceDataset
    ds = HDFDataset(store.find_dataset(os.path.join(data["dir"], name)))
    out = DeviceDataset(ds, torch.device("cuda"))
    ds.close()
    return out


def phase_train_numerics(fused_enn, cfg, job: str, data: dict) -> None:
    import copy
    from graphinvent_tpu_torch.data import BlockLoader, HDFDataset, store
    from graphinvent_tpu_torch.train import device_data, step
    from graphinvent_tpu_torch.train.loss import apd_kl_loss
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    log("[8b numerics on the card]")
    dev = torch.device("cuda")
    dtrain, dvalid = resident(data, "train"), resident(data, "valid")

    # a validation epoch on the kernel path fills the wrappers' weight
    # caches; a train epoch then launches no kernel and moves the weights
    bf_cfg, model = load_trained(cfg, job, "bfloat16")
    adam = Adam(model)
    schedule = onecycle_for_config(bf_cfg.replace(epochs=2),
                                   n_batches(dtrain.n_rows))
    valid_epoch = device_data.make_epoch_eval_fn(bf_cfg, dvalid, model)
    valid_perm = device_data.epoch_permutation(dvalid.n_rows, B,
                                               np.random.default_rng(0))
    before = valid_epoch(valid_perm)
    sites = [(name, model.msg_nns if wrapper == "fused_stacked_mlp"
              else mlps[0], mlps)
             for name, wrapper, mlps, _, _ in main_path_sites(model)]
    cached = lambda owner, mlps: fused_enn._cached_flat(
        owner, mlps, torch.bfloat16, dev)
    old = {name: cached(owner, mlps) for name, owner, mlps in sites}
    fused_enn.reset_launch_counts()
    perm = device_data.epoch_permutation(dtrain.n_rows, B,
                                         np.random.default_rng(0))
    loss = device_data.make_epoch_train_fn(bf_cfg, schedule, dtrain, model,
                                           adam)(perm[:8])
    check(math.isfinite(loss), f"train epoch loss {loss}")
    check(sum(fused_enn.LAUNCHES.values()) == 0,
          f"a train epoch launched the kernel: {fused_enn.LAUNCHES}")
    log(f"    8 train steps (bf16): loss {loss:.4f}, 0 kernel launches")

    # stale weights: after those updates every wrapper's cached weights
    # are the new ones, bit for bit
    for name, owner, mlps in sites:
        now = cached(owner, mlps)
        fresh = fused_enn.flatten_weights(fused_enn.stacked_layers(mlps),
                                          torch.bfloat16, dev)
        check(not torch.equal(now.slabs, old[name].slabs),
              f"{name}: 8 train steps left its bf16 weights unchanged")
        check(torch.equal(now.slabs, fresh.slabs)
              and torch.equal(now.w, fresh.w) and torch.equal(now.b, fresh.b),
              f"{name}: the wrapper's cached weights are stale")
    plain_cfg = bf_cfg.replace(fused_inference_enn=False)
    fused_loss = valid_epoch(valid_perm)
    launched = sum(fused_enn.LAUNCHES.values())
    model.cfg = plain_cfg
    try:
        plain_loss = device_data.make_epoch_eval_fn(plain_cfg, dvalid, model)(
            valid_perm)
    finally:
        model.cfg = bf_cfg
    check(launched == per_forward(cfg) * len(valid_perm),
          f"validation epoch: {launched} launches for {len(valid_perm)} "
          "batches")
    check(sum(fused_enn.LAUNCHES.values()) == launched,
          "the plain path launched the kernel")
    log(f"    weight caches of all {len(sites)} sites follow the updates; "
        f"bf16 validation loss {before:.5f} before, after: kernel path "
        f"{fused_loss:.5f}, plain path {plain_loss:.5f}, |diff| "
        f"{abs(fused_loss - plain_loss):.2g} (tol {VALID_LOSS_TOL})")
    check(abs(fused_loss - plain_loss) <= VALID_LOSS_TOL,
          "validation loss: kernel path disagrees with the plain path")

    # one train step on the same rows in the three wire formats
    f32_cfg, model32 = load_trained(cfg, job, "float32")
    ds = HDFDataset(store.find_dataset(os.path.join(data["dir"], "train")))
    place = step.BatchUploader(dev)
    wires = {
        "plain": BlockLoader(ds, B, 10000, seed=3),
        "packed": BlockLoader(ds, B, 10000, seed=3, packed=True),
        "sparse": BlockLoader(ds, B, 10000, seed=3, packed=True, apd_nnz=32),
    }
    results = {}
    for name, loader in wires.items():
        batch = place(next(iter(loader)))
        if name == "sparse":
            check("apds_i" in batch, "the sparse wire fell back to dense")
        m = copy.deepcopy(model32)
        loss = step.train_loss(f32_cfg, m, batch)
        loss.backward()
        results[name] = (loss.item(), [p.grad for p in m.parameters()])
    ds.close()
    for name in ("packed", "sparse"):
        dl = abs(results[name][0] - results["plain"][0])
        dg = max((a - b).abs().max().item() for a, b in
                 zip(results[name][1], results["plain"][1]))
        log(f"    f32 train step, {name} wire vs plain wire: |loss diff| "
            f"{dl:.2g}, max |grad diff| {dg:.2g} (tol {WIRE_TOL})")
        check(dl <= WIRE_TOL and dg <= WIRE_TOL,
              f"{name} wire disagrees with the plain wire")

    # one f32 train step on the card against the CPU, and both against
    # float64 on the card
    idx = torch.from_numpy(perm[0, :256].astype(np.int64)).to(dev)
    batch = device_data._gather_batch(dtrain, idx)

    def loss_and_grads(m, b):
        loss = step.train_loss(f32_cfg, m, b)
        loss.backward()
        return loss.item(), [p.grad.double().cpu() for p in m.parameters()]

    gpu_loss, gpu = loss_and_grads(copy.deepcopy(model32), batch)
    cpu_loss, cpu = loss_and_grads(copy.deepcopy(model32).to("cpu"),
                                   {k: v.cpu() for k, v in batch.items()})
    model64 = copy.deepcopy(model32).double()
    nodes, edges, apds, valid = step.batch_arrays(f32_cfg, batch,
                                                  torch.float64)
    apd_kl_loss(model64(nodes, edges, train=True), apds.double(),
                valid.double()).backward()
    f64 = [p.grad.cpu() for p in model64.parameters()]
    names = [n for n, _ in model32.named_parameters()]

    def worst(a, b):
        """Largest per-leaf error of a against b: (relative L2, largest
        entry's difference over b's largest entry, leaf)."""
        l2 = max(((x - y).norm() / y.norm()).item() for x, y in zip(a, b))
        mx, leaf = max((((x - y).abs().max() / y.abs().max()).item(), n)
                       for x, y, n in zip(a, b, names))
        return l2, mx, leaf

    l2, mx, leaf = worst(gpu, cpu)
    dl = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    log(f"    f32 train step at B=256, card vs CPU: loss {gpu_loss:.6f} vs "
        f"{cpu_loss:.6f} (rel {dl:.2g}); gradient leaves: worst relative L2 "
        f"{l2:.2g} (tol {STEP_RTOL}), worst entry {mx:.2g} of its leaf's "
        f"largest ({leaf}; tol {STEP_ENTRY_TOL})")
    for tag, grads in (("card f32", gpu), ("CPU f32", cpu)):
        l2_64, mx_64, _ = worst(grads, f64)
        log(f"      {tag} vs card f64: worst relative L2 {l2_64:.2g}, worst "
            f"entry {mx_64:.2g}")
    check(dl <= STEP_RTOL, "f32 loss: card disagrees with the CPU")
    check(l2 <= STEP_RTOL and mx <= STEP_ENTRY_TOL,
          f"f32 gradients: card disagrees with the CPU ({leaf})")


def phase_train_timings(fused_enn, cfg, job: str, data: dict) -> None:
    from torch.autograd import DeviceType
    from graphinvent_tpu_torch.models.core import stacked_layers
    from graphinvent_tpu_torch.train import device_data, step
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    log("[8c train and validation timings, bf16, B=1000]")
    dev = torch.device("cuda")
    dtrain, dvalid = resident(data, "train"), resident(data, "valid")
    run_cfg, model = load_trained(cfg, job, "bfloat16")
    adam = Adam(model)
    schedule = onecycle_for_config(run_cfg.replace(epochs=2),
                                   n_batches(dtrain.n_rows))
    train_step = step.make_train_step(run_cfg, schedule, model, adam)
    perm = torch.from_numpy(device_data.epoch_permutation(
        dtrain.n_rows, B, np.random.default_rng(1)).astype(np.int64)).to(dev)
    n_steps = min(30, len(perm) - 1)

    def one_step(k: int) -> None:
        train_step(device_data._gather_batch(dtrain, perm[k % len(perm)]))

    for k in range(3):
        one_step(k)
    torch.cuda.synchronize()
    t0 = time.time()
    step_ms = cuda_ms(lambda: one_step(0), iters=n_steps, warmup=0)
    wall_ms = 1e3 * (time.time() - t0) / n_steps
    log(f"    train step: {step_ms:.3f} ms (CUDA events over {n_steps} "
        f"steps), {wall_ms:.3f} ms wall, {1e3 * B / wall_ms:.0f} rows/s")

    # forward / backward / optimizer, each between its own events
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(n_steps)]
    for k in range(n_steps):
        batch = device_data._gather_batch(dtrain, perm[k])
        adam.zero_grad()
        marks[k][0].record()
        loss = step.train_loss(run_cfg, model, batch)
        marks[k][1].record()
        loss.backward()
        marks[k][2].record()
        adam.update(*schedule(adam.step))
        marks[k][3].record()
    torch.cuda.synchronize()
    parts = [sum(m[i].elapsed_time(m[i + 1]) for m in marks) / n_steps
             for i in range(3)]
    log(f"    of which forward {parts[0]:.3f} ms, backward {parts[1]:.3f} ms,"
        f" optimizer {parts[2]:.3f} ms (between CUDA events, so each holds "
        "the host's enqueue time where the device waits for it)")
    with torch.no_grad():
        stack_ms = cuda_ms(lambda: stacked_layers(list(model.msg_nns)))
    log(f"    stacking the message towers' weights: {stack_ms:.4f} ms a "
        f"call, {run_cfg.message_passes} calls a forward")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for k in range(5):
            one_step(k)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        log(f"    5 profiled steps: wall {wall:.4f} s, device busy "
            f"{busy:.4f} s ({100 * busy / wall:.1f}%), {len(kernels)} "
            "kernel names")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"      {e.self_device_time_total / 1e3:9.3f} ms  "
                f"{e.count:5d}x  {e.key[:70]}")
    else:
        log("    device busy share: not measured (no device events traced)")

    eval_step = step.make_eval_step(run_cfg, model)
    vperm = torch.from_numpy(device_data.epoch_permutation(
        dvalid.n_rows, B, np.random.default_rng(0)).astype(np.int64)).to(dev)
    fused_enn.reset_launch_counts()
    valid_ms = cuda_ms(lambda: eval_step(
        device_data._gather_batch(dvalid, vperm[0])))
    check(sum(fused_enn.LAUNCHES.values()) == per_forward(cfg) * (3 + 20),
          f"validation batches: {fused_enn.LAUNCHES}")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(20):
        eval_step(device_data._gather_batch(dvalid, vperm[0]))
    torch.cuda.synchronize()
    log(f"    validation batch on the kernel path: {valid_ms:.3f} ms (CUDA "
        f"events), {1e3 * (time.time() - t0) / 20:.3f} ms wall")

    # one evaluation, piece by piece: the sampler, the analyzer's host
    # chemistry on this thread, the two NLL passes
    from graphinvent_tpu_torch.eval.analyzer import Analyzer
    from graphinvent_tpu_torch.workflow import Workflow, eval_sample_generator
    scratch = os.path.join(os.path.dirname(job), "evaluation")
    os.makedirs(scratch)
    wf = Workflow(run_cfg.replace(job_type="train", job_dir=scratch + "/",
                                  dataset_dir=data["dir"] + "/",
                                  tensorboard_dir=""))
    analyzer = Analyzer(wf.cfg, wf.logger, wf._load_ts_properties(),
                        wf.start_time)
    sampler = wf._get_sampler(B)
    sampler.sample(model, eval_sample_generator(0, 0, 0, dev), quiet=True)
    t0 = time.time()
    res = sampler.sample(model, eval_sample_generator(0, 1, 0, dev),
                         quiet=True)
    t1 = time.time()
    analyzer.evaluate_generated_graphs(
        res.graphs, res.properly_terminated, res.final_loglikelihoods,
        epoch_key="Epoch 1", write=True, plot=True)
    t2 = time.time()
    rng = np.random.default_rng(1)
    for dset in (dvalid, dtrain):
        nlls, valid = device_data.make_epoch_nll_fn(run_cfg, dset, model)(
            device_data.nll_row_batches(dset.n_rows, B, B, rng))
        check(bool(np.isfinite(nlls[valid > 0]).all()), "non-finite NLLs")
    t3 = time.time()
    log(f"    one evaluation of {B} samples (wall): sampler {t1 - t0:.3f} s "
        f"({res.n_rounds} rounds), analyzer's host chemistry "
        f"{t2 - t1:.3f} s, 2 NLL batches {t3 - t2:.3f} s")


def phase_test(fused_enn, cfg, job: str, data: dict) -> dict:
    log("[9 test job on the checkpoint of phase 8]")
    test_cfg = cfg.replace(
        job_type="test", dataset_dir=data["dir"] + "/", batch_size=1000,
        block_size=10000, n_samples=1000, tensorboard_dir="", device="cuda",
        compute_dtype="bfloat16")
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(test_cfg, job)
    rounds = sum(r for r, _ in workflow.batch_stats)
    # one sampled batch, then one NLL batch of test rows and one of train
    launches = check_launches(fused_enn, cfg, "test job", rounds + 2)
    scores = read_validation(job)
    check("Test 2" in scores and all(math.isfinite(x)
                                     for x in scores["Test 2"]),
          f"validation.log: {scores}")
    log(f"    job {wall:.2f} s; {rounds} sampler rounds + 2 NLL batches, "
        f"{sum(launches.values())} kernel launches; Test 2: NLL test "
        f"{scores['Test 2'][0]:.4f}, train {scores['Test 2'][1]:.4f}, "
        f"generated {scores['Test 2'][2]:.4f}, UC-JSD "
        f"{scores['Test 2'][3]:.4f}")
    return launches


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


def phase_timings(fused_enn, model, errs, by_job) -> list:
    log("[6 timings, bf16, CUDA events, warm L2]")
    dt = torch.bfloat16
    rows = []
    launches = {}
    for counts in by_job.values():
        for layout, n in counts.items():
            launches[layout] = launches.get(layout, 0) + n
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
        for job, counts in by_job.items():
            check(counts.get(flat.layout, 0) > 0,
                  f"{name}: the kernel never ran there in the {job} job")
        log(f"    {name:<22} kernel {ms:.4f} ms (tile {plan.tile_rows}, "
            f"cluster {plan.cluster}; {other_ms:.4f} ms at tile "
            f"{other.tile_rows}, cluster {other.cluster})  plain "
            f"{plain_ms:.4f} ms  unfused {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        rows.append({
            "name": f"{wrapper}[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[flat.layout],
            "launches_by_job": {job: counts[flat.layout]
                                for job, counts in by_job.items()},
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
    by_job = {"generate": phase_generate(fused_enn, cfg, model)}
    phase_sampler_alone(cfg, model)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        data = phase_dataset(cfg, root)
        by_job["train"], job = phase_train(fused_enn, cfg, root, data)
        phase_train_numerics(fused_enn, cfg, job, data)
        phase_train_timings(fused_enn, cfg, job, data)
        by_job["test"] = phase_test(fused_enn, cfg, job, data)
    rows = phase_timings(fused_enn, model, errs, by_job)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    main()
