#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA GPU (H100) and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: name, count, power limit; TF32 off;
  2. build: compiles the fused ENN kernel from the repo's CUDA source and,
     alongside it, the native chemistry library with g++ (every host-chemistry
     site of phases 5-13 takes it: ``native_chem`` is on by default), and
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
     kernel; then (5b) the sampler alone on that model with its head
     raised (rollouts of ~14 rounds), its rounds replayed from captured
     CUDA graphs against the eager loop on the same batches: packed bytes,
     the generator's final state and the launches equal; time per round
     and molecules/s both ways in turns, a round's device time alone, four
     rounds each way beside a thread running Python, each way's busy share
     and kernel names from torch.profiler (a replay's trace must name the
     fused kernel), device memory;
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
     step on the same rows in all three wire formats; one train step on
     the card against the CPU (as in phase 12); the bf16 validation loss
     on the kernel path against the plain path;
  8c. timings: a train step (CUDA events and wall; forward, backward,
     optimizer), the device's busy share over 5 profiled steps, a
     validation batch on the kernel path, peak device memory;
  8d. the resident epoch's steps replayed from a captured CUDA graph
     (``train/step_graphs.py``) against the eager loop on phase 8's
     checkpoint and phase 7's rows, B=1000: two epochs of 8 steps each
     way with per-step losses, weights, Adam's moments and step, and the
     dropout generator's state byte-equal, one capture, 0 launches, then
     the validation loss on the kernel path equal both ways (the version
     counters moved); a step's time both ways (host clock over a whole
     epoch to its one read), with ``max_memory_allocated`` and the
     reserved memory over it, and the device's busy share over 5 profiled
     steps;
  9. the test job through ``main`` on phase 8's checkpoint: "Test" scores
     in validation.log, its NLL batches through the kernel;
  10. the other five models (MNN, S2V, AttS2V, AttGGNN, EMN) at their
     presets, B=1000: the kernel against its plain version at the AttGGNN's
     and the EMN's launch shapes (packed and dense edge layouts; random
     rows and the first pass's all-zero rows); each model's forward in
     bf16 and f32, kernel path against plain path, with its launches
     counted (AttGGNN 6, EMN 9 packed and 8 dense, the others 0), and the
     packed form of AttS2V, AttGGNN and EMN against the dense form on the
     same weights;
  11. their jobs through ``main`` on phase 7's dataset, bf16: a train job
     of one epoch with its evaluation for each model (the validation loss
     must fall below the seeded initial model's), for AttGGNN and EMN also
     a generate job (for the EMN once more with the dense layout) and a
     test job, with launch accounting per job;
  12. their numerics and timings on the card: one train step on the card
     against the CPU: the f32 loss, every f32 gradient leaf with the CPU's
     step taken on the card's SELU branches (SELU's derivative jumps at 0,
     so a pre-activation that rounding puts across 0 moves every gradient
     upstream of it: ``selu_branches``), and every float64 gradient leaf;
     a seeded sampler batch run twice (byte-equal), and graphed against
     eager as in 5b (bytes, generator state, launches); a selection on the
     packed edge list as a gather against the one-hot product; time per
     sampler round; each model's train epochs graphed against eager as in
     8d (byte-equal; a step's time, busy share and memory both ways);
  13. the fine-tune job and the two-phase sampler, bf16, B=1000, on
     pretrained models whose rollouts build molecules: phase 8's GGNN and
     phase 11's AttGGNN and EMN checkpoints with their APD heads' "add to
     node 0" and "terminate" logits raised; the GGNN's seeded rollouts must
     build valid molecules that score above 0;
  13a. the fine-tune job through ``main`` (QED x target_size=9,
     continuous, sigma 20, alpha 0.5; GGNN 3 steps with one evaluation and
     checkpoint, AttGGNN and EMN one step each): finite losses,
     fine-tuning.log, convergence.log, a checkpoint with its optimizer
     sidecar, BASF rows past the gate in some GGNN step, and exactly one
     forward's launches (GGNN 10, AttGGNN 6, EMN 9) at every sampler round
     and every forward-only replay step, none in the gradient replays;
  13b. numerics: the forward-only replay of 1,000 trajectories, kernel path
     against plain path per trajectory (f32 1e-3; bf16 the bar that
     ``probe_rl_numerics.py --device cpu`` read); the f32 sampler's
     recorded ll against the replay of its actions (1e-4); one ``rl_loss``
     gradient at B=64 on the card against the CPU (as phase 12: f32 loss
     1e-3, every f32 leaf 2e-4 on the card's SELU branches, every float64
     leaf 1e-9), with no kernel launch; one learning step (the step
     overlaps host scoring with the device: ``FineTuner.step``): the prior
     and the BASF byte-equal to before, the agent's kernel-path logits
     within 0.15 of its plain path's, the same step from the same seed and
     checkpoint again gives byte-equal agent weights, and the same step
     composed in sequence from ``rollout`` / ``replay`` / ``learn`` on a
     fresh copy gives the same loss and agent weights bit for bit; 13a's
     GGNN job and 15e's QSAR-scored job are each run once more with every
     step so composed: fine-tuning.log, convergence.log and the agent's
     weights byte-equal;
  13c. timings: a step split into its pieces (CUDA events at each piece's
     end), the host seconds it waited for the scoring worker
     (``scoring_wait``) and its wall, with its rollouts graphed and, one
     step later, on the eager loop; the agent's rollout with the refresh
     of its captured round (its weights moved in place), replayed and
     eager; the device's busy
     share over a profiled step, the gradient replay's time and peak
     memory at ``rl_remat_segment`` 1 and 2;
  13d. the generate job with the two-phase sampler (n_samples=4000, phase 1
     capped at TWO_PHASE_ROUNDS rounds) on the fine-tune GGNN: launches 10
     a round of every loop, the job's files, and every row that finished in
     phase 1 byte-equal to the single-phase sampler's row (and its
     likelihood in the job's file);
  14a. the native chemistry against the Python path, byte for byte, with
     both paths' times: validity and canonical SMILES of phase 5's 2,000
     graphs and the analyzer's evaluation of them, the QED float64s of the
     2,000 molecules of phase 13's first GGNN fine-tune step, phase 7's
     datasets preprocessed with ``native_chem`` True and False; phase 5's
     generate job once more on the Python path (the sampler's ms a round
     beside the analyzer's thread);
  14b. phase 8's checkpoint and Adam sidecar written as the JAX package's
     ``.ckpt`` (``save_jax_checkpoint``) and as a reference v1.0
     whole-module pickle: f32 logits of both bit-equal to the ``.pth``
     model's; from the ``.ckpt``, in fresh job dirs, a generate job (10
     launches a round), a train job restarted for one epoch with its
     evaluation (per-step losses, convergence.log and weights equal to a
     restart from the ``.pth`` and its sidecar) and a fine-tune step whose
     ``pretrained_model_dir`` holds only the ``.ckpt``;
  15a. the MOSES benchmarking flow at ChEMBL-proxy width (N=40, aromatic
     bonds, E=4) through ``tools/campaign_chembl`` in process: 1,500 seeded
     SMILES of 25-40 atoms, 2 preprocess shards as processes and their
     combine, a GGNN train job (preset widths, bf16, B=1000, 1 epoch with
     its evaluation), 4,000 generated, the test job and the MOSES score;
     10 launches a forward in every job; then the kernel against its plain
     version at every N=40 launch shape (phase 3's bars) and phase 6's
     timings there (the kernels line gains these rows);
  15b. MOSES on the card: IntDiv of 30,000 seeded fingerprints at the
     density of 15a's training molecules, timed; 4,000 of them against the
     CPU (integer counts equal, IntDiv within 1e-6); ``compute_metrics``
     with 8 worker processes twice in this process, after CUDA init;
  15c. ``tools/roofline`` rows (mfu, sol_fraction, bound, with the card's
     name and power limit) of the train step and the sampler round at
     N=13 (phase 7's data, phase 8's model) and N=40 (15a's);
  15d. ``tools/ab_two_phase`` on phase 13's raised GGNN at N=13, cap
     TWO_PHASE_ROUNDS, 4 batches: molecules/s both ways;
  15e. ``tools/train_qsar`` (logistic, on the card) on stand-in labels
     ("has a ring") of phase 7's SMILES, then one fine-tune step through
     ``main`` scored by that model with QED (10 launches a rollout round
     and a forward-only replay step, none in the gradient replay);
  16. multi-process jobs (``parallel/``), two ranks sharing the card over
     gloo (``GRAPHINVENT_DIST_BACKEND=gloo``: NCCL refuses two ranks on one
     card), each rank ``python3 chip_smoke.py --rank-job <dir> <report>``
     (the job through ``main``, its kernel launches, its global losses, step
     and all-reduce seconds), started by ``parallel/launch.py`` under a
     wall-clock limit (a failed rank kills the other; both outputs are
     printed); rank 1 must write nothing into its job dir in any job:
  16a. a 2-process preprocess of phase 7's SMILES: datasets, train.csv and
     preprocessing_params.csv byte-equal to one process's 2-shard run;
  16b. a 2-process train job (500 rows a rank, blocks of 1,000), one epoch
     restarted from phase 8's checkpoint: in f32 its per-step global losses
     against one process on the card on the same global batch stream (rtol
     1e-4); in bf16 with its evaluation on rank 0, timed (the step, its gloo
     all-reduce), each rank's launches exactly 10 x its grad-free forwards
     (rank 1: its validation batches at 500 graphs); the kernel against its
     plain version at the 500-graph shapes (phase 3's bars), and phase 6's
     timings there (the kernels line gains these rows);
  16c. a 2-process generate job (4,000 samples, 2 rounds of 2 batches) on
     phase 8's checkpoint: files byte-equal to one process's job, launches
     10 x each rank's rounds, molecules/s of both on the shared card;
  16d. a 2-process test job and fine-tune step: rank 0's files (and the
     fine-tuned weights) byte-equal to one process's job, rank 1 returns at
     once (no launch);
  16e. ``tools/bench_scaling`` at dp=1 on NCCL and dp=1, 2 on gloo (the
     second labelled "shared card"); two NCCL ranks on one card refused;
     ``tools/trace_step`` and ``tools/trace_sampler`` with their tables
     (the fused kernel's launches by its wrapper and in CUPTI's list);
     ``tools/create_dataset`` (serial and 4 ``forkserver`` workers, same
     files) and ``tools/dataset_stats`` on phase 7's SMILES;
  17. one process's mesh (data, model, graph), its ranks sharing the card
     over gloo: 17a the kernel at a rank's node part and at the split
     head's slices; 17b a test job with graph=2; 17c an f32 step at N=40
     over mp=2 x graph=2 against one device's; 17d a dp=2 generate job and
     a dp=2 x graph=2 fine-tune step, and that step's gradient replay on
     four ranks; 17e ``train_qsar --classifier svc`` against the CPU fit;
  18. a ``.h5`` dataset written elsewhere, read on the card with ``import
     h5py`` blocked throughout: 18a the committed fixture
     (``tests/torch_port_data/ggnn_n13.h5``, written by the JAX package's
     preprocessing) through ``ReadStore``: each array's shape, dtype and
     sha256 against its manifest, the seconds to open it and read it whole
     beside the same arrays as ``.npd``; 18b the test job through ``main``
     on it as test.h5 and train.h5 (phase 8's checkpoint, B=1000, bf16):
     validation.log and the generated files byte-equal to the job on the
     ``.npd`` copy, launches exactly 10 x (rounds + NLL batches), and the
     kernel against its plain version at the NLL batch's shapes (phase 3's
     weights, inputs and bars); 18c one streamed epoch restarted from
     phase 8 on it as
     train.h5 and valid.h5: per-step losses, convergence.log and
     validation.log bit-equal to the epoch on the ``.npd`` copy, one APD
     wire format for each dataset (printed), launches exactly 10 x the
     grad-free forwards;
  19. every cell of ``BENCHMARK.json`` once, at one repeat, through the
     benchmark's own command (``python -m graphinvent_tpu_torch.bench
     --cell NAME --repeats 1``, a process of its own): one JSON line on
     stdout, each check's reading beside its bar and its positive
     control's, and ``correct`` true.

Each phase's header line carries the seconds since the script started.
The second-to-last line is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  The jobs run in temporary directories,
removed at the end.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from graphinvent_tpu_torch.utils.device import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 1.0 / 64}
LOGIT_TOL = {torch.bfloat16: 0.15, torch.float32: 2e-3}
REPLACES = "graphinvent_tpu/models/fused_enn.py:98"
SOURCE = "graphinvent_tpu_torch/models/csrc/fused_enn.cu"
B, N = 1000, 13
ROOT = os.path.dirname(os.path.abspath(__file__))


START = time.time()


def log(msg: str) -> None:
    if msg.startswith("["):
        msg += f"  (at {time.time() - START:.0f} s)"
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
            name = next((k for k in ("wgmma_kernelILi64ELb0",
                                     "wgmma_kernelILi64ELb1",
                                     "wgmma_kernelILi128", "f32_kernel")
                         if k in mangled), mangled)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            rows.append((name, line.split(":", 1)[1].strip(), spill))
    return rows


def phase_build(fused_enn) -> float:
    """Builds the kernel with nvcc and the chemistry library with g++, the
    two compilers running together; -> g++'s seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from graphinvent_tpu_torch.chem import native

    def timed(build):
        t0 = time.time()
        return build(), time.time() - t0

    with ThreadPoolExecutor(max_workers=1) as pool:
        gxx = pool.submit(timed, native.build_library)
        path, nvcc_s = timed(fused_enn.build_library)
        lib, gxx_s = gxx.result()
    native.library()
    log(f"[2 build] {os.path.relpath(path, ROOT)} in {nvcc_s:.2f} s; "
        f"{os.path.relpath(lib, ROOT)} in {gxx_s:.2f} s (g++, alongside)")
    report = ptxas_report(fused_enn.BUILD_LOG)
    for name, regs, spill in report:
        log(f"    {name:<20} {regs}; {spill}")
    if not report:
        log("    ptxas report: not printed (library already built)")
        return gxx_s
    log("    ptxas warpgroup.arrive injections: "
        f"{fused_enn.BUILD_LOG.count('C7519')}, wgmma serialized: "
        f"{fused_enn.BUILD_LOG.count('are serialized')}")
    return gxx_s


OTHER_MODELS = ("MNN", "S2V", "AttS2V", "AttGGNN", "EMN")


class Site(NamedTuple):
    """One launch shape of the kernel on a model's forward at B x N.
    ``owners``: the tower lists launched at this shape, each with weights
    of its own (the AttGGNN's two stacks, the EMN's two per-edge nets);
    ``per_forward``: launches of the site in one grad-free forward."""
    name: str
    wrapper: str
    owners: list
    rows: int
    width: int
    lead: tuple
    per_forward: int


def emn_is_packed(cfg) -> bool:
    from graphinvent_tpu_torch.models import mpnn
    return mpnn._use_packed(cfg)


def main_path_sites(model, batch: int = B) -> list:
    """Every launch shape of the kernel in one grad-free forward of
    ``model`` at ``batch`` x its config's max_n_nodes."""
    from graphinvent_tpu_torch.models import mpnn
    cfg = model.cfg
    passes = cfg.message_passes
    N = cfg.max_n_nodes
    R1, H = batch * N, cfg.hidden_node_features
    one = lambda name, mlp_, rows, width: Site(
        name, "fused_mlp", [[mlp_]], rows, width,
        (batch, N) if rows == R1 else (batch,), 1)
    if cfg.model == "GGNN":
        head = model.APDReadout
        return [
            Site("msg_nns", "fused_stacked_mlp", [list(model.msg_nns)], R1, H,
                 (batch, N), passes),
            one("gather.att_nn", model.gather.att_nn, R1,
                H + cfg.n_node_features),
            one("gather.emb_nn", model.gather.emb_nn, R1, H),
            one("APDReadout.fAddNet1", head.fAddNet1, R1, H),
            one("APDReadout.fConnNet1", head.fConnNet1, R1, H),
            one("APDReadout.fAddNet2", head.fAddNet2, batch,
                cfg.len_f_add + cfg.gather_width),
            one("APDReadout.fConnNet2", head.fConnNet2, batch,
                cfg.len_f_conn + cfg.gather_width),
            one("APDReadout.fTermNet2", head.fTermNet2, batch,
                cfg.gather_width),
        ]
    if cfg.model == "AttGGNN":
        return [Site("AttGGNN.msg_nns|att_nns", "fused_stacked_mlp",
                     [list(model.msg_nns), list(model.att_nns)], R1, H,
                     (batch, N), 2 * passes)]
    if cfg.model == "EMN":
        D = cfg.edge_emb_size
        nets = [[model.att_msg_nn], [model.emb_msg_nn]]
        if not emn_is_packed(cfg):
            return [Site("EMN dense.att_msg_nn|emb_msg_nn", "fused_mlp", nets,
                         batch * N * N, D, (batch, N, N), 2 + 2 * passes)]
        cap = mpnn._emn_edge_capacity(cfg)
        return [
            Site("EMN.embedding_nn", "fused_mlp", [[model.embedding_nn]],
                 batch * cap, 2 * cfg.n_node_features + cfg.n_edge_features,
                 (batch, cap), 1),
            Site("EMN.att_msg_nn|emb_msg_nn", "fused_mlp", nets, batch * cap,
                 D, (batch, cap), 2 + 2 * passes)]
    return []


def rand_rows(rows: int, width: int, seed: int, dtype) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=(rows, width)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)


def kernel_check(fused_enn, name, wrapper, mlps, x2d, lead) -> float:
    """The wrapper the main path calls, against the plain version on the
    same inputs; returns max |kernel - plain|."""
    dt = x2d.dtype
    with torch.inference_mode():
        path = None
        if wrapper == "fused_stacked_mlp":
            got = fused_enn.fused_stacked_mlp(
                torch.nn.ModuleList(mlps), x2d.reshape(*lead, -1))
            got = got.reshape(len(mlps), x2d.shape[0], -1)
        elif wrapper == "fused_layer":
            lin = mlps[0].linears[0]
            got = fused_enn.fused_layer(lin, x2d.reshape(*lead, -1))
            got = got.reshape(1, x2d.shape[0], -1)
            # the split head's own plain path (models/readout._split_mlp)
            path = torch.nn.functional.selu(
                torch.matmul(x2d, lin.weight.to(dt).t()) + lin.bias.to(dt))
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
    if path is not None:
        e = (got[0].float() - path.float()).abs().max().item()
        log(f"    {name:<24} {str(dt)[6:]:<8} max|fused_layer - "
            f"selu(x W^T + b)| {e:.3g} (tol {TOL[dt]:.3g} abs + rel)")
        check(torch.allclose(got[0].float(), path.float(), atol=TOL[dt],
                             rtol=TOL[dt]),
              f"{name} {dt}: fused_layer disagrees with the split head's "
              "plain path")
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


def sites_check(fused_enn, sites, zero_rows: bool = False) -> dict:
    """Every owner of every site against the plain version, f32 and bf16;
    -> the bf16 max |kernel - plain| per site."""
    errs = {}
    for i, site in enumerate(sites):
        for k, mlps in enumerate(site.owners):
            for dt in (torch.float32, torch.bfloat16):
                xs = [("", rand_rows(site.rows, site.width, 100 * k + i, dt))]
                if zero_rows:
                    xs.append((" zero rows", torch.zeros_like(xs[0][1])))
                for tag, x in xs:
                    err = kernel_check(fused_enn, f"{site.name}[{k}]{tag}"
                                       if len(site.owners) > 1 or tag
                                       else site.name,
                                       site.wrapper, mlps, x, site.lead)
                    if dt == torch.bfloat16:
                        errs[site.name] = max(errs.get(site.name, 0.0), err)
    return errs


def phase_kernels(fused_enn, model, cfg) -> dict:
    from graphinvent_tpu_torch.models.core import MLP
    log("[3 kernel vs plain]")
    errs = sites_check(fused_enn, main_path_sites(model))
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


def with_cfg(model, cfg, fn):
    """``fn()`` while ``model`` runs under ``cfg``."""
    old = model.cfg
    model.cfg = cfg
    try:
        return fn()
    finally:
        model.cfg = old


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
            plain = with_cfg(model, plain_cfg,
                             lambda: model(nodes, edges).float())
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
        plain_ms = with_cfg(model, plain_cfg,
                            lambda: cuda_ms(lambda: model(nodes, edges)))
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
    per_round = [1e3 * secs / r for r, secs in workflow.batch_stats]
    log(f"    rounds per batch {rounds}, {total} kernel launches; sampler "
        f"ms a round per batch {[round(x, 3) for x in per_round]} (batch 1 "
        f"beside the analyzer of batch 0, native_chem={job_cfg.native_chem})")
    log(f"    sampling {2000 / sample_s:.1f} molecules/s "
        f"({sample_s:.3f} s on the sampler), job end to end "
        f"{2000 / wall:.1f} molecules/s ({wall:.2f} s with host chemistry), "
        f"peak device memory {peak:.1f} MiB")
    return launches


def profiled_batch(sampler, model, k: int) -> dict:
    """One batch under torch.profiler: wall, device busy seconds, kernels
    by device time."""
    from torch.autograd import DeviceType
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    dev = torch.device("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        res = sampler.sample(model, batch_generator(0, k, dev), quiet=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return dict(rounds=res.n_rounds, wall=wall, kernels=kernels,
                busy=sum(e.self_device_time_total for e in kernels) / 1e6)


def graphed_vs_eager(cfg, model, seeds, what: str) -> dict:
    """The same seeded batches on a graphed sampler and an eager one, in
    turns eager, graphed, graphed, eager: packed bytes, the generator's
    final state and the launches must be equal; -> per way [rounds,
    seconds] and the first graphed batch's seconds (with its capture)."""
    from graphinvent_tpu_torch.models import fused_enn
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import (
        _packed_rounds, batch_generator,
    )
    dev = torch.device("cuda")
    ways = {"graphed": GraphSampler(cfg, B, device=dev),
            "eager": GraphSampler(cfg, B, device=dev, _eager=True)}
    torch.cuda.synchronize()
    t0 = time.time()
    ways["graphed"].sample_packed(model, batch_generator(0, 99, dev))
    torch.cuda.synchronize()
    first = time.time() - t0
    ways["eager"].sample_packed(model, batch_generator(0, 99, dev))
    got = {w: [] for w in ways}
    times = {w: [0, 0.0] for w in ways}
    for way in ("eager", "graphed", "graphed", "eager"):
        for k in seeds:
            gen = batch_generator(0, k, dev)
            fused_enn.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            packed = ways[way].sample_packed(model, gen)
            secs = time.time() - t0
            times[way][0] += _packed_rounds(cfg, packed)
            times[way][1] += secs
            got[way].append((packed.tobytes(), gen.get_state(),
                             fused_enn.launch_counts()))
    for (pg, sg, lg), (pe, se, le) in zip(got["graphed"], got["eager"]):
        check(pg == pe, f"{what}: graphed and eager batches differ")
        check(torch.equal(sg, se),
              f"{what}: the generator ends in another state")
        check(lg == le, f"{what}: launches graphed {lg} != eager {le}")
    check(ways["graphed"]._graphs.captures == 1,
          f"{what}: {ways['graphed']._graphs.captures} captures")
    return dict(ways=ways, times=times, first=first, batches=len(got["eager"]))


def python_thread():
    """A thread that runs Python until stopped, holding the GIL as the
    analyzer's Python does (a stand-in for it); -> its stop function."""
    import threading
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(i * i for i in range(20000))

    thread = threading.Thread(target=spin)
    thread.start()

    def done():
        stop.set()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the Python thread did not stop")
    return done


def phase_sampler_alone(cfg, model) -> None:
    """The sampler without the job's host-chemistry thread, on phase 5's
    model with its head raised (``raise_head``: rollouts of ~14 rounds, as
    a trained model's), its rounds replayed from captured CUDA graphs
    against the eager loop on the same batches (``graphed_vs_eager``):
    ms a round both ways, a round's device time alone (back-to-back
    replays between CUDA events), four rounds each way beside a thread
    that runs Python, each way's busy share and kernels from torch.profiler
    (the benchmark reads the fused kernel's device time by its name),
    device memory."""
    from graphinvent_tpu_torch.sampling.generator import (
        _packed_rounds, batch_generator,
    )
    log("[5b sampler alone, B=1000, head raised: graphed rounds against the "
        "eager loop]")
    dev = torch.device("cuda")
    model = raise_head(cfg, copy.deepcopy(model), 3, 3.0, 1.0)
    out = graphed_vs_eager(cfg, model, (100, 101, 102), "GGNN")
    times = out["times"]
    ms = {w: 1e3 * t[1] / t[0] for w, t in times.items()}
    log(f"    3 batches twice each way, in turns: packed bytes, generator "
        f"state and launches equal ({out['batches']} batches a way); the "
        f"first graphed batch, with its capture, {out['first']:.4f} s")
    for w, (rounds, secs) in times.items():
        log(f"    {w:<8} {rounds} rounds in {secs:.4f} s: {ms[w]:.3f} ms a "
            f"round, {6 * B / secs:.1f} molecules/s")
    log(f"    a round graphed is {ms['eager'] / ms['graphed']:.2f}x faster")
    entry = out["ways"]["graphed"]._graphs.entries[-1]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.inference_mode():
        marks[0].record()
        for _ in range(20):
            entry.graphs[0].replay()             # the forward
            entry.graphs[1].replay()             # the rest of the round
        marks[1].record()
    torch.cuda.synchronize()
    log(f"    a round's device time, 20 replays back to back (CUDA events, "
        f"no host read between): {marks[0].elapsed_time(marks[1]) / 20:.3f}"
        " ms")
    for w, sampler in out["ways"].items():
        # capped at 4 rounds: beside such a thread an eager round has read
        # 0.09 to 1.6 s on the H100 machine's host
        stop = python_thread()
        t0 = time.time()
        packed = sampler.sample_packed(model, batch_generator(0, 150, dev),
                                       stop_round=4)
        secs = time.time() - t0
        stop()
        rounds = _packed_rounds(cfg, packed)
        log(f"    {w:<8} beside a thread running Python: {rounds} rounds "
            f"(capped at 4), {1e3 * secs / rounds:.3f} ms a round")
    torch.cuda.synchronize()
    log(f"    memory (the process so far): allocated "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, max allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f}, reserved "
        f"{torch.cuda.memory_reserved() / 2**20:.1f}, max reserved "
        f"{torch.cuda.max_memory_reserved() / 2**20:.1f}")
    for w, sampler in out["ways"].items():
        pr = profiled_batch(sampler, model, 200)
        if not pr["kernels"]:
            log(f"    {w}: device busy share not measured (no device events "
                "traced)")
            continue
        names = [e.key for e in pr["kernels"]]
        fused = [n for n in names if "fused_enn" in n]
        log(f"    {w} profiled batch: {pr['rounds']} rounds, wall "
            f"{pr['wall']:.4f} s, device busy {pr['busy']:.4f} s "
            f"({100 * pr['busy'] / pr['wall']:.1f}%), {len(names)} kernel "
            f"names, fused_enn kernels among them: {fused}")
        for e in pr["kernels"][:6]:
            log(f"      {e.self_device_time_total / 1e3:9.3f} ms  "
                f"{e.count:5d}x  {e.key[:70]}")
        check(bool(fused), f"{w}: no fused_enn kernel named in the trace")


# --------------------------------------------------------------------------
# phases 7-9: dataset, train job, test job
# --------------------------------------------------------------------------

N_MOLECULES = {"train": 4500, "valid": 300, "test": 300}
WIRE_TOL = 1e-6          # the three wire formats decode to the same bytes
# One f32 train step on the card against the CPU.  SELU's derivative jumps
# at 0 (from scale to scale * alpha), so one pre-activation that rounding
# puts on the other side of 0 on the other device changes every gradient
# upstream of it: a handful among 1e7 to 1e8 move a leaf by 1e-4 to 1e-2.
# The CPU's step is therefore taken on the card's SELU branches
# (``selu_branches``), where the two differ by rounding alone.  Bars: the
# loss, and each gradient leaf in relative L2 and in its worst entry over
# the leaf's largest.
STEP_LOSS_RTOL = 1e-3
STEP_RTOL = 2e-4
STEP_ENTRY_TOL = 2e-4
# the same step in float64 on the card against float64 on the CPU, relative
# L2 per gradient leaf
F64_DEVICE_TOL = 1e-9
VALID_LOSS_TOL = 0.05    # bf16 loss, kernel path vs plain path (logits 0.15)


SELU_SCALE = 1.0507009873554804934193349852946
SELU_ALPHA = 1.6732632423543772848170429916717


class _SeluOnBranches(torch.autograd.Function):
    """SELU whose branch is given (``positive``) and not taken from the
    sign of x: both branches are smooth, so the result follows x
    continuously through 0."""

    @staticmethod
    def forward(ctx, x, positive):
        ctx.save_for_backward(x, positive)
        return torch.where(positive, SELU_SCALE * x,
                           SELU_SCALE * SELU_ALPHA * torch.expm1(x))

    @staticmethod
    def backward(ctx, grad):
        x, positive = ctx.saved_tensors
        slope = torch.where(positive, torch.full_like(x, SELU_SCALE),
                            SELU_SCALE * SELU_ALPHA * torch.exp(x))
        return grad * slope, None


@contextlib.contextmanager
def selu_branches(record: list = None, replay: list = None,
                  flips: list = None, fit=None):
    """While active, every ``torch.nn.functional.selu`` call either appends
    its branch mask (x > 0) to ``record`` and computes as always, or takes
    the next mask of ``replay`` (made by a run of the same model on the
    same batch) as its branches, and appends to ``flips`` how many entries
    of x lie on the other side of 0.  ``fit(mask, x)``: the part of a
    replayed mask that x holds (a rank's shard; default the whole)."""
    functional = torch.nn.functional
    plain_selu = functional.selu
    masks = iter(replay) if replay is not None else None

    def selu(x, inplace=False):
        if masks is None:
            record.append((x > 0).cpu())
            return plain_selu(x)
        positive = next(masks)
        positive = (fit(positive, x) if fit else positive).to(x.device)
        flips.append(int(((x > 0) != positive).sum()))
        return _SeluOnBranches.apply(x, positive)

    functional.selu = selu
    try:
        yield
    finally:
        functional.selu = plain_selu


def grad_errors(got: dict, want: dict, what: str) -> tuple:
    """Largest per-leaf error of the gradients ``got`` against ``want``:
    (relative L2, largest entry's difference over the leaf's largest entry,
    the latter's leaf).  A leaf without gradient in ``want`` (the EMN's GRU
    starts every pass from a zero state) must have none in ``got``."""
    l2 = mx = 0.0
    leaf = ""
    for n, w in want.items():
        g = got[n]
        check(bool(torch.isfinite(g).all()), f"{what} {n}: non-finite gradient")
        if w.norm() == 0:
            check(g.norm() == 0, f"{what} {n}: a gradient where the "
                  "reference has none")
            continue
        l2 = max(l2, ((g - w).norm() / w.norm()).item())
        e = ((g - w).abs().max() / w.abs().max()).item()
        if e >= mx:
            mx, leaf = e, n
    return l2, mx, leaf


def step_gradients(cfg, model, batch, dtype=torch.float32) -> tuple:
    """(loss, gradient by leaf as float64 on the CPU) of one training
    forward and backward of a copy of ``model`` in ``dtype`` on the device
    of ``batch``."""
    from graphinvent_tpu_torch.train import step
    from graphinvent_tpu_torch.train.loss import apd_kl_loss
    device = next(iter(batch.values())).device
    m = copy.deepcopy(model).to(device=device, dtype=dtype)
    nodes, edges, apds, valid = step.batch_arrays(cfg, batch, dtype)
    loss = apd_kl_loss(m(nodes, edges, train=True), apds.to(dtype), valid)
    loss.backward()
    return loss.item(), {n: p.grad.double().cpu()
                         for n, p in m.named_parameters()}


def step_card_vs_cpu(fused_enn, tag: str, f32_cfg, model32, batch) -> None:
    """One train step of ``model32`` on ``batch`` (on the card) against the
    CPU: f32 on the card's SELU branches and float64, per gradient leaf."""
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    branches, flips = [], []
    fused_enn.reset_launch_counts()
    with selu_branches(record=branches):
        gpu_loss, gpu = step_gradients(f32_cfg, model32, batch)
    check(sum(fused_enn.LAUNCHES.values()) == 0,
          f"{tag}: a train step launched the kernel")
    with selu_branches(replay=branches, flips=flips):
        cpu_loss, cpu = step_gradients(f32_cfg, model32, cpu_batch)
    n_selu = sum(mask.numel() for mask in branches)
    del branches
    _, gpu64 = step_gradients(f32_cfg, model32, batch, torch.float64)
    _, cpu64 = step_gradients(f32_cfg, model32, cpu_batch, torch.float64)
    dl = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    l2, mx, leaf = grad_errors(gpu, cpu, tag)
    dev64 = grad_errors(gpu64, cpu64, tag)[0]
    log(f"    {tag:<8} train step at B={len(batch['nodes'])}, card vs CPU: "
        f"f32 loss {gpu_loss:.6f} vs {cpu_loss:.6f} (rel {dl:.2g}, tol "
        f"{STEP_LOSS_RTOL}); f32 gradient leaves on the card's SELU branches:"
        f" worst relative L2 {l2:.2g} (tol {STEP_RTOL}), worst entry {mx:.2g}"
        f" of its leaf's largest ({leaf}; tol {STEP_ENTRY_TOL}); "
        f"{sum(flips)} of {n_selu} SELU pre-activations lie across 0 on the "
        f"CPU; float64 gradient leaves: worst relative L2 {dev64:.2g} (tol "
        f"{F64_DEVICE_TOL})")
    check(dl <= STEP_LOSS_RTOL, f"{tag} f32 loss: card disagrees with the CPU")
    check(l2 <= STEP_RTOL and mx <= STEP_ENTRY_TOL,
          f"{tag} f32 gradients: card disagrees with the CPU ({leaf})")
    check(dev64 <= F64_DEVICE_TOL, f"{tag}: float64 gradients on the card "
          f"and the CPU differ by {dev64}")


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
    """Kernel launches of one grad-free forward.  GGNN: the message stack
    once a pass, two gather MLPs, five readout MLPs (10 at the preset).
    AttGGNN: the message and the attention stack once a pass (6).  EMN:
    the attention and the message net on the static embeddings and once a
    pass on the memories, and on the packed layout the embedding net (9
    packed, 8 dense).  MNN, S2V, AttS2V: none."""
    passes = cfg.message_passes
    if cfg.model == "GGNN":
        return passes + 7
    if cfg.model == "AttGGNN":
        return 2 * passes
    if cfg.model == "EMN":
        return 2 * passes + (3 if emn_is_packed(cfg) else 2)
    return 0


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


def load_trained(cfg, job: str, dtype: str, epoch: int = 2):
    """A train job's checkpoint of ``epoch`` (phase 8 ends at 2) on the
    card, and its config under ``compute_dtype`` ``dtype``."""
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    run_cfg = cfg.replace(batch_size=1000, compute_dtype=dtype, device="cuda")
    return run_cfg, load_checkpoint(run_cfg, checkpoint_path(job, epoch)
                                    ).to("cuda")


def resident(data: dict, name: str):
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.train.device_data import DeviceDataset
    ds = HDFDataset(store.find_dataset(os.path.join(data["dir"], name)))
    out = DeviceDataset(ds, torch.device("cuda"))
    ds.close()
    return out


def phase_train_numerics(fused_enn, cfg, job: str, data: dict) -> None:
    from graphinvent_tpu_torch.data import BlockLoader, HDFDataset, store
    from graphinvent_tpu_torch.train import device_data, step
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
    sites = [(site.name, model.msg_nns if site.wrapper == "fused_stacked_mlp"
              else site.owners[0][0], site.owners[0])
             for site in main_path_sites(model)]
    cached = lambda owner, mlps: fused_enn._cached_flat(
        owner, mlps, torch.bfloat16, dev)
    # a copy: the cache rewrites its tensors when the weights move in place
    old = {name: cached(owner, mlps).slabs.clone()
           for name, owner, mlps in sites}
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
        check(not torch.equal(now.slabs, old[name]),
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

    # one f32 train step on the card against the CPU
    idx = torch.from_numpy(perm[0, :256].astype(np.int64)).to(dev)
    step_card_vs_cpu(fused_enn, "GGNN", f32_cfg, model32,
                     device_data._gather_batch(dtrain, idx))


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


def profiled_busy(fn) -> tuple:
    """(wall s, device busy s or None) of ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = (sum(e.self_device_time_total for e in kernels) / 1e6
            if kernels else None)
    return wall, busy


def train_graphs_vs_eager(fused_enn, name: str, run_cfg, make_model,
                          dtrain, dvalid) -> dict:
    """``make_model()``'s resident epochs on ``dtrain`` graphed
    (``train/step_graphs.py``) and eager: two epochs of 8 steps each way
    held byte for byte (per-step losses, means, weights, moments, Adam's
    step, the dropout generator's state), 0 launches, then the validation
    loss on the kernel path; a whole epoch timed on the host clock (it
    ends in its one read), with the memory over it; 5 steps under the
    profiler.  -> the readings."""
    import gc
    from graphinvent_tpu_torch.sampling.generator import (
        STREAM_DROPOUT, seeded_generator,
    )
    from graphinvent_tpu_torch.train import device_data
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    dev = dtrain.device
    steps = n_batches(dtrain.n_rows)
    vperm = device_data.epoch_permutation(dvalid.n_rows, B,
                                          np.random.default_rng(0))
    out, state = {}, {}
    for way in ("graphed", "eager"):
        model = make_model()
        adam = Adam(model)
        schedule = onecycle_for_config(run_cfg.replace(epochs=2), steps)
        fn = device_data.make_epoch_train_fn(run_cfg, schedule, dtrain,
                                             model, adam,
                                             _eager=way == "eager")
        valid = device_data.make_epoch_eval_fn(run_cfg, dvalid, model)
        valid(vperm)                          # fills the weight caches
        rng = np.random.default_rng(3)

        def epoch(e, n, losses=None):
            perm = device_data.epoch_permutation(dtrain.n_rows, B, rng)[:n]
            gen = seeded_generator([run_cfg.seed, e], dev, STREAM_DROPOUT)
            return fn(perm, gen, losses), gen

        fused_enn.reset_launch_counts()
        runs = []
        for e in range(2):
            losses = []
            mean, gen = epoch(e, 8, losses)
            runs.append((mean, torch.stack(losses).cpu(), gen.get_state()))
        launches = sum(fused_enn.LAUNCHES.values())
        valid_loss = valid(vperm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        epoch(2, steps)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())
        prof_wall, busy = profiled_busy(lambda: epoch(3, 5))
        state[way] = (adam.step, runs, [t.clone() for t in itertools.chain(
            model.parameters(), adam.mu, adam.nu)])
        out[way] = dict(
            launches=launches, valid=valid_loss, ms=1e3 * wall / steps,
            base=base, peak=peak,
            busy=None if busy is None else busy / prof_wall,
            graphs=None if fn.graphs is None else (fn.graphs.captures,
                                                   fn.graphs.replays))
        del model, adam, fn, valid
    (gs, gr, gw), (es, er, ew) = state["graphed"], state["eager"]
    check(gs == es == 8 + 8 + steps + 5,
          f"{name}: Adam's step {gs} / {es}")
    for (gm, gl, gg), (em, el, eg) in zip(gr, er):
        check(gm == em and torch.equal(gl, el) and torch.equal(gg, eg),
              f"{name}: a graphed epoch's losses or generator state differ "
              f"from the eager one's ({gm} / {em})")
    check(all(torch.equal(a, b) for a, b in zip(gw, ew)),
          f"{name}: the weights or moments of the graphed epochs differ")
    del state, gw, ew
    g, e = out["graphed"], out["eager"]
    check(g["launches"] == e["launches"] == 0,
          f"{name}: train epochs launched the kernel: {g['launches']} / "
          f"{e['launches']}")
    check(g["valid"] == e["valid"],
          f"{name}: validation loss after the graphed epochs "
          f"{g['valid']} != {e['valid']} after the eager ones")
    replays = 8 + 8 + steps + 5 - 1
    check(g["graphs"] == (1, replays) and e["graphs"] is None,
          f"{name}: {g['graphs']} captures and replays")
    mib = 2.0 ** 20

    def busy(x):
        return "not measured" if x["busy"] is None else f"{x['busy']:.3f}"
    log(f"    {name}: 2 epochs of 8 steps graphed against eager: per-step "
        "losses, means, weights, moments, Adam's step and the generator's "
        f"state byte-equal, 0 launches; then the validation loss on the "
        f"kernel path {g['valid']:.6f} both ways; 1 capture, {replays} "
        f"replays; a step over an epoch of {steps} (host clock) graphed "
        f"{g['ms']:.3f} ms / eager {e['ms']:.3f} ms "
        f"({e['ms'] / g['ms']:.2f}x); device busy over 5 profiled steps "
        f"{busy(g)} / {busy(e)}; max_memory_allocated over the epoch "
        f"{g['peak'][0] / mib:.1f} / {e['peak'][0] / mib:.1f} MiB "
        f"(allocated before it {g['base'][0] / mib:.1f} / "
        f"{e['base'][0] / mib:.1f}), max reserved "
        f"{g['peak'][1] / mib:.1f} / {e['peak'][1] / mib:.1f} MiB")
    gc.collect()
    torch.cuda.empty_cache()     # the graph's pool and the eager blocks
    return out


def phase_train_graphs(fused_enn, cfg, job: str, data: dict) -> None:
    log("[8d the resident epoch's steps replayed from a captured CUDA graph "
        "against the eager loop, bf16, B=1000]")
    dtrain, dvalid = resident(data, "train"), resident(data, "valid")
    run_cfg = load_trained(cfg, job, "bfloat16")[0]
    train_graphs_vs_eager(fused_enn, "GGNN", run_cfg,
                          lambda: load_trained(cfg, job, "bfloat16")[1],
                          dtrain, dvalid)


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


def phase_timings(fused_enn, groups,
                  header: str = "[6 timings, bf16, CUDA events, warm L2]"
                  ) -> list:
    """``groups``: per model (tag, its sites, bf16 errors by site, launch
    counts by job and weight layout) -> the timed sites, for
    :func:`kernel_rows` once every job has run."""
    log(header)
    dt = torch.bfloat16
    timed = []
    for tag, sites, errs, by_job in groups:
        forward_ms = 0.0
        for i, site in enumerate(sites):
            mlps = site.owners[0]
            x = rand_rows(site.rows, site.width, i, dt)
            flat = fused_enn.flatten_weights(fused_enn.stacked_layers(mlps),
                                             dt, x.device)
            layers = unfused_layers(mlps, dt)
            plan = fused_enn.launch_plan(site.rows, flat.E, flat.dims)
            other = [p for p in fused_enn.plan_choices(flat.dims)
                     if p != plan][0]
            with torch.inference_mode():
                ms = cuda_ms(lambda: fused_enn.fused_enn_cuda(flat, x))
                other_ms = cuda_ms(
                    lambda: fused_enn.fused_enn_cuda(flat, x, other))
                plain_ms = cuda_ms(
                    lambda: fused_enn.fused_stacked_mlp_reference(flat, x))
                library_ms = cuda_ms(lambda: unfused_forward(layers, x))
            bound_ms, bound_by = bound(flat, site.rows, dt)
            log(f"    {site.name:<32} R={site.rows:<6} kernel {ms:.4f} ms "
                f"(tile {plan.tile_rows}, cluster {plan.cluster}; "
                f"{other_ms:.4f} ms at tile {other.tile_rows}, cluster "
                f"{other.cluster})  plain {plain_ms:.4f} ms  unfused "
                f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
            row = {
                "name": f"{site.wrapper}[{site.name}]", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES,
                "max_abs_err": errs[site.name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "rows": site.rows,
                "plan": {"tile_rows": plan.tile_rows,
                         "cluster": plan.cluster},
                "bound_share": bound_ms / ms, "vs_library": ms / library_ms}
            timed.append((tag, site.name, flat.layout, by_job, row))
            forward_ms += ms * site.per_forward
        log(f"    {tag}: sum of one forward's "
            f"{sum(s.per_forward for s in sites)} launches: "
            f"{forward_ms:.4f} ms")
    return timed


def kernel_rows(timed) -> list:
    """The rows of the kernels line: each timed site with its launches in
    every job of its model."""
    rows = []
    for tag, name, layout, by_job, row in timed:
        for job, counts in by_job.items():
            check(counts.get(layout, 0) > 0, f"{name}: the kernel never ran "
                  f"there in the {tag} {job} job")
        rows.append(dict(row, launches=sum(c[layout]
                                           for c in by_job.values()),
                         launches_by_job={job: counts[layout] for job, counts
                                          in by_job.items()}))
    return rows


# --------------------------------------------------------------------------
# phases 10-12: MNN, S2V, AttS2V, AttGGNN, EMN
# --------------------------------------------------------------------------

def build_models(preset) -> dict:
    """tag -> (cfg, seeded model on the card) for the five models at their
    presets, and the EMN once more on the dense edge layout."""
    from graphinvent_tpu_torch.models import build_model
    out = {}
    for k, name in enumerate(OTHER_MODELS):
        cfg = preset(name, device="cuda", seed=0)
        model = build_model(cfg, torch.Generator().manual_seed(10 + k))
        out[name] = (cfg, model.to("cuda").eval())
    cfg, model = out["EMN"]
    dense_cfg = cfg.replace(emn_packed=False)
    dense = build_model(dense_cfg, torch.Generator().manual_seed(14))
    out["EMN dense"] = (dense_cfg, dense.to("cuda").eval())
    return out


def phase_model_kernels(fused_enn, models) -> dict:
    log("[10 kernel vs plain at the AttGGNN and EMN launch shapes]")
    errs = {}
    for tag, (cfg, model) in models.items():
        sites = main_path_sites(model)
        check(sum(s.per_forward for s in sites) == per_forward(cfg),
              f"{tag}: sites do not add up to per_forward")
        # the EMN's memories start at zero: its first pass feeds all-zero
        # rows, where the kernel must give SELU of the biases
        errs[tag] = sites_check(fused_enn, sites,
                                zero_rows=cfg.model == "EMN")
    return errs


def phase_model_forwards(fused_enn, models) -> None:
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    log("[10b forward of each model, B=1000]")
    for tag, (cfg, model) in models.items():
        nodes_np, edges_np = synthetic_graphs(cfg, B, seed=4)
        plain_cfg = cfg.replace(fused_inference_enn=False)
        want = per_forward(cfg)
        for dt in (torch.bfloat16, torch.float32):
            nodes = torch.from_numpy(nodes_np).to("cuda", dt)
            edges = torch.from_numpy(edges_np).to("cuda", dt)
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                fused_enn.reset_launch_counts()
                fused = model(nodes, edges).float()
                torch.cuda.synchronize()
                launches = sum(fused_enn.LAUNCHES.values())
                plain = with_cfg(model, plain_cfg,
                                 lambda: model(nodes, edges).float())
                torch.cuda.synchronize()
            check(launches == want, f"{tag} {dt}: {launches} kernel launches "
                  f"in one forward, expected {want}")
            check(sum(fused_enn.LAUNCHES.values()) == want,
                  f"{tag}: the plain path launched the kernel")
            check(fused.shape == (B, cfg.dim_apd), f"{tag}: {fused.shape}")
            check(bool(torch.isfinite(fused).all()), f"{tag}: non-finite "
                  "logits")
            err = (fused - plain).abs().max().item()
            line = (f"    {tag:<10} {str(dt)[6:]:<8} {launches} launches, "
                    f"logits max|kernel path - plain path| {err:.4g} (tol "
                    f"{LOGIT_TOL[dt]})")
            check(err <= LOGIT_TOL[dt], f"{tag} {dt}: logits differ by {err}")
            if want == 0:
                check(err == 0.0, f"{tag}: two runs of one path differ")
            if tag in ("AttS2V", "AttGGNN", "EMN"):
                # the same weights on the dense (B, N, N, .) edge layout
                dense_cfg = cfg.replace(emn_packed=False)
                with torch.inference_mode():
                    fused_enn.reset_launch_counts()
                    dense = with_cfg(model, dense_cfg,
                                     lambda: model(nodes, edges).float())
                    torch.cuda.synchronize()
                n_dense = sum(fused_enn.LAUNCHES.values())
                check(n_dense == per_forward(dense_cfg), f"{tag} dense {dt}: "
                      f"{n_dense} kernel launches in one forward")
                d = (fused - dense).abs().max().item()
                line += f"; packed vs dense ({n_dense} launches) {d:.4g}"
                check(d <= LOGIT_TOL[dt], f"{tag} {dt}: packed and dense "
                      f"logits differ by {d}")
            if dt == torch.bfloat16:
                with torch.inference_mode():
                    fused_ms = cuda_ms(lambda: model(nodes, edges), iters=10)
                    plain_ms = with_cfg(model, plain_cfg, lambda: cuda_ms(
                        lambda: model(nodes, edges), iters=10))
                line += (f"; forward {fused_ms:.3f} ms kernel path, "
                         f"{plain_ms:.3f} ms plain path; peak "
                         f"{torch.cuda.max_memory_allocated() / 2**20:.0f} "
                         "MiB")
            log(line)


def initial_valid_loss(cfg, data: dict) -> float:
    """The validation loss of the model a fresh train job starts from."""
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.train import device_data
    dvalid = resident(data, "valid")
    model = build_model(cfg, torch.Generator().manual_seed(cfg.seed)
                        ).to("cuda")
    perm = device_data.epoch_permutation(dvalid.n_rows, B,
                                         np.random.default_rng(0))
    return device_data.make_epoch_eval_fn(cfg, dvalid, model)(perm)


def phase_model_jobs(fused_enn, models, root: str, data: dict):
    """-> (launch counts by tag and job, train job dir by model)."""
    from graphinvent_tpu_torch.utils.weights import load_optimizer_state
    log("[11 jobs of the five models: bf16, batch_size=1000]")
    by_job, jobs = {}, {}
    for name in OTHER_MODELS:
        cfg = models[name][0]
        job = os.path.join(root, "job_" + name)
        jobs[name] = job
        train_cfg = cfg.replace(
            job_type="train", dataset_dir=data["dir"] + "/", batch_size=1000,
            block_size=10000, epochs=1, sample_every=1, n_samples=1000,
            tensorboard_dir="", device="cuda", compute_dtype="bfloat16")
        before = initial_valid_loss(train_cfg, data)
        torch.cuda.reset_peak_memory_stats()
        fused_enn.reset_launch_counts()
        workflow, wall = run_job(train_cfg, job)
        rounds = sum(r for r, _ in workflow.batch_stats)
        # the validation epoch, one NLL batch of valid rows and one of train
        # rows, and the sampled batch's rounds
        forwards = n_batches(data["rows"]["valid"]) + 2 + rounds
        counts = {"train": check_launches(fused_enn, cfg, f"{name} train job",
                                          forwards)}
        peak = torch.cuda.max_memory_allocated() / 2**20
        check(workflow.data_path == "resident",
              f"{name}: the train job took the {workflow.data_path} path")
        conv = read_convergence(job)
        check(len(conv) == 1 and int(conv[0][0]) == 1
              and all(math.isfinite(x) for x in conv[0]),
              f"{name} convergence.log: {conv}")
        check(conv[0][3] < before, f"{name}: validation loss {conv[0][3]} "
              f"after the epoch, {before} before it")
        scores = read_validation(job)
        check("Epoch 1" in scores and all(math.isfinite(x)
                                          for x in scores["Epoch 1"]),
              f"{name} validation.log: {scores}")
        state = load_optimizer_state(job, 1)
        steps = n_batches(data["rows"]["train"])
        check(state is not None and state["step"] == steps,
              f"{name}: optimizer sidecar {state and state['step']}")
        for path in ("model_restart_1.pth", "generation/epoch_1.smi"):
            check(os.path.exists(os.path.join(job, path)),
                  f"{name}: {path} not written")
        log(f"    {name:<8} train job {wall:.2f} s ({steps} steps): valid "
            f"loss {before:.4f} -> {conv[0][3]:.4f} (epoch's train loss "
            f"{conv[0][2]:.4f}), UC-JSD {scores['Epoch 1'][3]:.4f}, {rounds} "
            f"sampler rounds, {sum(counts['train'].values())} kernel "
            f"launches, peak device memory {peak:.0f} MiB")
        if not per_forward(cfg):
            continue

        gen_cfg = train_cfg.replace(job_type="generate", generation_epoch=1)
        layouts = [("generate", gen_cfg)]
        if name == "EMN":
            layouts.append(("generate", gen_cfg.replace(emn_packed=False)))
        for job_name, job_cfg in layouts:
            tag = name if job_cfg.emn_packed else name + " dense"
            fused_enn.reset_launch_counts()
            workflow, wall = run_job(job_cfg, job)
            rounds = sum(r for r, _ in workflow.batch_stats)
            got = check_launches(fused_enn, job_cfg, f"{tag} generate job",
                                 rounds)
            check(rounds > 0, f"{tag}: the generate job sampled nothing")
            base = os.path.join(job, "generation", "epoch_1_gen0")
            smiles = open(base + ".smi").read().splitlines()[1:]
            ll = np.loadtxt(base + ".likelihood")
            check(len(smiles) == len(ll) == 1000
                  and bool(np.isfinite(ll).all()),
                  f"{tag}: generate job wrote {len(smiles)} SMILES")
            log(f"    {tag:<8} generate job {wall:.2f} s: {rounds} rounds, "
                f"{sum(got.values())} kernel launches, "
                f"{sum(s != '[Xx]' for s in smiles)} valid of 1000")
            if tag == name:
                counts["generate"] = got
            else:
                by_job[tag] = {"generate": got}

        fused_enn.reset_launch_counts()
        workflow, wall = run_job(train_cfg.replace(job_type="test"), job)
        rounds = sum(r for r, _ in workflow.batch_stats)
        counts["test"] = check_launches(fused_enn, cfg, f"{name} test job",
                                        rounds + 2)
        scores = read_validation(job)
        check("Test 1" in scores and all(math.isfinite(x)
                                         for x in scores["Test 1"]),
              f"{name} validation.log: {scores}")
        log(f"    {name:<8} test job {wall:.2f} s: {rounds} rounds + 2 NLL "
            f"batches, {sum(counts['test'].values())} kernel launches, "
            f"UC-JSD {scores['Test 1'][3]:.4f}")
        by_job[name] = counts
    return by_job, jobs


def phase_model_numerics(fused_enn, models, jobs: dict, data: dict) -> None:
    from graphinvent_tpu_torch.models import mpnn
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    from graphinvent_tpu_torch.train import device_data
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    log("[12 numerics of the five models on the card]")
    dev = torch.device("cuda")
    dtrain = resident(data, "train")
    perm = device_data.epoch_permutation(dtrain.n_rows, B,
                                         np.random.default_rng(0))
    idx = torch.from_numpy(perm[0, :256].astype(np.int64)).to(dev)
    batch = device_data._gather_batch(dtrain, idx)
    for name in OTHER_MODELS:
        f32_cfg, model32 = load_trained(models[name][0], jobs[name],
                                        "float32", epoch=1)
        step_card_vs_cpu(fused_enn, name, f32_cfg, model32, batch)
        bf_cfg, model = load_trained(models[name][0], jobs[name],
                                     "bfloat16", epoch=1)
        model.eval()
        sampler = GraphSampler(bf_cfg, B, device=dev)
        first = sampler.sample_packed(model, batch_generator(0, 7, dev))
        again = sampler.sample_packed(model, batch_generator(0, 7, dev))
        other = sampler.sample_packed(model, batch_generator(0, 8, dev))
        check(first.tobytes() == again.tobytes(),
              f"{name}: a seeded sampler batch is not reproducible")
        check(first.tobytes() != other.tobytes(),
              f"{name}: two seeds sampled the same batch")
        out = graphed_vs_eager(bf_cfg, model, (7, 8), name)
        ms = {w: 1e3 * t[1] / t[0] for w, t in out["times"].items()}
        log(f"      {name}: seeded sampler batch twice: byte-equal "
            f"({first.nbytes} bytes); graphed against eager on 2 batches "
            f"twice each way: bytes, generator state and launches equal, "
            f"{out['times']['graphed'][0] // 2} rounds, ms a round graphed "
            f"{ms['graphed']:.3f} / eager {ms['eager']:.3f}")

    # on the packed edge list a selection is a gather: the same values as
    # the product with the one-hot incidence matrix
    cfg = models["EMN"][0]
    dt = torch.bfloat16
    cap, D = mpnn._emn_edge_capacity(cfg), cfg.edge_emb_size
    _, edges_np = synthetic_graphs(cfg, B, seed=4)
    pk = mpnn._pack_edges(torch.from_numpy(edges_np).to(dev, dt), cap)
    per_node = rand_rows(B * N, D, 6, dt).reshape(B, N, D)
    with torch.inference_mode():
        taken = mpnn._take_rows(per_node, pk.src) * pk.valid[..., None]
        by_product = torch.bmm(pk.src_oh.float(), per_node.float()).to(dt)
    check(torch.equal(taken, by_product),
          "gather and one-hot product select other values")
    log(f"    selection (B,{cap},{D}) from (B,{N},{D}): the gather equals the "
        "one-hot batched product")


def phase_model_timings(fused_enn, models, jobs: dict, data: dict) -> None:
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    log("[12b timings of the five models, bf16, B=1000; their train epochs "
        "graphed against eager as in 8d]")
    dev = torch.device("cuda")
    dtrain, dvalid = resident(data, "train"), resident(data, "valid")
    for name in OTHER_MODELS:
        def trained():
            return load_trained(models[name][0], jobs[name], "bfloat16",
                                epoch=1)
        run_cfg, model = trained()
        model.eval()
        sampler = GraphSampler(run_cfg, B, device=dev)
        sampler.sample_packed(model, batch_generator(0, 99, dev))
        rounds = secs = 0
        for k in range(2):
            res = sampler.sample(model, batch_generator(0, 100 + k, dev),
                                 quiet=True)
            rounds += res.n_rounds
            secs += res.elapsed_s
        log(f"    {name:<8} sampler {1e3 * secs / rounds:.3f} ms a round "
            f"({rounds} rounds, {2 * B / secs:.0f} molecules/s)")
        del model, sampler
        train_graphs_vs_eager(fused_enn, name, run_cfg,
                              lambda: trained()[1], dtrain, dvalid)


# --------------------------------------------------------------------------
# phase 13: the fine-tune job and the two-phase sampler
# --------------------------------------------------------------------------

# Forward-only replay, kernel path against plain path, the largest
# per-trajectory |log-likelihood difference|.  bf16: twice the largest
# |bf16 plain - f32 plain| that probe_rl_numerics.py read on the CPU at
# preset widths (0.6327, PERF.md), fixed before the first run on the card.
REPLAY_TOL = {torch.float32: 1e-3, torch.bfloat16: 1.27}
SAMPLER_LL_TOL = 1e-4    # f32: the sampler's summed ll against the replay
RL_ROWS = 64             # rollout rows of the gradient check
FT_SCORE = dict(score_components=("QED", "target_size=9"),
                score_thresholds=(0.0, 0.0), score_type="continuous",
                sigma=20.0, alpha=0.5, qsar_models={})
# The fine-tune jobs' pretrained models.  Phase 8's two epochs leave a GGNN
# whose rollouts end after one invalid action (median 1, 0.1% valid), so
# the fine-tune path would score nothing and the BASF gate would pass no
# row.  Raising its APD head's logits of "add an atom to node 0" and of
# "terminate" by FT_HEAD_BIAS (as the CPU tests' bias_head) makes rollouts
# that build molecules (median 4 actions, about a quarter valid); the
# AttGGNN's and the EMN's phase 11 checkpoints get the same raise.
FT_HEAD_BIAS = (1, 4.0, 2.0)     # (nodes, add, terminate)
TWO_PHASE_ROUNDS = 5             # about the median action count of that GGNN


def raise_head(cfg, model, nodes: int, add: float, term: float):
    """Raises the APD head's logits of "add an atom to node 0 .. nodes-1" by
    ``add`` and of "terminate" by ``term``; -> ``model``."""
    head = model.APDReadout
    with torch.no_grad():
        head.fAddNet2.linears[-1].bias[:nodes * cfg.len_f_add_per_node] += add
        head.fTermNet2.linears[-1].bias[:] += term
    return model


def rollout_stats(cfg, model) -> dict:
    """One seeded bf16 batch of B rollouts: actions a row, the fractions
    that terminate, are valid molecules and are unique valid ones, and the
    fine-tune score's mean and share above 0."""
    from graphinvent_tpu_torch.eval.scoring import ScoringFunction
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    dev = torch.device("cuda")
    res = GraphSampler(cfg, B, device=dev).sample(
        model, batch_generator(0, 0, dev), quiet=True)
    term = res.properly_terminated != 0
    valid = np.array([bool(t) and g.is_valid()
                      for g, t in zip(res.graphs, term)])
    seen, unique = set(), np.zeros(B, bool)
    for i in np.nonzero(valid)[0]:
        smiles = res.graphs[i].get_smiles()
        unique[i] = smiles not in seen
        seen.add(smiles)
    scores = ScoringFunction(cfg.replace(**FT_SCORE)).compute_score(
        res.graphs, res.properly_terminated, valid.astype(np.int8),
        unique.astype(np.int8))
    return dict(median=float(np.median(res.t_counts)),
                max=int(res.t_counts.max()), term=float(term.mean()),
                valid=float(valid.mean()), unique=float(unique.mean()),
                score=float(np.mean(scores)),
                scored=float(np.mean(scores > 0)))


def fmt_stats(st: dict) -> str:
    return (f"actions a row median {st['median']:g} max {st['max']}; "
            f"terminated {st['term']:.3f}, valid {st['valid']:.3f}, unique "
            f"valid {st['unique']:.3f}; score mean {st['score']:.4f}, above 0 "
            f"{st['scored']:.3f}")


def phase_pretrained(cfg, models, root: str, job: str, jobs: dict) -> dict:
    """-> model name -> (directory, epoch) of the fine-tune job's pretrained
    checkpoint: phase 8's or phase 11's, its head raised by FT_HEAD_BIAS."""
    from graphinvent_tpu_torch.utils.weights import save_checkpoint
    log(f"[13 the fine-tune jobs' pretrained models: phase 8's and 11's "
        f"checkpoints, heads raised by {FT_HEAD_BIAS}]")
    out = {}
    for name, src, epoch in (("GGNN", job, 2), ("AttGGNN", jobs["AttGGNN"], 1),
                             ("EMN", jobs["EMN"], 1)):
        base = cfg if name == "GGNN" else models[name][0]
        run_cfg, model = load_trained(base, src, "bfloat16", epoch)
        before = rollout_stats(run_cfg, model.eval())
        raise_head(run_cfg, model, *FT_HEAD_BIAS)
        ft_dir = os.path.join(root, "pretrained_" + name)
        os.makedirs(ft_dir)
        save_checkpoint(model, ft_dir, epoch)
        out[name] = (ft_dir, epoch)
        st = rollout_stats(run_cfg, model)
        log(f"    {name:<8} epoch {epoch}: {fmt_stats(before)}\n"
            f"      head raised: {fmt_stats(st)}")
        if name == "GGNN":
            check(st["median"] >= 3 and st["valid"] >= 0.1
                  and st["scored"] > 0,
                  f"the fine-tune GGNN's rollouts build no molecules: {st}")
    return out


def fine_tune_cfg(cfg, data: dict, pretrained: str, **kw):
    return cfg.replace(job_type="fine-tune", dataset_dir=data["dir"] + "/",
                       pretrained_model_dir=pretrained + "/", batch_size=B,
                       tensorboard_dir="", device="cuda",
                       compute_dtype="bfloat16", **FT_SCORE, **kw)


def run_fine_tune(fused_enn, tag: str, ft_cfg, job: str):
    """The fine-tune job through ``main``, checked: launches (10 a GGNN
    forward at every sampler round and forward-only replay step, none in
    the gradient replays), losses, logs, checkpoints -> (workflow, launch
    counts by weight layout)."""
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint, load_optimizer_state,
        reference_state_dict,
    )
    torch.cuda.reset_peak_memory_stats()
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(ft_cfg, job)
    tuner = workflow.fine_tuner
    rounds = [r for r, _ in workflow.batch_stats]
    launches = check_launches(fused_enn, ft_cfg, f"{tag} fine-tune job",
                              sum(rounds) + sum(tuner.replay_steps))
    peak = torch.cuda.max_memory_allocated() / 2**20
    start = tuner.start_step
    steps = list(range(start, start + ft_cfg.epochs))
    evals = [s for s in steps if s % ft_cfg.sample_every == 0]
    check(len(tuner.replay_steps) == 2 * len(steps)
          and len(rounds) == 1 + 2 * len(steps) + len(evals),
          f"{tag}: {len(rounds)} rollouts, {len(tuner.replay_steps)} replays")
    conv = read_convergence(job)
    check([int(c[0]) for c in conv] == steps
          and all(math.isfinite(x) for c in conv for x in c),
          f"{tag} convergence.log: {conv}")
    with open(os.path.join(job, "fine-tuning.log")) as fh:
        lines = fh.read().splitlines()
    check(lines[0] == "Step, Score" and [l.split(",")[0] for l in lines[1:]]
          == [f"Step {s}" for s in [start - 1] + evals]
          and all(math.isfinite(float(l.split(",")[1])) for l in lines[1:]),
          f"{tag} fine-tuning.log: {lines}")
    last = evals[-1]
    state = load_optimizer_state(job, last)
    check(state is not None and state["step"] == last - start + 1,
          f"{tag}: optimizer sidecar of step {last}")
    saved = load_checkpoint(ft_cfg, checkpoint_path(job, last))
    if last == steps[-1]:
        now = reference_state_dict(tuner.agent)
        check(all(torch.equal(v, now[k])
                  for k, v in saved.state_dict().items()),
              f"{tag}: the last checkpoint is not the agent")
    log(f"    {tag:<8} job {wall:.2f} s: steps {steps}, losses "
        f"{[round(c[2], 4) for c in conv]}, avg scores "
        f"{[round(c[4], 4) for c in conv]}, evaluation scores "
        f"{[l.split(', ')[1] for l in lines[1:]]}; {len(rounds)} rollouts, "
        f"{sum(rounds)} rounds; replays of {tuner.replay_steps} steps; "
        f"{sum(launches.values())} kernel launches "
        f"({per_forward(ft_cfg)} a forward); BASF rows past the gate "
        f"{tuner.basf_gated}; peak device memory {peak:.0f} MiB")
    for s, times, wait in zip(steps, tuner.step_timings,
                              tuner.scoring_waits):
        log(f"      step {s}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items())
            + f" s; sum {sum(times.values()):.3f} s; scoring_wait "
            f"{wait:.3f} s")
    return workflow, launches


def sequential_step(tuner, step: int) -> float:
    """Fine-tune step ``step`` composed from the fine-tuner's rollout /
    replay / learn, one piece after another (no scoring worker)."""
    from graphinvent_tpu_torch.rl.workflow_rl import ROLE_AGENT, ROLE_BASF
    res_a = tuner.rollout(tuner.agent, step, ROLE_AGENT)
    prior_ll = tuner.replay(tuner.prior, res_a)
    res_b = tuner.rollout(tuner.basf, step, ROLE_BASF)
    return tuner.learn(step, res_a, prior_ll, res_b,
                       tuner.replay(tuner.basf, res_b))


def sequential_twin(tag: str, ft_cfg, job: str, tuner) -> None:
    """Runs the fine-tune job of ``ft_cfg`` once more in a fresh dir as
    ``learning_phase`` runs it, each step from :func:`sequential_step`;
    its fine-tuning.log, convergence.log and agent must equal the
    overlapped job's in ``job`` byte for byte."""
    from graphinvent_tpu_torch.rl.workflow_rl import (
        FineTuner, find_pretrained,
    )
    from graphinvent_tpu_torch.utils.weights import load_checkpoint
    from graphinvent_tpu_torch.workflow import Workflow
    twin = job + "_sequential"
    os.makedirs(twin)
    run_cfg = ft_cfg.replace(job_dir=twin + "/")
    path, epoch = find_pretrained(run_cfg)
    wf = Workflow(run_cfg)
    seq = FineTuner(wf, load_checkpoint(run_cfg, path).to(wf.device),
                    epoch + 1)
    seq.pre_evaluation()
    for step in range(epoch + 1, epoch + 1 + run_cfg.epochs):
        sequential_step(seq, step)
        if step % run_cfg.sample_every == 0:
            seq.evaluate(step)
    same_files(job, twin, ["fine-tuning.log", "convergence.log"],
               f"{tag}: overlapped vs sequential")
    b = seq.agent.state_dict()
    check(all(torch.equal(v, b[k]) for k, v in tuner.agent.state_dict()
              .items()), f"{tag}: the overlapped job's agent differs from "
          "the sequential composition's")
    waits = [round(w, 4) for w in tuner.scoring_waits]
    scoring = [round(t["scoring"], 4) for t in seq.step_timings]
    log(f"    {tag}: the same job with each step composed in sequence: "
        f"fine-tuning.log, convergence.log and the agent's weights "
        f"byte-equal; scoring_wait a step {waits} s overlapped, scoring "
        f"{scoring} s in sequence")


def phase_fine_tune(fused_enn, cfg, models, root: str, data: dict,
                    pretrained: dict) -> dict:
    """-> launch counts of each fine-tune job by model."""
    log("[13a fine-tune jobs: bf16, B=1000; GGNN 3 steps, AttGGNN and EMN "
        "1 step, on the pretrained models]")
    out = {}
    ggnn_cfg = fine_tune_cfg(cfg, data, pretrained["GGNN"][0], epochs=3,
                             sample_every=3)
    ggnn_job = os.path.join(root, "fine_tune_GGNN")
    workflow, out["GGNN"] = run_fine_tune(fused_enn, "GGNN", ggnn_cfg,
                                          ggnn_job)
    check(sum(workflow.fine_tuner.basf_gated) > 0,
          "GGNN: no BASF row passed the gate in any step")
    sequential_twin("GGNN", ggnn_cfg, ggnn_job, workflow.fine_tuner)
    for name in ("AttGGNN", "EMN"):
        _, out[name] = run_fine_tune(
            fused_enn, name, fine_tune_cfg(models[name][0], data,
                                           pretrained[name][0], epochs=1,
                                           sample_every=1),
            os.path.join(root, "fine_tune_" + name))
    return out


def rl_gradients(cfg, model, batches, device, dtype) -> tuple:
    """(loss, gradient by leaf as float64 on the CPU) of one ``rl_loss``
    and its backward, on a copy of ``model`` in ``dtype`` on ``device``.
    ``batches``: two (actions, t_counts, target, mask) of numpy arrays."""
    from graphinvent_tpu_torch.rl.workflow_rl import rl_loss
    m = copy.deepcopy(model).to(device=device, dtype=dtype)

    def put(batch):
        a, t, target, mask = (torch.from_numpy(x).to(device) for x in batch)
        return a, t, target.to(dtype), mask.to(dtype)

    apply_fn = None
    if dtype == torch.float64:      # the states are 0/1: exact in any type
        apply_fn = lambda mm, nodes, edges: mm(nodes.to(dtype),
                                               edges.to(dtype))
    loss = rl_loss(cfg, m, *map(put, batches), cfg.alpha, apply_fn)
    loss.backward()
    return loss.item(), {n: p.grad.double().cpu()
                         for n, p in m.named_parameters()}


def phase_fine_tune_numerics(fused_enn, cfg, root: str, data: dict,
                             pretrained: tuple) -> dict:
    """-> the fine-tuner of the step checks, for the timings."""
    from graphinvent_tpu_torch.rl.workflow_rl import (
        ROLE_AGENT, ROLE_BASF, FineTuner, rl_generator,
    )
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    from graphinvent_tpu_torch.workflow import Workflow
    log("[13b fine-tune numerics on the card]")
    dev = torch.device("cuda")
    job, epoch = pretrained
    bf_cfg, model = load_trained(cfg, job, "bfloat16", epoch)
    model.eval()
    res = GraphSampler(bf_cfg, B, device=dev).sample(
        model, rl_generator(0, 1, ROLE_AGENT, dev), quiet=True)
    a = torch.from_numpy(res.actions).to(dev)
    t = torch.from_numpy(res.t_counts).to(dev)
    steps = int(min(res.t_counts.max(), res.actions.shape[1]))
    for run_cfg in (bf_cfg.replace(compute_dtype="float32"), bf_cfg):
        dt = torch.bfloat16 if run_cfg.compute_dtype == "bfloat16" \
            else torch.float32
        with torch.inference_mode():
            fused_enn.reset_launch_counts()
            kernel = with_cfg(model, run_cfg, lambda: trajectory_loglik(
                run_cfg, model, a, t))
            torch.cuda.synchronize()
            launched = sum(fused_enn.LAUNCHES.values())
            plain_cfg = run_cfg.replace(fused_inference_enn=False)
            plain = with_cfg(model, plain_cfg, lambda: trajectory_loglik(
                plain_cfg, model, a, t))
            torch.cuda.synchronize()
        check(launched == per_forward(run_cfg) * steps,
              f"{dt} replay: {launched} launches for {steps} steps")
        check(sum(fused_enn.LAUNCHES.values()) == launched,
              "the plain replay launched the kernel")
        check(bool(torch.isfinite(kernel).all()), "non-finite replay")
        d = (kernel - plain).abs()
        log(f"    forward-only replay of {B} trajectories ({steps} steps, "
            f"{launched} launches), {str(dt)[6:]}: per trajectory "
            f"|kernel path - plain path| max {d.max().item():.4g}, mean "
            f"{d.mean().item():.3g} (tol {REPLAY_TOL[dt]:g}); ll mean "
            f"{plain.mean().item():.4f}")
        check(d.max().item() <= REPLAY_TOL[dt],
              f"{dt}: the replay's kernel path disagrees with the plain path")

    # the f32 sampler's recorded ll against the replay of its actions
    f32_cfg, model32 = load_trained(cfg, job, "float32", epoch)
    model32.eval()
    sampler32 = GraphSampler(f32_cfg, B, device=dev)
    res32 = sampler32.sample(model32, rl_generator(0, 1, ROLE_BASF, dev),
                             quiet=True)
    with torch.inference_mode():
        ll = trajectory_loglik(f32_cfg, model32,
                               torch.from_numpy(res32.actions).to(dev),
                               torch.from_numpy(res32.t_counts).to(dev))
    d = np.abs(ll.cpu().numpy() - res32.final_loglikelihoods).max()
    log(f"    f32 sampler batch: recorded ll against the kernel-path replay "
        f"of its actions, max |diff| {d:.3g} (tol {SAMPLER_LL_TOL})")
    check(d <= SAMPLER_LL_TOL, "the replay disagrees with the sampler's ll")

    # one rl_loss gradient, card against CPU
    rng = np.random.default_rng(13)
    batches = []
    for role in (ROLE_AGENT, ROLE_BASF):
        r = GraphSampler(f32_cfg, RL_ROWS, device=dev).sample(
            model32, rl_generator(0, 2, role, dev), quiet=True)
        with torch.inference_mode():
            ll = trajectory_loglik(f32_cfg, model32,
                                   torch.from_numpy(r.actions).to(dev),
                                   torch.from_numpy(r.t_counts).to(dev))
        target = (ll.cpu().numpy() - 5.0 + rng.normal(size=RL_ROWS)
                  ).astype(np.float32)
        mask = (rng.random(RL_ROWS) < 0.8).astype(np.float32)
        batches.append((r.actions, r.t_counts, target, mask))
    branches, flips = [], []
    fused_enn.reset_launch_counts()
    with selu_branches(record=branches):
        gpu_loss, gpu = rl_gradients(f32_cfg, model32, batches, dev,
                                     torch.float32)
    check(sum(fused_enn.LAUNCHES.values()) == 0,
          "the gradient replay launched the kernel")
    with selu_branches(replay=branches, flips=flips):
        cpu_loss, cpu = rl_gradients(f32_cfg, model32, batches,
                                     torch.device("cpu"), torch.float32)
    n_selu = sum(mask.numel() for mask in branches)
    del branches
    _, gpu64 = rl_gradients(f32_cfg, model32, batches, dev, torch.float64)
    _, cpu64 = rl_gradients(f32_cfg, model32, batches, torch.device("cpu"),
                            torch.float64)
    dl = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    l2, mx, leaf = grad_errors(gpu, cpu, "rl_loss")
    dev64 = grad_errors(gpu64, cpu64, "rl_loss")[0]
    log(f"    rl_loss at B={RL_ROWS} (replays of "
        f"{[int(b[1].max()) for b in batches]} steps), card vs CPU: f32 loss "
        f"{gpu_loss:.6f} vs {cpu_loss:.6f} (rel {dl:.2g}, tol "
        f"{STEP_LOSS_RTOL}); f32 gradient leaves on the card's SELU branches:"
        f" worst relative L2 {l2:.2g} (tol {STEP_RTOL}), worst entry {mx:.2g}"
        f" of its leaf's largest ({leaf}; tol {STEP_ENTRY_TOL}); {sum(flips)}"
        f" of {n_selu} SELU pre-activations lie across 0 on the CPU; "
        f"float64 gradient leaves: worst relative L2 {dev64:.2g} (tol "
        f"{F64_DEVICE_TOL}); 0 kernel launches")
    check(dl <= STEP_LOSS_RTOL, "rl_loss f32: card disagrees with the CPU")
    check(l2 <= STEP_RTOL and mx <= STEP_ENTRY_TOL,
          f"rl_loss f32 gradients: card disagrees with the CPU ({leaf})")
    check(dev64 <= F64_DEVICE_TOL, f"rl_loss: float64 gradients on the card "
          f"and the CPU differ by {dev64}")

    # one learning step: the prior and the BASF stay as they were; the
    # agent's kernel path still agrees with its plain path
    ft_cfg = fine_tune_cfg(cfg, data, job, epochs=3, sample_every=100)

    def tuner_in(name: str):
        scratch = os.path.join(root, name)
        os.makedirs(scratch)
        wf = Workflow(ft_cfg.replace(job_dir=scratch + "/"))
        return FineTuner(wf, load_trained(cfg, job, "bfloat16", epoch)[1], 3)

    tuner = tuner_in("fine_tune_step")
    before = {k: {n: v.clone() for n, v in getattr(tuner, k).state_dict()
                  .items()} for k in ("prior", "basf", "agent")}
    loss = tuner.step(3)
    for k, state in before.items():
        same = all(torch.equal(v, state[n])
                   for n, v in getattr(tuner, k).state_dict().items())
        check(same == (k != "agent"), f"after a step the {k} "
              f"{'moved' if k != 'agent' else 'did not move'}")
    nodes_np, edges_np = synthetic_graphs(cfg, B, seed=4)
    nodes = torch.from_numpy(nodes_np).to(dev, torch.bfloat16)
    edges = torch.from_numpy(edges_np).to(dev, torch.bfloat16)
    agent = tuner.agent
    with torch.inference_mode():
        fused = agent(nodes, edges).float()
        plain = with_cfg(agent, ft_cfg.replace(fused_inference_enn=False),
                         lambda: agent(nodes, edges).float())
    err = (fused - plain).abs().max().item()
    check(err <= LOGIT_TOL[torch.bfloat16],
          f"the agent's logits after a step differ by {err}")
    again = tuner_in("fine_tune_again")
    again.step(3)
    same = all(torch.equal(v, agent.state_dict()[n])
               for n, v in again.agent.state_dict().items())
    log(f"    one step: prior and BASF byte-equal to before, agent moved; "
        f"agent's bf16 logits kernel path vs plain path {err:.4g} (tol "
        f"{LOGIT_TOL[torch.bfloat16]}); the step from the same seed and "
        f"checkpoint again: agent weights byte-equal {same}")
    check(same, "two runs of one step left different agent weights")
    seq = tuner_in("fine_tune_sequential")
    seq_loss = sequential_step(seq, 3)
    same = all(torch.equal(v, agent.state_dict()[n])
               for n, v in seq.agent.state_dict().items())
    log(f"    the overlapped step against the same step composed in "
        f"sequence on a fresh copy: loss {loss!r} vs {seq_loss!r}, agent "
        f"weights after Adam byte-equal {same}; scoring_wait "
        f"{tuner.scoring_waits[-1]:.4f} s, scoring in sequence "
        f"{seq.step_timings[-1]['scoring']:.4f} s")
    check(loss == seq_loss and same,
          "the overlapped step differs from the sequential composition")
    return tuner


def phase_fine_tune_timings(tuner) -> None:
    from torch.autograd import DeviceType
    from graphinvent_tpu_torch.rl.workflow_rl import (
        ROLE_AGENT, ROLE_BASF, rl_loss,
    )
    from graphinvent_tpu_torch.sampling import GraphSampler
    log("[13c fine-tune step timings, bf16, B=1000]")
    graphed = tuner.sampler
    eager = GraphSampler(tuner.cfg, tuner.cfg.batch_size, device=tuner.device,
                         _eager=True)
    for step_no, way in ((4, "graphed"), (5, "eager")):
        tuner.sampler = graphed if way == "graphed" else eager
        before = graphed._graphs.captures, graphed._graphs.refreshes
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        tuner.step(step_no)
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        times = tuner.step_timings[-1]
        captured = graphed._graphs.captures - before[0]
        refreshed = graphed._graphs.refreshes - before[1]
        log(f"    one step, rollouts {way} ({captured} captures, {refreshed} "
            "refreshes): "
            f"{wall:.3f} s wall, {start.elapsed_time(end):.1f} ms "
            "between CUDA events; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in times.items())
            + f"; scoring_wait {tuner.scoring_waits[-1]:.3f} s")
    tuner.sampler = graphed
    # the agent's rollout after an Adam step (its weights moved in place:
    # a refresh of its captured round), the same rollout replayed, and on
    # the eager loop
    secs = {}
    before = graphed._graphs.captures, graphed._graphs.refreshes
    for tag, sampler in (("with its refresh", graphed), ("replayed", graphed),
                         ("eager", eager), ("eager again", eager)):
        tuner.sampler = sampler
        torch.cuda.synchronize()
        t0 = time.time()
        res = tuner.rollout(tuner.agent, 6, ROLE_AGENT)
        secs[tag] = time.time() - t0
    tuner.sampler = graphed
    log(f"    the agent's rollout after the step ({res.n_rounds} rounds), s: "
        + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
        + f"; the refresh's cost about "
        f"{secs['with its refresh'] - secs['replayed']:.4f} s ("
        f"{graphed._graphs.captures - before[0]} captures, "
        f"{graphed._graphs.refreshes - before[1]} refreshes)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        tuner.step(5)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if kernels:
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        log(f"    profiled step: wall {wall:.3f} s, device busy {busy:.3f} s "
            f"({100 * busy / wall:.1f}%), {len(kernels)} kernel names")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"      {e.self_device_time_total / 1e3:9.3f} ms  "
                f"{e.count:5d}x  {e.key[:70]}")
    else:
        log("    device busy share: not measured (no device events traced)")

    # the gradient replay alone at rl_remat_segment 1 and 2
    res = [tuner.rollout(m, 6, role) for m, role in
           ((tuner.agent, ROLE_AGENT), (tuner.basf, ROLE_BASF))]
    dev = tuner.device

    def batch(r):
        n = len(r.t_counts)
        return (torch.from_numpy(r.actions).to(dev),
                torch.from_numpy(r.t_counts).to(dev),
                torch.full((n,), -20.0, device=dev),
                torch.ones(n, device=dev))

    for seg in (1, 2):
        run_cfg = tuner.cfg.replace(rl_remat_segment=seg)
        tuner.adam.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        loss = rl_loss(run_cfg, tuner.agent, batch(res[0]), batch(res[1]),
                       run_cfg.alpha)
        marks[1].record()
        loss.backward()
        marks[2].record()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        log(f"    gradient replay, rl_remat_segment={seg}: forward "
            f"{marks[0].elapsed_time(marks[1]):.1f} ms, backward "
            f"{marks[1].elapsed_time(marks[2]):.1f} ms (CUDA events; replays "
            f"of {[int(r.t_counts.max()) for r in res]} steps), peak device "
            f"memory above the model {peak:.0f} MiB")
    tuner.adam.zero_grad()


def phase_two_phase(fused_enn, cfg, root: str, data: dict,
                    pretrained: tuple) -> dict:
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import (
        _row_layout, batch_generator,
    )
    from graphinvent_tpu_torch.sampling.two_phase import TwoPhaseSampler
    log(f"[13d two-phase generate job: n_samples=4000, "
        f"gen_two_phase_rounds={TWO_PHASE_ROUNDS}, the fine-tune GGNN]")
    job, epoch = pretrained
    gjob = os.path.join(root, "two_phase")
    os.makedirs(gjob)
    shutil.copy(os.path.join(job, f"model_restart_{epoch}.pth"), gjob)
    gen_cfg = cfg.replace(
        job_type="generate", dataset_dir=data["dir"] + "/", n_samples=4000,
        batch_size=B, generation_epoch=epoch,
        gen_two_phase_rounds=TWO_PHASE_ROUNDS,
        tensorboard_dir="", device="cuda", compute_dtype="bfloat16")
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(gen_cfg, gjob)
    stats = workflow.two_phase_stats
    rounds = sum(s["rounds"] for s in stats)
    launches = check_launches(fused_enn, gen_cfg, "two-phase generate job",
                              rounds)
    stragglers = sum(s["n_stragglers"] for s in stats)
    check(stragglers > 0, f"two-phase stats: {stats}")
    dev = torch.device("cuda")
    run_cfg, model = load_trained(cfg, job, "bfloat16", epoch)
    model.eval()
    tp = TwoPhaseSampler(run_cfg, B, TWO_PHASE_ROUNDS, device=dev)
    single = GraphSampler(run_cfg, B, device=dev)
    off = _row_layout(run_cfg)
    r0, d0 = off["rounds"][0], off["done"][0]
    n_finished, counts = 0, []
    for k in range(4):
        gen = lambda: batch_generator(gen_cfg.seed, k, dev)
        raw = tp.sample_packed(model, gen(), stop_round=TWO_PHASE_ROUNDS)
        ref = single.sample_packed(model, gen())
        finished = raw[:, d0] == 1
        n_finished += int(finished.sum())
        check(np.array_equal(raw[finished, :r0], ref[finished, :r0]),
              f"batch {k}: rows finished in phase 1 differ from the "
              "single-phase sampler's")
        base = os.path.join(gjob, "generation", f"epoch_{epoch}_gen{k}")
        smiles = open(base + ".smi").read().splitlines()[1:]
        ll = np.loadtxt(base + ".likelihood")
        check(len(smiles) == len(ll) == B and bool(np.isfinite(ll).all()),
              f"two-phase job: {base} has {len(smiles)} SMILES")
        ref_res = single._decode_packed(ref, 0.0, True)
        counts.append(ref_res.t_counts)
        want = ref_res.final_loglikelihoods
        check(np.array_equal(ll[finished], np.array(
            [float(f"{x:.6f}") for x in want[finished]])),
            f"batch {k}: the job's likelihoods of rows finished in phase 1")
    check(n_finished > 0, "no row finished in phase 1")
    log(f"    job {wall:.2f} s: {stragglers} stragglers of {gen_cfg.n_samples} in "
        f"{sum(s['n_continuation'] for s in stats)} continuation batches, "
        f"{rounds} rounds in all, {sum(launches.values())} kernel launches; "
        f"{n_finished} rows finished in phase 1, each byte-equal to the "
        "single-phase sampler's row; actions a row in the single-phase "
        f"batches: median {np.median(np.concatenate(counts)):g}, max "
        f"{np.concatenate(counts).max()}")
    return launches


# --------------------------------------------------------------------------
# phase 14: native chemistry, and checkpoints written elsewhere
# --------------------------------------------------------------------------

def seconds(fn):
    """(wall seconds of one call of fn, its result)."""
    t0 = time.time()
    out = fn()
    return time.time() - t0, out


def fresh(cfg, graphs) -> list:
    """New MolGraphs of the same arrays: nothing cached from an earlier
    pass over them."""
    from graphinvent_tpu_torch.chem.molgraph import MolGraph
    return [MolGraph(cfg, g.node_features, g.edge_features, g.n_nodes)
            for g in graphs]


def stacked(graphs) -> tuple:
    return (np.stack([g.node_features for g in graphs]).astype(np.int8),
            np.stack([g.edge_features for g in graphs]).astype(np.int8),
            np.array([g.n_nodes for g in graphs], np.int32))


def dataset_bytes(data_dir: str) -> dict:
    from graphinvent_tpu_torch.data import store
    out = {}
    for name in N_MOLECULES:
        with store.ReadStore(store.find_dataset(
                os.path.join(data_dir, name))) as src:
            out[name] = {k: np.asarray(src.arrays[k][:]).tobytes()
                         for k in ("nodes", "edges", "APDs")}
    return out


def phase_native(fused_enn, cfg, model, root: str, data: dict,
                 pretrained: tuple, gxx_s: float) -> None:
    """The library against the Python path at the three host sites, on the
    traffic of phases 5, 7 and 13, byte for byte, with both paths' times."""
    from graphinvent_tpu_torch.chem import native
    from graphinvent_tpu_torch.chem.descriptors import qed
    from graphinvent_tpu_torch.eval.analyzer import Analyzer
    from graphinvent_tpu_torch.rl.workflow_rl import (
        ROLE_AGENT, ROLE_BASF, rl_generator,
    )
    from graphinvent_tpu_torch.sampling import GraphSampler
    from graphinvent_tpu_torch.sampling.generator import batch_generator
    log("[14a native chemistry (built in phase 2 in "
        f"{gxx_s:.2f} s) against the Python path]")
    dev = torch.device("cuda")

    # the analyzer on the 2,000 graphs of phase 5's generate job
    sampler = GraphSampler(cfg, B, device=dev)
    batches = [sampler.sample(model, batch_generator(cfg.seed, k, dev),
                              quiet=True) for k in range(2)]
    graphs = [g for res in batches for g in res.graphs]
    nat_s, (validity, smiles) = seconds(
        lambda: native.native_decode_batch(*stacked(graphs), cfg))
    py = fresh(cfg, graphs)
    py_s, (py_validity, py_smiles) = seconds(lambda: (
        np.array([g.is_valid() for g in py], np.int8),
        [g.get_smiles() for g in py]))
    check(validity.tobytes() == py_validity.tobytes(),
          "native validity differs from the Python path's")
    check(smiles == py_smiles,
          "native canonical SMILES differ from the Python path's")
    # the analyzer's whole evaluation of each batch (validity, uniqueness,
    # the property histograms) on both paths
    times, outs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analyzer_") as tmp:
        for on in (True, False):
            an = Analyzer(cfg.replace(native_chem=on, job_dir=tmp + "/",
                                      tensorboard_dir=""))
            times[on], outs[on] = 0.0, []
            for res in batches:
                secs, (v, u, props) = seconds(
                    lambda: an.evaluate_generated_graphs(
                        fresh(cfg, res.graphs), res.properly_terminated,
                        res.final_loglikelihoods, "Epoch 1", write=False))
                props.pop(("Epoch 1", "run_time"))
                times[on] += secs
                outs[on].append((v.tobytes(), u.tobytes(),
                                 repr(sorted(props.items(), key=str))))
    check(outs[True] == outs[False], "the analyzer's validity, uniqueness "
          "or properties differ between the paths")
    log(f"    phase 5's 2,000 graphs: {int(validity.sum())} valid, "
        f"{len(set(s for s in smiles if s))} distinct SMILES, byte-equal; "
        f"validity + SMILES per 1,000: native {nat_s / 2:.4f} s, Python "
        f"{py_s / 2:.4f} s; the analyzer per 1,000 (properties included): "
        f"native {times[True] / 2:.4f} s, Python {times[False] / 2:.4f} s")

    # QED of one fine-tune step's 2,000 scored molecules (phase 13's first
    # GGNN step: the agent's and the BASF's rollouts of the pretrained
    # model)
    ft_dir, epoch = pretrained
    run_cfg, ft_model = load_trained(cfg, ft_dir, "bfloat16", epoch)
    ft_sampler = GraphSampler(run_cfg, B, device=dev)
    step = epoch + 1
    scored = [g for role in (ROLE_AGENT, ROLE_BASF)
              for g in ft_sampler.sample(ft_model.eval(), rl_generator(
                  cfg.seed, step, role, dev), quiet=True).graphs]
    nat_s, got = seconds(lambda: native.native_qed_batch(*stacked(scored),
                                                         cfg))
    py = fresh(cfg, scored)
    py_s, want = seconds(lambda: np.array([qed(g.molecule) for g in py],
                                          np.float64))
    check(got.tobytes() == want.tobytes(),
          "native QED's float64 bytes differ from the Python path's")
    log(f"    QED of fine-tune step {step}'s 2,000 molecules "
        f"({int((got > 0).sum())} above 0): float64 bytes equal; native "
        f"{nat_s:.4f} s, Python {py_s:.4f} s")

    # preprocessing phase 7's SMILES on both paths
    pre = {}
    for on in (True, False):
        d = os.path.join(root, f"data_native_{on}")
        os.makedirs(d)
        for name in N_MOLECULES:
            shutil.copy(os.path.join(data["dir"], name + ".smi"), d)
        pre_cfg = cfg.replace(job_type="preprocess", dataset_dir=d + "/",
                              batch_size=1000, tensorboard_dir="",
                              native_chem=on)
        _, wall = run_job(pre_cfg, os.path.join(root, f"preprocess_{on}"))
        pre[on] = (wall, dataset_bytes(d))
    check(pre[True][1] == pre[False][1] == dataset_bytes(data["dir"]),
          "the datasets differ between native_chem True and False")
    n_mol = sum(N_MOLECULES.values())
    log(f"    phase 7's {n_mol} molecules, arrays byte-equal on both paths: "
        f"native {n_mol / pre[True][0]:.1f} molecules/s "
        f"({pre[True][0]:.2f} s), Python {n_mol / pre[False][0]:.1f} "
        f"molecules/s ({pre[False][0]:.2f} s)")

    # the sampler beside the analyzer's thread, with the Python path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_job_") as job:
        run_generate_job(fused_enn, cfg.replace(native_chem=False), model,
                         job)


def v1_pickle(sd: dict, path: str, module_name: str = "reference_gnn_v1"
              ) -> None:
    """Pickles a stand-in for a reference v1.0 checkpoint: the whole module
    with the reference's attribute names, of classes from a module that is
    gone when the file is read."""
    import types
    mod = types.ModuleType(module_name)
    classes = {name: type(name, (torch.nn.Module,),
                          {"__module__": module_name, "__qualname__": name})
               for name in ("GGNN", "MLP")}
    vars(mod).update(classes)
    sys.modules[module_name] = mod
    try:
        root = classes["GGNN"]()
        for key, t in sd.items():
            *path_, leaf = key.split(".")
            m = root
            for p in path_:
                if p not in m._modules:
                    m.add_module(p, classes["MLP"]())
                m = m._modules[p]
            m.register_parameter(leaf, torch.nn.Parameter(t.clone()))
        torch.save(root, path)
    finally:
        del sys.modules[module_name]


def restarted_train_job(fused_enn, cfg, data: dict, job: str, files: list):
    """A train job restarted for one epoch (with its evaluation) in a fresh
    dir holding ``files``; -> (workflow, per-step losses, launches).  The
    losses come from the resident epoch's ``step_losses`` (its steps are
    replays of a captured graph, which call no Python step)."""
    import graphinvent_tpu_torch.workflow as port_workflow
    os.makedirs(job)
    for f in files:
        shutil.copy(f, job)
    losses = []
    inner = port_workflow.make_epoch_train_fn

    def recording(*args, **kw):
        run = inner(*args, **kw)

        def epoch(perm, generator=None, step_losses=None):
            return run(perm, generator, losses)
        return epoch

    run_cfg = cfg.replace(
        job_type="train", dataset_dir=data["dir"] + "/", batch_size=1000,
        block_size=10000, restart=True, epochs=1, schedule_epochs=3,
        sample_every=1, n_samples=1000, tensorboard_dir="", device="cuda",
        compute_dtype="bfloat16")
    fused_enn.reset_launch_counts()
    port_workflow.make_epoch_train_fn = recording
    try:
        workflow, _ = run_job(run_cfg, job)
    finally:
        port_workflow.make_epoch_train_fn = inner
    rounds = sum(r for r, _ in workflow.batch_stats)
    launches = check_launches(fused_enn, run_cfg, f"restart in {job}",
                              n_batches(data["rows"]["valid"]) + 2 + rounds)
    return workflow, torch.stack(losses), launches


def phase_checkpoints(fused_enn, cfg, root: str, data: dict, job: str
                      ) -> dict:
    """Phase 8's checkpoint written as the JAX package's .ckpt (weights and
    Adam's state) and as a reference v1.0 whole-module pickle, read back by
    the port's jobs; -> launch counts of the jobs run from the .ckpt."""
    from graphinvent_tpu_torch.utils import weights
    from graphinvent_tpu_torch.utils.checkpoint import (
        load_jax_checkpoint, save_jax_checkpoint,
    )
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    log("[14b checkpoints written elsewhere: phase 8's as a JAX .ckpt and "
        "as a v1.0 whole-module pickle]")
    dev = torch.device("cuda")
    pth = weights.checkpoint_path(job, 2)
    side = weights.optimizer_path(job, 2)
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    state = weights.load_optimizer_state(job, 2)
    ckpt_dir = os.path.join(root, "ckpt")
    os.makedirs(ckpt_dir)
    ckpt = os.path.join(ckpt_dir, "model_restart_2.ckpt")
    params = weights.jax_params_from_state_dict(cfg, sd)
    t0 = time.time()
    save_jax_checkpoint(ckpt, params, {
        "step": state["step"],
        "mu": weights.jax_params_from_state_dict(cfg, state["mu"]),
        "nu": weights.jax_params_from_state_dict(cfg, state["nu"])}, 2)
    write_s = time.time() - t0
    t0 = time.time()
    back, opt, epoch = load_jax_checkpoint(ckpt)
    read_s = time.time() - t0
    check(epoch == 2 and opt["step"] == state["step"],
          f".ckpt read back: epoch {epoch}, step {opt['step']}")
    check(all(torch.equal(v, sd[k]) for k, v in
              weights.state_dict_from_jax_params(cfg, back).items()),
          "the .ckpt's weights differ from the .pth's")

    f32 = cfg.replace(compute_dtype="float32", device="cuda", batch_size=B)
    nodes, edges = (torch.from_numpy(a).to(dev)
                    for a in synthetic_graphs(cfg, B, seed=9))
    v1 = os.path.join(root, "model_restart_v1.pth")
    v1_pickle(sd, v1)
    logits = {}
    for tag, path in (("pth", pth), ("ckpt", ckpt), ("v1", v1)):
        net = weights.load_checkpoint(f32, path).to(dev).eval()
        with torch.inference_mode():
            logits[tag] = net(nodes, edges)
    check(bool(torch.isfinite(logits["pth"]).all()), "non-finite logits")
    check(torch.equal(logits["ckpt"], logits["pth"]),
          "f32 logits of the .ckpt model differ from the .pth model's")
    check(torch.equal(logits["v1"], logits["pth"]),
          "f32 logits of the v1.0 pickle differ from the .pth model's")
    log(f"    {os.path.getsize(ckpt) / 2**20:.2f} MiB .ckpt written in "
        f"{write_s:.3f} s, read in {read_s:.3f} s; f32 logits on a fixed "
        f"batch of {B}: .ckpt and v1.0 pickle bit-equal to the .pth's")

    out = {}
    gen_dir = os.path.join(root, "generate_ckpt")
    os.makedirs(gen_dir)
    shutil.copy(ckpt, gen_dir)
    gen_cfg = cfg.replace(job_type="generate", dataset_dir=gen_dir + "/",
                          n_samples=2000, batch_size=1000, generation_epoch=2,
                          tensorboard_dir="", device="cuda")
    fused_enn.reset_launch_counts()
    workflow, wall = run_job(gen_cfg, gen_dir)
    rounds = sum(r for r, _ in workflow.batch_stats)
    out["generate (.ckpt)"] = check_launches(
        fused_enn, gen_cfg, "generate job from the .ckpt", rounds)
    for k in range(2):
        smiles = open(os.path.join(gen_dir, "generation",
                                   f"epoch_2_gen{k}.smi")).read()
        check(len(smiles.splitlines()) == 1001, f"generate from .ckpt: "
              f"batch {k} wrote {len(smiles.splitlines())} lines")
    log(f"    generate job from the .ckpt: {wall:.2f} s, {rounds} rounds, "
        f"{sum(fused_enn.LAUNCHES.values())} kernel launches")

    w_ckpt, l_ckpt, out["train (.ckpt)"] = restarted_train_job(
        fused_enn, cfg, data, os.path.join(root, "restart_ckpt"), [ckpt])
    w_pth, l_pth, _ = restarted_train_job(
        fused_enn, cfg, data, os.path.join(root, "restart_pth"), [pth, side])
    check(len(l_ckpt) == n_batches(data["rows"]["train"])
          and torch.equal(l_ckpt, l_pth),
          f"restarted per-step losses differ: {l_ckpt} vs {l_pth}")
    check(w_ckpt.adam.step == w_pth.adam.step == state["step"] + len(l_ckpt),
          f"Adam's step after the restarts: {w_ckpt.adam.step}, "
          f"{w_pth.adam.step}")
    conv = [read_convergence(w.cfg.job_dir) for w in (w_ckpt, w_pth)]
    check(conv[0] == conv[1], f"convergence.log differs: {conv}")
    after = [weights.load_checkpoint(cfg, weights.checkpoint_path(
        w.cfg.job_dir, 3)).state_dict() for w in (w_ckpt, w_pth)]
    check(all(torch.equal(v, after[1][k]) for k, v in after[0].items()),
          "the restarted jobs' epoch-3 weights differ")
    log(f"    train job restarted from the .ckpt and from the .pth + "
        f"sidecar: {len(l_ckpt)} per-step losses equal "
        f"({l_ckpt[0].item():.4f} .. {l_ckpt[-1].item():.4f}), Adam at step "
        f"{w_ckpt.adam.step}, convergence.log and epoch-3 weights equal "
        f"(valid loss {conv[0][0][3]:.4f}, UC-JSD {conv[0][0][4]:.4f})")

    ft_pre = os.path.join(root, "pretrained_ckpt")
    os.makedirs(ft_pre)
    shutil.copy(ckpt, ft_pre)
    workflow, out["fine-tune (.ckpt)"] = run_fine_tune(
        fused_enn, "GGNN .ckpt", fine_tune_cfg(cfg, data, ft_pre, epochs=1,
                                               sample_every=1),
        os.path.join(root, "fine_tune_ckpt"))
    check(workflow.fine_tuner.start_step == 3,
          f"the fine-tune job started at {workflow.fine_tuner.start_step}")
    return out


# --------------------------------------------------------------------------
# phase 15: the MOSES benchmarking flow at ChEMBL-proxy width (N=40, E=4),
# and the port's tools
# --------------------------------------------------------------------------

CAMPAIGN_ARGS = ["--n", "1500", "--min-atoms", "25", "--max-atoms", "40",
                 "--seed", "0", "--shards", "2", "--epochs", "1",
                 "--sample-every", "1", "--batch-size", str(B),
                 "--n-generate", "4000", "--device", "cuda",
                 "--in-process", "--set", "tensorboard_dir="]
INTDIV_ROWS = 30000        # MOSES's generated set
INTDIV_CHECK_ROWS = 4000   # held against the CPU
INTDIV_TOL = 1e-6
MOSES_JOBS = 8
AB_BATCHES = 4


def timed_stage(campaign, args, stage: str):
    """(result, wall seconds) of one campaign stage, the device synced."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = campaign.run_stage(args, stage)
    torch.cuda.synchronize()
    return out, time.time() - t0


def nll_batches(rows: int, n_samples: int) -> int:
    """NLL batches of an evaluation over ``min(rows, n_samples)`` random
    rows (``max_rows`` of ``evaluate_model`` and ``testing_phase``)."""
    return n_batches(min(rows, min(100000, n_samples)))


def phase_campaign(fused_enn, root: str) -> dict:
    """15a: ``tools/campaign_chembl`` on the card; -> its config, data,
    checkpoint and launch counts by job."""
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.tools import campaign_chembl as campaign
    log("[15a the ChEMBL-proxy campaign (N=40, E=4): 1,500 SMILES of 25-40 "
        "atoms, 2 preprocess shards, GGNN bf16 B=1000 1 epoch, 4,000 "
        "generated, test, score]")
    t_start = time.time()
    args = campaign.parse_args(["--root", os.path.join(root, "chembl40"),
                                *CAMPAIGN_ARGS])
    data_dir = os.path.join(args.root, "data")
    secs = {}
    _, secs["data"] = timed_stage(campaign, args, "data")
    _, secs["preprocess"] = timed_stage(campaign, args, "preprocess")
    rows = {}
    for name in ("train", "valid", "test"):
        ds = HDFDataset(store.find_dataset(os.path.join(data_dir, name)))
        rows[name] = len(ds)
        backend = ds.backend
        ds.close()
    smiles = {name: len(open(os.path.join(data_dir, name + ".smi"))
                        .read().splitlines()) - 1
              for name in ("train", "valid", "test")}
    log(f"    data {secs['data']:.2f} s: molecules {smiles}; preprocess "
        f"(2 shard processes + combine, {backend} back end) "
        f"{secs['preprocess']:.2f} s: rows {rows}")

    by_job = {}
    fused_enn.reset_launch_counts()
    wf, secs["train"] = timed_stage(campaign, args, "train")
    cfg40 = wf.cfg
    check(cfg40.max_n_nodes == 40 and cfg40.n_edge_features == 4,
          f"campaign config N={cfg40.max_n_nodes} E={cfg40.n_edge_features}")
    check(wf.data_path == "resident", f"train took {wf.data_path}")
    rounds = sum(r for r, _ in wf.batch_stats)
    forwards = (n_batches(rows["valid"]) + rounds
                + nll_batches(rows["valid"], cfg40.n_samples)
                + nll_batches(rows["train"], cfg40.n_samples))
    by_job["campaign train"] = check_launches(fused_enn, cfg40,
                                              "campaign train job", forwards)
    conv = read_convergence(wf.cfg.job_dir)
    check(len(conv) == 1 and all(math.isfinite(x) for x in conv[0]),
          f"campaign convergence.log: {conv}")
    log(f"    train {secs['train']:.2f} s: {n_batches(rows['train'])} steps, "
        f"train loss {conv[0][2]:.4f}, valid {conv[0][3]:.4f}, UC-JSD "
        f"{conv[0][4]:.4f}; {rounds} sampler rounds, "
        f"{sum(by_job['campaign train'].values())} kernel launches "
        f"(10 x {forwards} forwards)")

    fused_enn.reset_launch_counts()
    wf, secs["generate"] = timed_stage(campaign, args, "generate")
    rounds = [r for r, _ in wf.batch_stats]
    by_job["campaign generate"] = check_launches(
        fused_enn, cfg40, "campaign generate job", sum(rounds))
    sample_s = sum(s for _, s in wf.batch_stats)
    log(f"    generate {secs['generate']:.2f} s: rounds per batch {rounds}, "
        f"sampler {4000 / sample_s:.1f} molecules/s "
        f"({1e3 * sample_s / sum(rounds):.3f} ms a round), "
        f"{sum(by_job['campaign generate'].values())} kernel launches")

    fused_enn.reset_launch_counts()
    wf, secs["test"] = timed_stage(campaign, args, "test")
    rounds = sum(r for r, _ in wf.batch_stats)
    forwards = (rounds + nll_batches(rows["test"], wf.cfg.n_samples)
                + nll_batches(rows["train"], wf.cfg.n_samples))
    by_job["campaign test"] = check_launches(fused_enn, cfg40,
                                             "campaign test job", forwards)
    scores = read_validation(wf.cfg.job_dir)
    check("Test 1" in scores and all(math.isfinite(x)
                                     for x in scores["Test 1"]),
          f"campaign validation.log: {scores}")
    log(f"    test {secs['test']:.2f} s: {rounds} rounds + NLL batches, "
        f"{sum(by_job['campaign test'].values())} kernel launches; Test 1 "
        f"{[round(x, 4) for x in scores['Test 1']]}")

    metrics, secs["score"] = timed_stage(campaign, args, "score")
    for key in ("validity", "uniqueness", "novelty", "int_div_1",
                "int_div_2", "pass_filters"):
        check(metrics[key] is not None and 0.0 <= metrics[key] <= 1.0,
              f"MOSES {key}: {metrics[key]}")
    check(metrics["n_generated"] == 4000, f"scored {metrics['n_generated']}")
    log(f"    score {secs['score']:.2f} s (MOSES suite, {MOSES_JOBS} worker "
        f"processes, IntDiv on the card): {json.dumps(metrics)}")
    log(f"    15a took {time.time() - t_start:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    return {"args": args, "cfg": cfg40, "data": data_dir, "rows": rows,
            "job": campaign.train_dir(args),
            "by_job": by_job}


def phase_campaign_kernels(fused_enn, camp: dict) -> list:
    """The kernel against its plain version at every N=40 launch shape
    (phase 3's bars), then phase 6's timings there; -> the timed rows."""
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    log("[15a kernel vs plain at every N=40 launch shape]")
    cfg40 = camp["cfg"]
    model = load_checkpoint(cfg40, checkpoint_path(camp["job"], 1)).to(
        "cuda").eval()
    sites = [site._replace(name="N=40 " + site.name)
             for site in main_path_sites(model)]
    check(sum(s.per_forward for s in sites) == per_forward(cfg40),
          "N=40 sites do not add up to per_forward")
    layouts = [fused_enn.flatten_weights(
        fused_enn.stacked_layers(s.owners[0]), torch.bfloat16, "cuda").layout
        for s in sites]
    check(len(set(layouts)) == len(layouts),
          "two N=40 sites share a weight layout: launches would mix")
    errs = sites_check(fused_enn, sites)
    return phase_timings(fused_enn, [("GGNN N=40", sites, errs,
                                      camp["by_job"])],
                         "[15a timings at N=40, bf16, CUDA events, warm L2]")


def phase_moses(camp: dict) -> None:
    """15b: IntDiv of 30,000 seeded fingerprints on the card; 4,000 of
    them against the CPU; the whole suite twice in this process."""
    from graphinvent_tpu_torch.chem import mol_from_smiles
    from graphinvent_tpu_torch.chem.fingerprint import bulk_fingerprints
    from graphinvent_tpu_torch.eval import moses
    log(f"[15b MOSES on the card: IntDiv of {INTDIV_ROWS} fingerprints, "
        f"{INTDIV_CHECK_ROWS} against the CPU, compute_metrics(n_jobs="
        f"{MOSES_JOBS}) twice]")
    t_start = time.time()
    train = moses.read_smi(os.path.join(camp["data"], "train.smi"))
    density = float(bulk_fingerprints([mol_from_smiles(s)
                                       for s in train[:300]]).mean())
    rng = np.random.default_rng(0)
    fps = (rng.random((INTDIV_ROWS, 2048), dtype=np.float32)
           < density).astype(np.float32)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        got = moses.internal_diversity_both(fps, device="cuda")
        runs.append(time.time() - t0)
    flops = 2.0 * INTDIV_ROWS * INTDIV_ROWS * 2048
    log(f"    {INTDIV_ROWS} x 2048 fingerprints at density {density:.4f} "
        f"(the Morgan bits of 300 of 15a's training SMILES): IntDiv "
        f"{got[0]:.6f} / {got[1]:.6f} in {runs[0]:.3f} s (first call) and "
        f"{runs[1]:.3f} s; the Gram product alone is {flops / 1e12:.2f} "
        f"TFLOP, {flops / PEAK_F32_FLOPS:.3f} s at the float32 peak")

    sub = fps[:INTDIV_CHECK_ROWS]
    f_gpu = torch.from_numpy(sub).to("cuda")
    f_cpu = torch.from_numpy(sub)
    for start in range(0, INTDIV_CHECK_ROWS, 2048):
        a = moses.intersection_counts(f_gpu, start, start + 2048).cpu()
        b = moses.intersection_counts(f_cpu, start, start + 2048)
        check(torch.equal(a, b) and torch.equal(a, a.round()),
              f"intersection counts of rows {start}.. differ card vs CPU")
    t0 = time.time()
    on_cpu = moses.internal_diversity_both(sub, device="cpu")
    cpu_s = time.time() - t0
    on_gpu = moses.internal_diversity_both(sub, device="cuda")
    err = max(abs(x - y) for x, y in zip(on_gpu, on_cpu))
    log(f"    {INTDIV_CHECK_ROWS} rows: integer counts equal card vs CPU "
        f"(max count {int(b.max())}); IntDiv card {on_gpu} CPU {on_cpu} "
        f"(CPU {cpu_s:.2f} s), max diff {err:.3g} (tol {INTDIV_TOL})")
    check(err <= INTDIV_TOL, f"IntDiv card vs CPU differ by {err}")

    gen_files = sorted(
        os.path.join(camp["job"], "generation", f)
        for f in os.listdir(os.path.join(camp["job"], "generation"))
        if f.startswith("epoch_1_gen") and f.endswith(".smi"))
    gen = [s for p in gen_files for s in moses.read_smi(p)]
    test = moses.read_smi(os.path.join(camp["data"], "test.smi"))
    results = []
    for k in range(2):
        t0 = time.time()
        results.append(moses.compute_metrics(gen, train, test,
                                             n_jobs=MOSES_JOBS,
                                             device="cuda"))
        log(f"    compute_metrics(n_jobs={MOSES_JOBS}) run {k + 1}: "
            f"{time.time() - t0:.2f} s for {len(gen)} generated, "
            f"{len(train)} train, {len(test)} test")
    check(json.dumps(results[0]) == json.dumps(results[1]),
          "two MOSES runs in one process differ")
    log(f"    15b took {time.time() - t_start:.1f} s")


def phase_roofline(cfg, data: dict, job: str, camp: dict) -> None:
    """15c: the roofline rows of the train step and the sampler round at
    N=13 (phase 7's data, phase 8's model) and N=40 (15a's)."""
    from graphinvent_tpu_torch.tools import roofline
    from graphinvent_tpu_torch.tools.common import dataset_rows
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    log("[15c roofline: train step and sampler round, bf16, B=1000, N=13 "
        "and N=40]")
    t_start = time.time()
    for tag, run_cfg, data_dir, ckpt in (
            ("N=13", cfg.replace(batch_size=B, compute_dtype="bfloat16",
                                 device="cuda"),
             data["dir"], checkpoint_path(job, 2)),
            ("N=40", camp["cfg"], camp["data"],
             checkpoint_path(camp["job"], 1))):
        rows = dataset_rows(run_cfg, data_dir, B)
        step = roofline.roofline_row(run_cfg, rows, n_steps=10, n_repeats=3)
        model = load_checkpoint(run_cfg, ckpt).to("cuda").eval()
        rnd = roofline.sampler_row(run_cfg, model, n_batches=3)
        for row in (step, rnd):
            check(row["flops" if row is step else "flops_per_round"] > 0
                  and math.isfinite(row["mfu"]), f"{tag}: roofline {row}")
            log(f"    {tag} {roofline.fmt_row(row)}")
            log("      " + json.dumps({k: row[k] for k in (
                "kind", "n", "mfu", "sol_step_time_s", "sol_fraction",
                "bound", "hbm_min_bytes", "card")}))
    log(f"    15c took {time.time() - t_start:.1f} s")


def phase_ab_two_phase(cfg, pretrained: tuple) -> None:
    """15d: the two-phase A/B on phase 13's raised GGNN at N=13."""
    from graphinvent_tpu_torch.tools import ab_two_phase
    log(f"[15d two-phase A/B: phase 13's raised GGNN, N=13, cap "
        f"{TWO_PHASE_ROUNDS}, {AB_BATCHES} batches of {B}]")
    t_start = time.time()
    job, epoch = pretrained
    run_cfg, model = load_trained(cfg, job, "bfloat16", epoch)
    out = ab_two_phase.ab(run_cfg, model.eval(), TWO_PHASE_ROUNDS,
                          AB_BATCHES)
    check(out["n_stragglers"] > 0 and out["single_molecules_per_s"] > 0,
          f"two-phase A/B: {out}")
    log(f"    single-phase {out['single_molecules_per_s']:.1f} molecules/s "
        f"({out['single_rounds']} rounds), two-phase "
        f"{out['two_phase_molecules_per_s']:.1f} molecules/s "
        f"({out['two_phase_rounds']} rounds, {out['n_continuation']} "
        f"continuation batches): {out['speedup']:.3f}x; stragglers "
        f"{out['n_stragglers']} of {out['molecules']}; actions a row "
        f"{out['actions']} [{out['card']}]")
    log(f"    15d took {time.time() - t_start:.1f} s")


def phase_qsar_fine_tune(fused_enn, cfg, root: str, data: dict,
                         pretrained: tuple) -> dict:
    """15e: ``tools/train_qsar`` (logistic, on the card) on stand-in labels
    ("has a ring") of phase 7's SMILES, then one fine-tune step scored by
    that model through ``main``; -> the job's launch counts."""
    from graphinvent_tpu_torch.chem import mol_from_smiles
    from graphinvent_tpu_torch.eval.moses import read_smi
    from graphinvent_tpu_torch.tools import train_qsar
    from graphinvent_tpu_torch.tools.synthesize_smiles import write_smi
    log("[15e a QSAR-scored fine-tune step: logistic model on stand-in "
        "labels (has a ring), not DRD2]")
    t_start = time.time()
    smiles = read_smi(os.path.join(data["dir"], "train.smi"))[:2000]
    ring = [bool(mol_from_smiles(s).rings()) for s in smiles]
    qdir = os.path.join(root, "qsar")
    os.makedirs(qdir)
    paths = [os.path.join(qdir, n) for n in ("actives.smi", "inactives.smi",
                                             "ring.pickle")]
    write_smi(paths[0], [s for s, r in zip(smiles, ring) if r])
    write_smi(paths[1], [s for s, r in zip(smiles, ring) if not r])
    t0 = time.time()
    q = train_qsar.main([*paths, "--classifier", "logistic", "--device",
                         "cuda"])
    log(f"    train_qsar {time.time() - t0:.2f} s: {q['n']} molecules, "
        f"{q['n_active']} with a ring, training accuracy "
        f"{q['train_accuracy']:.4f}")
    ft_cfg = fine_tune_cfg(cfg, data, pretrained[0], epochs=1,
                           sample_every=1).replace(
        score_components=("ring_activity", "QED"),
        score_thresholds=(0.0, 0.0), qsar_models={"ring_activity": paths[2]})
    qsar_job = os.path.join(root, "fine_tune_qsar")
    workflow, launches = run_fine_tune(fused_enn, "GGNN QSAR", ft_cfg,
                                       qsar_job)
    sequential_twin("GGNN QSAR", ft_cfg, qsar_job, workflow.fine_tuner)
    conv = read_convergence(workflow.cfg.job_dir)
    check(conv[0][4] > 0, f"the QSAR-scored step scored nothing: {conv}")
    log(f"    15e took {time.time() - t_start:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 16: multi-process jobs, two ranks sharing the card over gloo
# --------------------------------------------------------------------------

LOCAL_B = B // 2            # each rank's share of the global batch
MH_BLOCK = 1000             # blocks small enough for both ranks' shares
RANK_TIMEOUT = 300          # seconds one two-rank job may take
# NCCL refuses two ranks on one card: the ranks of phase 16 share it on
# gloo, which moves CUDA tensors through the host
SHARED_CARD = {"GRAPHINVENT_DIST_BACKEND": "gloo"}


def rank_job(job: str, report: str) -> None:
    """One rank of a phase-16 job (``python3 chip_smoke.py --rank-job <job
    dir> <report.json>``, started by :func:`run_two_ranks`), or of a phase-17
    job of one process's mesh (started by ``main`` itself): the job through
    the port's ``main``, recording each train step's global loss and
    seconds and its gradient all-reduce's seconds; writes them, the kernel
    launches (by layout, and by layout and rows) and the sampled batches'
    (rounds, seconds) to ``report`` (``{rank}`` in it: the rank's)."""
    import graphinvent_tpu_torch.workflow as workflow_mod
    from graphinvent_tpu_torch.main import main as port_main
    from graphinvent_tpu_torch.models import fused_enn
    from graphinvent_tpu_torch.parallel import mesh
    rec = {"loss": [], "step_s": [], "all_reduce_s": []}
    reduce_sum = mesh.all_reduce_sum_
    make_step = workflow_mod.make_sharded_train_step

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_sum(tensors)
        torch.cuda.synchronize()
        rec["all_reduce_s"].append(time.perf_counter() - t0)

    def recording_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, generator)
            rec["loss"].append(loss.item())
            rec["step_s"].append(time.perf_counter() - t0)
            return loss
        return run

    mesh.all_reduce_sum_ = timed_reduce
    workflow_mod.make_sharded_train_step = recording_step
    fused_enn.reset_launch_counts()
    workflow = port_main(["--job-dir", job])
    torch.cuda.synchronize()
    adam = getattr(workflow, "adam", None)
    tuner = getattr(workflow, "fine_tuner", None)
    if tuner is not None and workflow.rank == 0:
        # the last step's gradients, summed over the ranks
        torch.save(step_grads(tuner.adam),
                   report.format(rank=workflow.rank) + ".grads.pt")
    with open(report.format(rank=workflow.rank), "w") as fh:
        json.dump({"rank": workflow.rank,
                   "writer": workflow.logger is not None,
                   "launches": sum(fused_enn.LAUNCHES.values()),
                   "by_layout": [[list(k), v] for k, v in
                                 fused_enn.LAUNCHES_BY_LAYOUT.items()],
                   "by_shape": [[list(k), r, v] for (k, r), v in
                                fused_enn.LAUNCHES_BY_SHAPE.items()],
                   "batch_stats": workflow.batch_stats,
                   "adam_step": adam.step if adam else None,
                   "replay_steps": (workflow.fine_tuner.replay_steps
                                    if getattr(workflow, "fine_tuner", None)
                                    else []), **rec}, fh)


def rank_dirs(job_cfg, root: str, name: str) -> list:
    """Two job dirs, one a rank, each with ``job_cfg``'s input.csv."""
    dirs = []
    for p in range(2):
        job = os.path.join(root, f"{name}_rank{p}")
        os.makedirs(job)
        job_cfg.replace(job_dir=job + "/").write_csv(
            os.path.join(job, "input.csv"))
        dirs.append(job)
    return dirs


def run_two_ranks(dirs: list, root: str, name: str) -> tuple:
    """The job of ``dirs`` as two ranks on the card (``rank_job``), under
    a wall-clock limit; a failed rank kills the other and both outputs are
    printed.  -> (each rank's report, wall seconds)."""
    from graphinvent_tpu_torch.parallel.launch import RankFailure, run_ranks
    reports = [os.path.join(root, f"{name}_rank{p}.json") for p in range(2)]
    cmds = [[sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--rank-job", d, r] for d, r in zip(dirs, reports)]
    t0 = time.time()
    try:
        run_ranks(cmds, os.path.join(root, f"{name}_logs"), RANK_TIMEOUT,
                  env=dict(os.environ, **SHARED_CARD), cwd=ROOT)
    except RankFailure as exc:
        for p, out in enumerate(exc.outputs):
            log(f"    --- rank {p} of {name} ---\n{out}")
        raise
    wall = time.time() - t0
    out = []
    for path in reports:
        with open(path) as fh:
            out.append(json.load(fh))
    check([r["rank"] for r in out] == [0, 1], f"{name}: ranks {out}")
    return out, wall


def wrote_nothing(job: str, what: str) -> None:
    check(sorted(os.listdir(job)) == ["input.csv"],
          f"{what}: rank 1 wrote {sorted(os.listdir(job))}")


def same_files(a: str, b: str, names: list, what: str) -> None:
    import filecmp
    for name in names:
        check(filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                          shallow=False), f"{what}: {name} differs")


def copy_checkpoint(src: str, dst: str, epoch: int) -> None:
    for name in (f"model_restart_{epoch}.pth", f"optimizer_restart_{epoch}.pth"):
        if os.path.exists(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name), dst)


def by_layout(report: dict) -> dict:
    return {tuple(k): v for k, v in report["by_layout"]}


def phase_multi_preprocess(cfg, root: str, data: dict) -> None:
    from graphinvent_tpu_torch.data import store
    from graphinvent_tpu_torch.data.preprocess import preprocess_dataset
    log("[16a two-process preprocess of phase 7's SMILES: a shard a rank, "
        "rank 0 combines; against one process's 2-shard run]")
    dirs = {}
    for name in ("ranks", "one"):
        d = os.path.join(root, "mh_data_" + name)
        os.makedirs(d)
        for split in N_MOLECULES:
            shutil.copy(os.path.join(data["dir"], split + ".smi"), d)
        dirs[name] = d
    jobs = rank_dirs(cfg.replace(job_type="preprocess",
                                 dataset_dir=dirs["ranks"] + "/",
                                 tensorboard_dir=""), root, "mh_pre")
    _, wall = run_two_ranks(jobs, root, "mh_pre")
    t0 = time.time()
    preprocess_dataset(cfg.replace(dataset_dir=dirs["one"] + "/",
                                   preprocess_num_shards=2))
    one_s = time.time() - t0
    for split in N_MOLECULES:
        with store.ReadStore(store.find_dataset(
                os.path.join(dirs["ranks"], split))) as a, \
                store.ReadStore(store.find_dataset(
                    os.path.join(dirs["one"], split))) as b:
            check(sorted(a.arrays) == sorted(b.arrays), f"{split}: arrays")
            for k in a.arrays:
                check(np.array_equal(np.asarray(a.arrays[k][:]),
                                     np.asarray(b.arrays[k][:])),
                      f"{split}/{k}: two ranks != one process")
    same_files(dirs["ranks"], dirs["one"],
               ["train.csv", "preprocessing_params.csv"], "16a")
    wrote_nothing(jobs[1], "16a")
    log(f"    datasets, train.csv and preprocessing_params.csv byte-equal; "
        f"two ranks {wall:.2f} s (process start-up included), one process "
        f"{one_s:.2f} s; rank 1 wrote nothing")


def emulated_losses(cfg32, data: dict, job: str, epoch: int) -> list:
    """One process on the card, f32: the two ranks' global batch stream
    (global batch k = rank 0's batch k, then rank 1's) from phase 8's
    checkpoint and Adam sidecar; -> per-step losses."""
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.data.loader import BlockLoader
    from graphinvent_tpu_torch.parallel.multihost import (
        global_steps_per_epoch,
    )
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.train.step import (
        BatchUploader, make_train_step,
    )
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, restore_checkpoint,
    )
    cuda = torch.device("cuda")
    ds = HDFDataset(store.find_dataset(os.path.join(data["dir"], "train")))
    n = global_steps_per_epoch(len(ds), LOCAL_B, cfg32.block_size, 2)
    model, state = restore_checkpoint(cfg32, checkpoint_path(job, epoch),
                                      epoch)
    model = model.to(cuda)
    adam = Adam(model)
    adam.load_state_dict(state)
    step = make_train_step(cfg32, onecycle_for_config(cfg32, n), model, adam)
    shards = [BlockLoader(ds, LOCAL_B, cfg32.block_size, seed=cfg32.seed,
                          packed=bool(cfg32.stream_packed), shard_index=i,
                          num_shards=2) for i in range(2)]
    for sh in shards:
        sh.set_epoch(epoch + 1)
    place = BatchUploader(cuda)
    losses = []
    for k, (b0, b1) in enumerate(zip(shards[0], shards[1])):
        if k >= n:
            break
        batch = {key: np.concatenate([b0[key], b1[key]]) for key in b0}
        losses.append(step(place(batch)).item())
    ds.close()
    return losses


def valid_batches(data: dict, block_size: int, rank: int) -> int:
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.data.loader import BlockLoader
    ds = HDFDataset(store.find_dataset(os.path.join(data["dir"], "valid")))
    n = len(BlockLoader(ds, LOCAL_B, block_size, shuffle=False,
                        shard_index=rank, num_shards=2))
    ds.close()
    return n


def phase_multi_train(fused_enn, cfg, root: str, data: dict, job: str
                      ) -> tuple:
    """-> the kernel's 500-graph timing group (phase 6's form)."""
    log(f"[16b two-process train job: GGNN, B={B} ({LOCAL_B} a rank), block "
        f"{MH_BLOCK}, one epoch restarted from phase 8's checkpoint, two "
        "ranks on the card over gloo]")
    base = cfg.replace(job_type="train", dataset_dir=data["dir"] + "/",
                       batch_size=B, block_size=MH_BLOCK, restart=True,
                       epochs=1,
                       schedule_epochs=3, n_samples=1000, tensorboard_dir="",
                       device="cuda")
    # numerics: f32, no evaluation, against one process on the card
    f32 = base.replace(compute_dtype="float32", sample_every=100)
    dirs = rank_dirs(f32, root, "mh_train_f32")
    copy_checkpoint(job, dirs[0], 2)
    reports, wall = run_two_ranks(dirs, root, "mh_train_f32")
    got = reports[0]["loss"]
    check(got == reports[1]["loss"], "the ranks' global losses differ")
    want = emulated_losses(f32, data, job, 2)
    check(len(got) == len(want) > 1, f"{len(got)} steps, expected "
          f"{len(want)}")
    err = float(np.max(np.abs(np.array(got) - want) / np.abs(want)))
    check(np.allclose(got, want, rtol=1e-4, atol=0),
          f"two-rank f32 losses differ from one process's by rel {err}")
    check(os.path.exists(os.path.join(dirs[0], "model_restart_3.pth")),
          "rank 0 wrote no checkpoint")
    wrote_nothing(dirs[1], "16b f32")
    log(f"    f32: {len(got)} steps, per-step global loss vs one process "
        f"on the same global batches: max rel {err:.3g} (tol 1e-4); "
        f"{got[0]:.5f} -> {got[-1]:.5f}; job {wall:.2f} s")

    # bf16 with its evaluation on rank 0, timed
    bf16 = base.replace(compute_dtype="bfloat16", sample_every=1)
    dirs = rank_dirs(bf16, root, "mh_train")
    copy_checkpoint(job, dirs[0], 2)
    reports, wall = run_two_ranks(dirs, root, "mh_train")
    rounds = sum(r for r, _ in reports[0]["batch_stats"])
    check(not reports[1]["batch_stats"], "rank 1 sampled")
    forwards = [valid_batches(data, bf16.block_size, 0) + 2 + rounds,
                valid_batches(data, bf16.block_size, 1)]
    for p, (rep, fw) in enumerate(zip(reports, forwards)):
        check(rep["launches"] == per_forward(cfg) * fw,
              f"rank {p}: {rep['launches']} launches for {fw} grad-free "
              f"forwards (expected {per_forward(cfg)} each)")
        check(rep["adam_step"] == reports[0]["adam_step"],
              "the ranks' Adam steps differ")
    conv = read_convergence(dirs[0])
    check(len(conv) == 1 and int(conv[0][0]) == 3
          and all(math.isfinite(x) for x in conv[0]),
          f"convergence.log: {conv}")
    check("Epoch 3" in read_validation(dirs[0]), "no evaluation of epoch 3")
    wrote_nothing(dirs[1], "16b bf16")
    step_ms = 1e3 * np.array(reports[0]["step_s"][1:])
    red_ms = 1e3 * np.array(reports[0]["all_reduce_s"][1:])
    _, model = load_trained(cfg, job, "bfloat16")
    grad_mib = sum(p.numel() for p in model.parameters()) * 4 / 2**20
    log(f"    bf16: {len(step_ms) + 1} steps; launches rank 0 "
        f"{reports[0]['launches']} ({forwards[0]} forwards: validation, 2 "
        f"NLL batches, {rounds} sampler rounds), rank 1 "
        f"{reports[1]['launches']} ({forwards[1]} validation forwards at "
        f"{LOCAL_B} graphs); train loss {conv[0][2]:.5f}, valid (rank 0's "
        f"share) {conv[0][3]:.5f}; job {wall:.2f} s")
    log(f"    bf16 step on two ranks sharing the card: median "
        f"{np.median(step_ms):.3f} ms (min {step_ms.min():.3f}, max "
        f"{step_ms.max():.3f}); its gloo all-reduce of the gradients "
        f"({grad_mib:.1f} MiB f32 through the host): median "
        f"{np.median(red_ms):.3f} "
        f"ms (min {red_ms.min():.3f}, max {red_ms.max():.3f}); a reading "
        f"of one shared card, not of a multi-card run")

    # the kernel at the validation batches' 500-graph shapes
    sites = [s._replace(name=f"{s.name} B={LOCAL_B}")
             for s in main_path_sites(model.eval(), LOCAL_B)]
    log("    kernel vs plain at the 500-graph shapes (phase 3's bars):")
    errs = sites_check(fused_enn, sites)
    return ("GGNN B=500", sites, errs,
            {"2-rank train, rank 1 (validation)": by_layout(reports[1])})


def gen_files(job: str) -> list:
    return sorted("generation/" + f
                  for f in os.listdir(os.path.join(job, "generation")))


def phase_multi_generate(fused_enn, cfg, root: str, data: dict, job: str,
                         by_job: dict) -> None:
    n = 4 * B
    log(f"[16c two-process generate job: n_samples {n} (2 rounds of 2 "
        "batches) on phase 8's checkpoint, against one process]")
    gen_cfg = cfg.replace(job_type="generate", dataset_dir=data["dir"] + "/",
                          n_samples=n, batch_size=B, generation_epoch=2,
                          tensorboard_dir="", device="cuda",
                          compute_dtype="bfloat16")
    one = os.path.join(root, "mh_gen_one")
    os.makedirs(one)
    copy_checkpoint(job, one, 2)
    fused_enn.reset_launch_counts()
    workflow, one_wall = run_job(gen_cfg, one)
    one_rounds = sum(r for r, _ in workflow.batch_stats)
    check_launches(fused_enn, cfg, "one-process generate job", one_rounds)
    one_s = sum(s for _, s in workflow.batch_stats)
    dirs = rank_dirs(gen_cfg, root, "mh_gen")
    copy_checkpoint(job, dirs[0], 2)
    reports, wall = run_two_ranks(dirs, root, "mh_gen")
    files = gen_files(one)
    check(len(files) > 8 and gen_files(dirs[0]) == files,
          f"generated files {gen_files(dirs[0])} != {files}")
    same_files(one, dirs[0], files, "16c")
    wrote_nothing(dirs[1], "16c")
    secs = []
    for p, rep in enumerate(reports):
        rounds = sum(r for r, _ in rep["batch_stats"])
        check(len(rep["batch_stats"]) == 2, f"rank {p} sampled "
              f"{len(rep['batch_stats'])} batches, expected 2")
        check(rep["launches"] == per_forward(cfg) * rounds,
              f"rank {p}: {rep['launches']} launches for {rounds} rounds")
        by_job[f"2-rank generate, rank {p}"] = by_layout(rep)
        secs.append(sum(s for _, s in rep["batch_stats"]))
    log(f"    {len(files)} files byte-equal to the one-process job's; rank "
        f"1 wrote nothing; launches {[r['launches'] for r in reports]} = 10 "
        f"x each rank's rounds")
    # round 2 of the ranks samples global batches 2 and 3 side by side,
    # batches 2 and 3 of the one process one after the other; the ranks'
    # first round is each process's first sampler call
    one_warm = sum(s for _, s in workflow.batch_stats[2:])
    two_warm = max(rep["batch_stats"][1][1] for rep in reports)
    log(f"    sampling on the shared card, every batch: one process "
        f"{n / one_s:.1f} molecules/s ({one_s:.3f} s, warm), two ranks "
        f"{n / max(secs):.1f} molecules/s (slower rank {max(secs):.3f} s, "
        f"its first round cold); global batches 2-3 alone: one process "
        f"{2 * B / one_warm:.1f}, two ranks {2 * B / two_warm:.1f} "
        f"molecules/s ({one_warm:.3f} s and {two_warm:.3f} s); per rank "
        f"(rounds, s) {[rep['batch_stats'] for rep in reports]}; jobs end "
        f"to end {one_wall:.2f} s and {wall:.2f} s (two process start-ups)")


def phase_multi_test_fine_tune(fused_enn, cfg, root: str, data: dict,
                               job: str, pretrained: tuple,
                               by_job: dict) -> None:
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    log("[16d two-process test job and fine-tune step: rank 0's files equal "
        "one process's, rank 1 returns at once]")
    test_cfg = cfg.replace(
        job_type="test", dataset_dir=data["dir"] + "/", batch_size=B,
        block_size=10000, n_samples=1000, tensorboard_dir="", device="cuda",
        compute_dtype="bfloat16")
    one = os.path.join(root, "mh_test_one")
    os.makedirs(one)
    copy_checkpoint(job, one, 2)
    run_job(test_cfg, one)
    dirs = rank_dirs(test_cfg, root, "mh_test")
    copy_checkpoint(job, dirs[0], 2)
    reports, wall = run_two_ranks(dirs, root, "mh_test")
    same_files(one, dirs[0], ["validation.log"] + gen_files(one), "16d test")
    rounds = sum(r for r, _ in reports[0]["batch_stats"])
    check(reports[0]["launches"] == per_forward(cfg) * (rounds + 2),
          f"test rank 0: {reports[0]['launches']} launches")
    check(reports[1]["launches"] == 0 and not reports[1]["batch_stats"],
          "test rank 1 did work")
    wrote_nothing(dirs[1], "16d test")
    by_job["2-rank test, rank 0"] = by_layout(reports[0])
    log(f"    test: validation.log and generation/ byte-equal; rank 0 "
        f"{reports[0]['launches']} launches, rank 1 none; {wall:.2f} s")

    ft_cfg = fine_tune_cfg(cfg, data, pretrained[0], epochs=1,
                           sample_every=1)
    one = os.path.join(root, "mh_ft_one")
    run_job(ft_cfg, one)
    dirs = rank_dirs(ft_cfg, root, "mh_ft")
    reports, wall = run_two_ranks(dirs, root, "mh_ft")
    same_files(one, dirs[0], ["fine-tuning.log", "convergence.log"],
               "16d fine-tune")
    step = pretrained[1] + 1
    a = load_checkpoint(ft_cfg, checkpoint_path(one, step)).state_dict()
    b = load_checkpoint(ft_cfg, checkpoint_path(dirs[0], step)).state_dict()
    check(all(torch.equal(v, b[k]) for k, v in a.items()),
          "fine-tune: rank 0's weights != one process's")
    forwards = (sum(r for r, _ in reports[0]["batch_stats"])
                + sum(reports[0]["replay_steps"]))
    check(reports[0]["launches"] == per_forward(cfg) * forwards > 0
          or not per_forward(cfg),
          f"fine-tune rank 0: {reports[0]['launches']} launches for "
          f"{forwards} grad-free forwards")
    check(reports[1]["launches"] == 0 and not reports[1]["batch_stats"],
          "fine-tune rank 1 did work")
    wrote_nothing(dirs[1], "16d fine-tune")
    by_job["2-rank fine-tune, rank 0"] = by_layout(reports[0])
    log(f"    fine-tune step {step}: fine-tuning.log, convergence.log and "
        f"weights byte-equal; rank 0 {reports[0]['launches']} launches, "
        f"rank 1 none; {wall:.2f} s")


def phase_multi_tools(root: str, data: dict, job: str) -> None:
    log("[16e bench_scaling (dp=1 on NCCL; dp=1, 2 on gloo), NCCL refusing "
        "two ranks on one card, trace_step, trace_sampler, create_dataset, "
        "dataset_stats]")
    bench_scaling_runs()
    nccl_refuses_a_shared_card(root)
    trace_tools(job)
    data_tools(root, data)


def bench_scaling_runs() -> None:
    from graphinvent_tpu_torch.tools import bench_scaling
    nccl = bench_scaling.main(["250", "--device", "cuda", "--steps", "10"])
    check([r["dp"] for r in nccl["results"]] == [1]
          and nccl["results"][0]["backend"] == "nccl",
          f"bench_scaling on NCCL: {nccl['results']}")
    gloo = bench_scaling.main(["250", "--device", "cuda", "--backend", "gloo",
                               "--max-dp", "2", "--steps", "10"])
    check([r["dp"] for r in gloo["results"]] == [1, 2]
          and gloo["results"][1].get("label") == bench_scaling.SHARED,
          f"bench_scaling on gloo: {gloo['results']}")


def nccl_refuses_a_shared_card(root: str) -> None:
    from graphinvent_tpu_torch.parallel.launch import RankFailure, run_ranks
    code = ("from graphinvent_tpu_torch.config import preset\n"
            "from graphinvent_tpu_torch.parallel import multihost\n"
            "multihost.init_distributed(preset('GGNN', device='cuda'))\n")
    try:
        run_ranks([[sys.executable, "-c", code]] * 2,
                  os.path.join(root, "mh_nccl_logs"), 120, cwd=ROOT)
    except RankFailure as exc:
        check(any("nccl would put two ranks on one card" in out
                  for out in exc.outputs),
              "two NCCL ranks on one card failed otherwise:\n"
              + "\n".join(exc.outputs))
    else:
        raise AssertionError("two NCCL ranks on one card did not raise")
    log("    two NCCL ranks on one card: refused, as expected")


def trace_tools(job: str) -> None:
    from graphinvent_tpu_torch.tools import trace_sampler, trace_step
    ts = trace_step.main(["1000", "bfloat16", "GGNN", "--steps", "5",
                          "--device", "cuda"])
    check(ts["n_ops"] > 0, "trace_step traced no kernel")
    ckpt = os.path.join(job, "model_restart_2.pth")
    tsam = trace_sampler.main(["1000", "bfloat16", "13", "-", ckpt,
                               "--rounds", "16", "--repeats", "2",
                               "--device", "cuda"])
    check(tsam["fused_launches"] == 10 * sum(tsam["rounds"]),
          f"trace_sampler: {tsam['fused_launches']} launches for "
          f"{sum(tsam['rounds'])} rounds")
    log(f"    CUPTI lists the fused kernel in key_averages(): "
        f"{tsam['fused_in_trace']} of {tsam['fused_launches']} launches")


def data_tools(root: str, data: dict) -> None:
    from graphinvent_tpu_torch.tools import create_dataset, dataset_stats
    smi = [os.path.join(data["dir"], s + ".smi") for s in N_MOLECULES]
    raw = os.path.join(root, "mh_raw.smi")
    with open(raw, "w") as fh:
        fh.write("SMILES\n")
        for path in smi:
            with open(path) as src:
                fh.writelines(src.read().splitlines(True)[1:])
    t0 = time.time()
    one = create_dataset.main([raw, os.path.join(root, "mh_cd1"),
                               "--max-atoms", "13"])
    one_s = time.time() - t0
    t0 = time.time()
    pool = create_dataset.main([raw, os.path.join(root, "mh_cd4"),
                                "--max-atoms", "13", "--jobs", "4"])
    pool_s = time.time() - t0
    check(one == pool and 0 < one["kept"] <= one["read"],
          f"create_dataset: {one} vs {pool}")
    same_files(os.path.join(root, "mh_cd1"), os.path.join(root, "mh_cd4"),
               ["train.smi", "valid.smi", "test.smi"], "create_dataset")
    st = dataset_stats.main(smi)
    check(st["failed"] == 0 and st["max_n_nodes"] <= N
          and st["parsed"] == sum(N_MOLECULES.values()),
          f"dataset_stats: {st}")
    log(f"    create_dataset {one['kept']} kept of {one['read']}: "
        f"{one_s:.2f} s serial, {pool_s:.2f} s with 4 forkserver workers "
        f"(after CUDA init), same files")


# --------------------------------------------------------------------------
# phase 17: one process's mesh (data, model, graph), its ranks sharing the
# card over gloo
# --------------------------------------------------------------------------

MESH_TIMEOUT = 400          # seconds the four ranks of 17c may take
# 17d: rows of each of the fine-tune step's two batches in the gradient
# replay on one device's SELU branches (phase 13's gradient check's)
REPLAY_ROWS = RL_ROWS
# 17a, fresh bf16 rows of a node part (``fresh_rows_check``): draws at the
# N=40 message stack's part (one elsewhere), and how much further from
# float64 the kernel may lie than the plain version, in rms: a ratio, and a
# floor, since a wgmma sum does not round as cuBLAS's f32 sums do
NOISE_SEEDS = 8
NOISE_RMS = 1.25
NOISE_FLOOR = 1e-4
SVC_TOL = 5e-3              # 17e: decision values and probabilities, card
                            # vs CPU (libsvm's SMO stops at a KKT gap of
                            # 1e-3; the two devices may part at a near-tie)


@contextlib.contextmanager
def shared_card():
    """``SHARED_CARD`` in this process's environment, which ``main`` hands
    to the ranks it starts."""
    old = {k: os.environ.get(k) for k in SHARED_CARD}
    os.environ.update(SHARED_CARD)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_mesh_job(job_cfg, job: str, root: str, name: str) -> tuple:
    """The job as ONE process through the port's ``main``, which starts a
    rank a member of the mesh (each running :func:`rank_job`); -> (each
    rank's report, wall seconds)."""
    from graphinvent_tpu_torch.main import main as port_main
    from graphinvent_tpu_torch.parallel.mesh import local_mesh_size
    os.makedirs(job, exist_ok=True)
    job_cfg.replace(job_dir=job + "/").write_csv(
        os.path.join(job, "input.csv"))
    tmpl = os.path.join(root, name + "_rank{rank}.json")
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank-job",
           job, tmpl]
    t0 = time.time()
    with shared_card():
        out = port_main(["--job-dir", job], rank_command=cmd)
    wall = time.time() - t0
    check(out is None, f"{name}: main ran the job itself")
    k = local_mesh_size(job_cfg)
    reports = []
    for r in range(k):
        with open(tmpl.format(rank=r)) as fh:
            reports.append(json.load(fh))
    check([r["rank"] for r in reports] == list(range(k)),
          f"{name}: ranks {[r['rank'] for r in reports]}")
    check([r["writer"] for r in reports] == [True] + [False] * (k - 1),
          f"{name}: a rank other than 0 wrote into the job dir")
    return reports, wall


def by_shape(report: dict) -> dict:
    return {(tuple(k), rows): v for k, rows, v in report["by_shape"]}


def node_part(x: torch.Tensor, n_nodes: int, batch: slice, part: int,
              parts: int) -> torch.Tensor:
    """A rank's rows of a node-level site's input (B * N, W): its batch
    rows and its part of the nodes, the last part padded with zero nodes
    (``models/annotate``)."""
    from graphinvent_tpu_torch.models.annotate import _part
    W = x.shape[-1]
    return _part(x.view(-1, n_nodes, W)[batch], 1, parts, part
                 ).reshape(-1, W).contiguous()


class LayerSlice(torch.nn.Module):
    """A placed head slice's Linear as a one-layer tower (``linears``), the
    form the weight-flattening and timing helpers take; it shares the
    Linear's parameters."""

    def __init__(self, lin: torch.nn.Linear) -> None:
        super().__init__()
        self.linears = torch.nn.ModuleList([lin])


def head_slice_sites(model, mp: int) -> list:
    """Every rank's slice of every layer of the split tier-2 add and
    connect MLPs, as ``parallel/mesh.place_training_state`` places them
    on copies of ``model`` (one data and graph member): one-layer SELU
    layers at B rows, which the split head launches through
    ``fused_enn.fused_layer``; a site's owners are the ranks' slices."""
    from graphinvent_tpu_torch.parallel import mesh as M
    cfg = model.cfg.replace(dp_devices=1, mp_devices=mp, graph_devices=1)
    placed = []
    for m in range(mp):
        mesh = M.make_mesh(cfg, world=mp)._replace(model_index=m)
        rank_model = M.place_training_state(mesh, copy.deepcopy(model))[0]
        check(rank_model.APDReadout.split == (m, mp),
              f"17a: the head of rank {m} was not split")
        placed.append(rank_model.APDReadout)
    sites = []
    for net in ("fAddNet2", "fConnNet2"):
        for l, lin in enumerate(getattr(model.APDReadout, net).linears):
            owners = [[LayerSlice(getattr(head, net).linears[l])]
                      for head in placed]
            check(all(o[0].linears[0].weight.shape[0]
                      == lin.out_features // mp for o in owners),
                  f"17a: {net}[{l}] slices are not 1/{mp} of its rows")
            sites.append(Site(f"N=40 mp={mp} {net}[{l}] slice",
                              "fused_layer", owners, B, lin.in_features,
                              (B,), 1))
    return sites


def slice_cache_check(fused_enn, sites) -> None:
    """17a: ``fused_layer`` keeps each slice's flattened weights apart and
    flattens a slice again after its weights change in place (as Adam
    changes them): one slice of each site is scaled and every slice held
    against its plain path again."""
    for i, site in enumerate(sites):
        x = rand_rows(site.rows, site.width, 300 + i, torch.bfloat16)
        lin = site.owners[0][0].linears[0]
        scale = np.random.default_rng(i).uniform(1.0, 2.0, lin.weight.shape)
        with torch.no_grad():
            lin.weight.mul_(torch.from_numpy(scale).to(lin.weight))
        for k, mlps in enumerate(site.owners):
            kernel_check(fused_enn, f"{site.name}[{k}] after an update",
                         site.wrapper, mlps, x, site.lead)


def shape_of(fused_enn, site) -> tuple:
    flat = fused_enn.flatten_weights(fused_enn.stacked_layers(
        site.owners[0]), torch.bfloat16, "cuda")
    return flat.layout, site.rows


def plain64(fused_enn, flat, x: torch.Tensor) -> torch.Tensor:
    """The plain version's arithmetic accumulated in float64: the same
    rounding to x's type between layers, exact sums."""
    y = x.unsqueeze(0).expand(flat.E, -1, -1)
    layers = list(fused_enn._layer_views(flat))
    for l, (w, b) in enumerate(layers):
        a = fused_enn._selu_f32(torch.bmm(y.double(), w.double())
                                + b.double()[:, None, :])
        y = a if l == len(layers) - 1 else a.to(x.dtype)
    return y.to(x.dtype)


def fresh_rows_check(fused_enn, name: str, mlps, x: torch.Tensor) -> dict:
    """17a on fresh bf16 rows of a node part: the kernel under each plan
    and the plain version, both against the float64-accumulated plain
    arithmetic (:func:`plain64`).  Rounding to bf16 between layers turns
    a last-bit difference of two f32 sums into a whole bf16 step of a
    hidden unit, so two correct computations of a deep stack may part by
    more than the kernel-vs-plain bar; the check holds the kernel no
    further from float64 than the plain version is: its largest distance
    within one bar step (``TOL``) of the plain version's, its rms distance
    within ``NOISE_RMS`` of it plus ``NOISE_FLOOR``.  -> the readings."""
    tol = TOL[torch.bfloat16]
    flat = fused_enn.flatten_weights(fused_enn.stacked_layers(mlps),
                                     x.dtype, x.device)
    with torch.inference_mode():
        e = plain64(fused_enn, flat, x).float()
        p = fused_enn.fused_stacked_mlp_reference(flat, x).float()
        ks = [fused_enn.fused_enn_cuda(flat, x, plan).float()
              for plan in fused_enn.plan_choices(flat.dims)]
    torch.cuda.synchronize()

    def over(a, ref):
        return int(((a - ref).abs() > tol + tol * ref.abs()).sum())

    def rms(a):
        return (a - e).pow(2).mean().sqrt().item()

    r = {"k-p": max((k - p).abs().max().item() for k in ks),
         "k-p over": max(over(k, p) for k in ks),
         "k-f64": max((k - e).abs().max().item() for k in ks),
         "k-f64 over": max(over(k, e) for k in ks),
         "p-f64": (p - e).abs().max().item(), "p-f64 over": over(p, e),
         "k rms": max(rms(k) for k in ks), "p rms": rms(p)}
    ok = (r["k-f64"] <= r["p-f64"] + tol
          and r["k rms"] <= NOISE_RMS * r["p rms"] + NOISE_FLOOR)
    log(f"    {name:<24} fresh rows R={x.shape[0]:<6} max|kernel-plain| "
        f"{r['k-p']:.3g} ({r['k-p over']} over the bar); vs float64: "
        f"kernel max {r['k-f64']:.3g} rms {r['k rms']:.3g} "
        f"({r['k-f64 over']} over), plain max {r['p-f64']:.3g} rms "
        f"{r['p rms']:.3g} ({r['p-f64 over']} over) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: the kernel lies further from float64 than the "
          "plain version does")
    return r


def phase_mesh_kernels(fused_enn, model, model40) -> tuple:
    """17a: the kernel against its plain version at every new launch shape
    of the mesh: a rank's node part at N=13 (graph=2: 7 of 13 nodes, the
    second part padded, 7,000 rows; dp=2 x graph=2: 3,500) and at N=40
    (graph=2: 20,000).  Each part runs on its rows of phases 3's and 15a's
    whole-site inputs (against its plain version, and bit for bit the
    whole site's output rows under each plan) and on fresh rows (f32
    against its plain version; bf16 against float64, no further than the
    plain version: ``fresh_rows_check``, ``NOISE_SEEDS`` draws at the N=40
    message stack).  Then the one-layer head slices at N=40, mp=2, as
    ``place_training_state`` places them, through ``fused_layer`` (random
    inputs, as phase 3's; then again after a weight update); -> the sites
    and their bf16 errors."""
    log("[17a kernel vs plain at the mesh's new launch shapes]")
    sites, errs = [], {}
    for mdl, tag, shards in (
            (model, "N=13", ((slice(None), "graph=2"),
                             (slice(0, B // 2), "dp=2 graph=2"))),
            (model40, "N=40", ((slice(None), "graph=2"),))):
        N = mdl.cfg.max_n_nodes
        for i, site in enumerate(main_path_sites(mdl)):
            if site.rows != B * N:
                continue
            mlps = site.owners[0]
            for dt in (torch.float32, torch.bfloat16):
                x = rand_rows(site.rows, site.width, i, dt)
                flat = fused_enn.flatten_weights(
                    fused_enn.stacked_layers(mlps), dt, x.device)
                whole = {plan: fused_enn.fused_enn_cuda(flat, x, plan)
                         for plan in fused_enn.plan_choices(flat.dims)}
                for batch, shard in shards:
                    for part in range(2):
                        xs = node_part(x, N, batch, part, 2)
                        rows = xs.shape[0]
                        name = f"{tag} {shard} part {part} {site.name}"
                        err = kernel_check(fused_enn, name, site.wrapper,
                                           mlps, xs, (rows, 1))
                        n_real = (min(N, (part + 1) * -(-N // 2))
                                  - part * -(-N // 2))
                        for plan, out in whole.items():
                            got = fused_enn.fused_enn_cuda(flat, xs, plan)
                            want = out.view(flat.E, B, N, -1)[:, batch][
                                :, :, part * -(-N // 2):][:, :, :n_real]
                            check(torch.equal(got.view(
                                flat.E, want.shape[1], -1, want.shape[-1])[
                                :, :, :n_real], want),
                                f"{name} {plan}: the part's rows differ "
                                "from the whole site's")
                        draws = (NOISE_SEEDS if (tag, site.name, part) == (
                            "N=40", "msg_nns", 0) else 1)
                        for d in range(draws):
                            fresh = rand_rows(rows, site.width,
                                              1000 + 10 * i + part + 100 * d,
                                              dt)
                            if dt == torch.float32:
                                kernel_check(fused_enn, name + " fresh",
                                             site.wrapper, mlps, fresh,
                                             (rows, 1))
                            else:
                                fresh_rows_check(fused_enn, name, mlps,
                                                 fresh)
                        if dt == torch.bfloat16:
                            key = f"{tag} {shard} {site.name}"
                            errs[key] = max(errs.get(key, 0.0), err)
                            if part == 0:
                                sites.append(site._replace(
                                    name=key, rows=rows, lead=(rows, 1)))
    log("    every node part's output, under each plan, equals the whole "
        "site's rows bit for bit")
    heads = head_slice_sites(model40, 2)
    errs.update(sites_check(fused_enn, heads))
    slice_cache_check(fused_enn, heads)
    return sites + heads, errs


def phase_mesh_test(fused_enn, cfg, root: str, data: dict, job: str) -> dict:
    """17b: the test job as one process with graph_devices=2 on phase 8's
    checkpoint: scores against phase 9's one-device job, launches per rank
    (10 a forward; the NLL forwards at the rank's node shard)."""
    log("[17b test job as ONE process, graph_devices=2 (main starts 2 ranks "
        "sharing the card over gloo): phase 8's GGNN, bf16, B=1000]")
    mesh_job = os.path.join(root, "mesh_test")
    os.makedirs(mesh_job)
    copy_checkpoint(job, mesh_job, 2)
    test_cfg = cfg.replace(
        job_type="test", dataset_dir=data["dir"] + "/", batch_size=B,
        block_size=10000, n_samples=1000, tensorboard_dir="", device="cuda",
        compute_dtype="bfloat16", graph_devices=2)
    reports, wall = run_mesh_job(test_cfg, mesh_job, root, "mesh_test")
    want = read_validation(job)["Test 2"]
    got = read_validation(mesh_job)["Test 2"]
    diff = max(abs(a - b) for a, b in zip(got, want))
    msg_layout = shape_of(fused_enn, main_path_sites(
        load_trained(cfg, job, "bfloat16")[1])[0])[0]
    for r in reports:
        rounds = sum(x for x, _ in r["batch_stats"])
        check(r["launches"] == per_forward(cfg) * (rounds + 2),
              f"17b rank {r['rank']}: {r['launches']} launches for "
              f"{rounds} rounds + 2 NLL batches")
        rows = 7 * B            # 7 of 13 nodes, the second part padded
        check(by_shape(r).get((msg_layout, rows)) == 2 * cfg.message_passes,
              f"17b rank {r['rank']}: message stack launches at {rows} "
              f"rows: {by_shape(r).get((msg_layout, rows))}")
    log(f"    job {wall:.2f} s; Test 2 {[round(x, 4) for x in got]} vs one "
        f"device {[round(x, 4) for x in want]}: max diff {diff:.3g} (tol "
        f"{VALID_LOSS_TOL}); launches per rank "
        f"{[r['launches'] for r in reports]} (10 a forward; the 2 NLL "
        f"batches' node MLPs at 7,000 rows on each); rank 1 wrote nothing")
    check(diff <= VALID_LOSS_TOL, "17b: the mesh's test scores disagree")
    return {f"17b test rank {r['rank']}": by_shape(r) for r in reports}


def fit_mask(mask: torch.Tensor, x: torch.Tensor, mesh, n_nodes: int
             ) -> torch.Tensor:
    """The part of a one-device SELU branch mask that a rank's x holds,
    the mask recorded on the rows of the rank's data member: its nodes (a
    node MLP (B, N, O), or the message stack's (E, B * N, O)), or its
    columns of a split head layer (B, O).  Where N does not divide by the
    graph axis, the last part's padded nodes take x's own branches: no
    message reaches them and every gather drops them."""
    if mask.shape == x.shape:
        return mask
    g, m = mesh.graph_index, mesh.model_index
    if mask.dim() == 3 and mask.shape[1] == n_nodes:
        S = x.shape[1]
        part = mask[:, g * S:(g + 1) * S]
        if part.shape[1] < S:
            part = torch.cat([part, (x[:, part.shape[1]:] > 0).cpu()], 1)
        return part
    if mask.dim() == 3:
        E, R, O = mask.shape
        b = R // n_nodes
        S = x.shape[1] // b
        part = mask.view(E, b, n_nodes, O)[:, :, g * S:(g + 1) * S]
        if part.shape[2] < S:
            own = (x.view(E, b, S, O)[:, :, part.shape[2]:] > 0).cpu()
            part = torch.cat([part, own], 2)
        return part.reshape(x.shape)
    O = x.shape[-1]
    return mask[..., m * O:(m + 1) * O]


def mesh_step_rank(spec_path: str) -> None:
    """One rank of 17c (``python3 chip_smoke.py --mesh-step <spec.json>``):
    the bf16 validation loss of the batch through the kernel on its node
    shard and head slice, then one f32 train step on the one-device step's
    SELU branches; rank 0 writes the whole gradients."""
    from graphinvent_tpu_torch.config import GraphInventConfig
    from graphinvent_tpu_torch.models import fused_enn
    from graphinvent_tpu_torch.parallel import mesh as M
    from graphinvent_tpu_torch.parallel import multihost
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.utils.weights import load_checkpoint
    with open(spec_path) as fh:
        spec = json.load(fh)
    cfg = GraphInventConfig.from_job_dir(spec["cfg_dir"])
    check(multihost.init_distributed(cfg), "17c: no process group")
    try:
        rank = multihost.process_index()
        dev = torch.device("cuda", torch.cuda.current_device())
        model = load_checkpoint(cfg, spec["ckpt"]).to(dev)
        mesh = M.make_mesh(cfg)
        model, adam = M.place_training_state(mesh, model, Adam(model))
        batch = {k: v.to(dev) for k, v in torch.load(spec["batch"]).items()}
        fused_enn.reset_launch_counts()
        valid = M.make_sharded_eval_step(
            cfg.replace(compute_dtype="bfloat16"), model, mesh)(batch).item()
        shapes = by_shape_rows(fused_enn.LAUNCHES_BY_SHAPE)
        masks = torch.load(spec["branches"])
        flips = []
        step = M.make_sharded_train_step(cfg, onecycle_for_config(cfg, 10),
                                         model, adam, mesh)
        with selu_branches(replay=masks, flips=flips,
                           fit=lambda mk, x: fit_mask(mk, x, mesh,
                                                      cfg.max_n_nodes)):
            loss = step(batch).item()
        grads = {}
        for n, p in zip(adam.names, adam.params):
            g = p.grad.detach()
            if M._apd_head_spec(n, tuple(g.shape)) and model.APDReadout.split:
                g = M._gather_rows(g, mesh)
            grads[n] = g.double().cpu()
        if rank == 0:
            torch.save(grads, spec["grads"])
        with open(spec["report"].format(rank=rank), "w") as fh:
            json.dump({"rank": rank, "loss": loss, "valid": valid,
                       "flips": sum(flips), "by_shape": shapes,
                       "head_rows": [
                           list(p.shape) for n, p in model.named_parameters()
                           if n.startswith("APDReadout.fAddNet2")
                           and n.endswith("weight")],
                       "coords": [mesh.index, mesh.model_index,
                                  mesh.graph_index]}, fh)
        multihost.barrier()
    finally:
        multihost.shutdown()


def by_shape_rows(counts: dict) -> list:
    return [[list(k), r, v] for (k, r), v in counts.items()]


def phase_mesh_step(fused_enn, camp: dict, root: str) -> dict:
    """17c: one f32 train step at the N=40 campaign config over mp=2 x
    graph=2 (four ranks sharing the card) against one device, and the
    bf16 validation loss of its batch through the kernel on node shards
    and head slices."""
    from graphinvent_tpu_torch.data import HDFDataset, store
    from graphinvent_tpu_torch.parallel import multihost
    from graphinvent_tpu_torch.parallel.launch import RankFailure, run_ranks
    from graphinvent_tpu_torch.train.step import make_eval_step
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    log("[17c one f32 train step at N=40 (phase 15a's data and checkpoint) "
        "over mp=2 x graph=2, four ranks sharing the card, against one "
        "device; the bf16 validation loss of its batch on the kernel]")
    t_start = time.time()
    cfg40 = camp["cfg"].replace(compute_dtype="float32", mp_devices=2,
                                graph_devices=2, dp_devices=1, device="cuda",
                                tensorboard_dir="")
    work = os.path.join(root, "mesh_step")
    os.makedirs(work)
    cfg40.replace(job_dir=work + "/").write_csv(
        os.path.join(work, "input.csv"))
    ckpt = checkpoint_path(camp["job"], 1)
    model = load_checkpoint(cfg40, ckpt).to("cuda")
    ds = HDFDataset(store.find_dataset(os.path.join(camp["data"], "train")))
    block = ds.read_block(0, B)
    ds.close()
    batch = {k: torch.from_numpy(np.asarray(block[k], np.float32))
             for k in ("nodes", "edges", "apds")}
    batch["valid"] = torch.ones(B)
    torch.save(batch, os.path.join(work, "batch.pt"))
    cuda_batch = {k: v.cuda() for k, v in batch.items()}
    with torch.inference_mode():
        want_valid = make_eval_step(cfg40.replace(compute_dtype="bfloat16"),
                                    model)(cuda_batch).item()
    branches = []
    with selu_branches(record=branches):
        want_loss, want = step_gradients(cfg40, model, cuda_batch)
    torch.save(branches, os.path.join(work, "branches.pt"))
    n_selu = sum(m.numel() for m in branches)
    del branches
    spec = {"cfg_dir": work, "ckpt": ckpt,
            "batch": os.path.join(work, "batch.pt"),
            "branches": os.path.join(work, "branches.pt"),
            "grads": os.path.join(work, "grads.pt"),
            "report": os.path.join(work, "rank{rank}.json")}
    with open(os.path.join(work, "spec.json"), "w") as fh:
        json.dump(spec, fh)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--mesh-step",
           os.path.join(work, "spec.json")]
    env = dict(os.environ, **SHARED_CARD, **{multihost.ONE_PROCESS_MESH: "1"})
    t0 = time.time()
    try:
        run_ranks([cmd] * 4, os.path.join(work, "logs"), MESH_TIMEOUT,
                  env=env, cwd=ROOT)
    except RankFailure as exc:
        for p, out in enumerate(exc.outputs):
            log(f"    --- rank {p} of 17c ---\n{out}")
        raise
    wall = time.time() - t0
    reports = []
    for r in range(4):
        with open(spec["report"].format(rank=r)) as fh:
            reports.append(json.load(fh))
    got = torch.load(spec["grads"])
    dl = max(abs(r["loss"] - want_loss) / abs(want_loss) for r in reports)
    l2, mx, leaf = grad_errors(got, want, "17c")
    dv = max(abs(r["valid"] - want_valid) for r in reports)
    whole = [list(p.shape) for n, p in model.named_parameters()
             if n.startswith("APDReadout.fAddNet2") and n.endswith("weight")]
    for r in reports:
        check(all(h == [w[0] // 2, w[1]] for h, w in zip(r["head_rows"],
                                                          whole)),
              f"17c rank {r['rank']}: fAddNet2 rows {r['head_rows']}, whole "
              f"{whole}")
    log(f"    four ranks {wall:.2f} s (coords {[r['coords'] for r in reports]}"
        f"); each holds half of fAddNet2's rows ({reports[0]['head_rows']} "
        f"of {whole})")
    log(f"    f32 loss {reports[0]['loss']:.7f} vs one device "
        f"{want_loss:.7f} (rel {dl:.2g}, tol 1e-5); gradient leaves on the "
        f"one-device step's SELU branches: worst relative L2 {l2:.2g} (tol "
        f"{STEP_RTOL}), worst entry {mx:.2g} of its leaf's largest ({leaf}; "
        f"tol {STEP_ENTRY_TOL}); {max(r['flips'] for r in reports)} of "
        f"{n_selu} pre-activations lie across 0 on a rank")
    log(f"    bf16 validation loss on the kernel: {reports[0]['valid']:.5f} "
        f"vs one device {want_valid:.5f} (diff {dv:.3g}, tol "
        f"{VALID_LOSS_TOL}); 17c took {time.time() - t_start:.1f} s")
    check(dl <= 1e-5, "17c: the mesh's loss disagrees with one device")
    check(l2 <= STEP_RTOL and mx <= STEP_ENTRY_TOL,
          f"17c: the mesh's gradients disagree with one device ({leaf})")
    check(dv <= VALID_LOSS_TOL, "17c: the mesh's validation loss disagrees")
    return {f"17c validation rank {r['rank']}":
            {(tuple(k), rows): v for k, rows, v in r["by_shape"]}
            for r in reports}


def step_grads(adam) -> dict:
    return {n: p.grad.detach().double().cpu()
            for n, p in zip(adam.names, adam.params)}


@contextlib.contextmanager
def first_rl_loss(out: dict):
    """While active, the first ``rl_loss`` call of a fine-tune job in this
    process fills ``out``: the agent's weights before it, its two batches
    (on the host) and alpha."""
    from graphinvent_tpu_torch.rl import workflow_rl
    plain = workflow_rl.rl_loss

    def recording(cfg, agent, batch_a, batch_b, alpha, apply_fn=None):
        if not out:
            out.update(
                state={k: v.detach().cpu().clone()
                       for k, v in agent.state_dict().items()},
                batches=[tuple(t.detach().cpu() for t in b)
                         for b in (batch_a, batch_b)],
                alpha=float(alpha))
        return plain(cfg, agent, batch_a, batch_b, alpha, apply_fn)

    workflow_rl.rl_loss = recording
    try:
        yield
    finally:
        workflow_rl.rl_loss = plain


def mesh_replay_rank(spec_path: str) -> None:
    """One rank of 17d's gradient replay (``python3 chip_smoke.py
    --mesh-replay <spec.json>``): the fine-tune job's mesh gradient
    (``workflow_rl.sharded_rl_backward``) of the spec's rows, on the SELU
    branches that one device recorded on this rank's data member's rows,
    then the job's first Adam step; rank 0 writes the summed gradients,
    every rank its updated weights."""
    from graphinvent_tpu_torch.config import GraphInventConfig
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.parallel import mesh as M
    from graphinvent_tpu_torch.parallel import multihost
    from graphinvent_tpu_torch.rl.workflow_rl import sharded_rl_backward
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    with open(spec_path) as fh:
        spec = json.load(fh)
    cfg = GraphInventConfig.from_job_dir(spec["cfg_dir"])
    check(multihost.init_distributed(cfg), "17d: no process group")
    try:
        rank = multihost.process_index()
        dev = torch.device("cuda", torch.cuda.current_device())
        model = build_model(cfg)
        model.load_state_dict(torch.load(spec["state"]))
        model.to(dev)
        adam = Adam(model)
        mesh = M.make_mesh(cfg)
        batches = [tuple(t.to(dev) for t in b)
                   for b in torch.load(spec["batches"])]
        masks = torch.load(spec["branches"].format(data=mesh.index))
        flips = []
        adam.zero_grad()
        with selu_branches(replay=masks, flips=flips,
                           fit=lambda mk, x: fit_mask(mk, x, mesh,
                                                      cfg.max_n_nodes)):
            loss = sharded_rl_backward(cfg, model, adam, *batches,
                                       spec["alpha"], mesh).item()
        if rank == 0:
            torch.save(step_grads(adam), spec["grads"])
        # the fine-tune job's schedule and first step (FineTuner)
        adam.update(*onecycle_for_config(cfg, 1)(adam.step))
        torch.save({n: p.detach().double().cpu()
                    for n, p in model.named_parameters()},
                   spec["weights"].format(rank=rank))
        with open(spec["report"].format(rank=rank), "w") as fh:
            json.dump({"rank": rank, "loss": loss, "flips": sum(flips),
                       "calls": len(flips), "masks": len(masks),
                       "coords": [mesh.index, mesh.model_index,
                                  mesh.graph_index]}, fh)
        multihost.barrier()
    finally:
        multihost.shutdown()


def phase_mesh_replay(ft_cfg, captured: dict, root: str) -> None:
    """17d: the fine-tune job's gradient replay over dp=2 x graph=2 (four
    ranks sharing the card, ``--mesh-replay``) on the first
    ``REPLAY_ROWS`` rows of both batches of its first step, against one
    device on the same rows.  One device replays each data member's half
    on its own, recording its SELU branches; ``rl_loss`` is a mean, so
    the mean of the halves' gradients is the rows' gradient; the ranks
    replay on those branches, then take the job's first Adam step.  Bars:
    phase 13's (the loss, and every gradient leaf in relative L2 and in its
    worst entry), and the updated weights of every rank equal to each
    other.  Against one device's step from the one-device gradient the
    weights are reported, not held: a first Adam step moves each entry by
    about lr times its gradient's sign, so an entry whose gradient is of
    rounding size may go either way."""
    from graphinvent_tpu_torch.models import build_model
    from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
    from graphinvent_tpu_torch.parallel import multihost
    from graphinvent_tpu_torch.parallel.launch import RankFailure, run_ranks
    check(captured["alpha"] == ft_cfg.alpha, "17d: alpha "
          f"{captured['alpha']} is not the config's {ft_cfg.alpha}")
    work = os.path.join(root, "mesh_replay")
    os.makedirs(work)
    ft_cfg.replace(dp_devices=2, graph_devices=2, job_dir=work + "/"
                   ).write_csv(os.path.join(work, "input.csv"))
    batches = [tuple(t[:REPLAY_ROWS] for t in b)
               for b in captured["batches"]]
    agent = build_model(ft_cfg)
    agent.load_state_dict(captured["state"])
    half = REPLAY_ROWS // 2
    losses, grads, n_selu = [], [], 0
    spec = {"cfg_dir": work, "state": os.path.join(work, "state.pt"),
            "batches": os.path.join(work, "batches.pt"),
            "branches": os.path.join(work, "branches{data}.pt"),
            "grads": os.path.join(work, "grads.pt"),
            "weights": os.path.join(work, "weights{rank}.pt"),
            "report": os.path.join(work, "rank{rank}.json")}
    for d in range(2):
        share = [tuple(t[d * half:(d + 1) * half].numpy() for t in b)
                 for b in batches]
        branches = []
        with selu_branches(record=branches):
            loss_d, g_d = rl_gradients(ft_cfg, agent, share,
                                       torch.device("cuda"), torch.float32)
        torch.save(branches, spec["branches"].format(data=d))
        n_selu += sum(m.numel() for m in branches)
        del branches
        losses.append(loss_d)
        grads.append(g_d)
    want_loss = (losses[0] + losses[1]) / 2
    want = {n: (g + grads[1][n]) / 2 for n, g in grads[0].items()}
    torch.save(captured["state"], spec["state"])
    torch.save(batches, spec["batches"])
    with open(os.path.join(work, "spec.json"), "w") as fh:
        json.dump(dict(spec, alpha=captured["alpha"]), fh)
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
           "--mesh-replay", os.path.join(work, "spec.json")]
    env = dict(os.environ, **SHARED_CARD, **{multihost.ONE_PROCESS_MESH: "1"})
    t0 = time.time()
    try:
        run_ranks([cmd] * 4, os.path.join(work, "logs"), MESH_TIMEOUT,
                  env=env, cwd=ROOT)
    except RankFailure as exc:
        for p, out in enumerate(exc.outputs):
            log(f"    --- rank {p} of 17d's replay ---\n{out}")
        raise
    wall = time.time() - t0
    reports = []
    for r in range(4):
        with open(spec["report"].format(rank=r)) as fh:
            reports.append(json.load(fh))
    for r in reports:
        check(r["calls"] == r["masks"], f"17d replay rank {r['rank']}: "
              f"{r['calls']} SELU calls on {r['masks']} recorded masks")
    got = torch.load(spec["grads"])
    dl = max(abs(r["loss"] - want_loss) / abs(want_loss) for r in reports)
    l2, mx, leaf = grad_errors(got, want, "17d replay")
    one = copy.deepcopy(agent).to("cuda")
    adam = Adam(one)
    for n, p in one.named_parameters():
        p.grad = want[n].to(p)
    adam.update(*onecycle_for_config(ft_cfg, 1)(adam.step))
    ranks_w = [torch.load(spec["weights"].format(rank=r)) for r in range(4)]
    same = all(torch.equal(w[n], ranks_w[0][n]) for w in ranks_w[1:]
               for n in w)
    dw = worst_g = 0.0
    other = total = 0
    for n, p in one.named_parameters():
        w_one, start = p.detach().double().cpu(), captured["state"][n].double()
        dw = max(dw, ((ranks_w[0][n] - w_one).norm() / w_one.norm()).item())
        flip = (ranks_w[0][n] > start) != (w_one > start)
        other += int(flip.sum())
        total += flip.numel()
        if flip.any():
            worst_g = max(worst_g, (want[n].abs()[flip].max()
                                    / want[n].abs().max()).item())
    log(f"    gradient replay of {REPLAY_ROWS} rows a batch over four ranks "
        f"({wall:.2f} s, coords {[r['coords'] for r in reports]}): f32 loss "
        f"{reports[0]['loss']:.6f} vs one device {want_loss:.6f} (rel "
        f"{dl:.2g}, tol {STEP_LOSS_RTOL}); gradient leaves on one device's "
        f"SELU branches: worst relative L2 {l2:.2g} (tol {STEP_RTOL}), "
        f"worst entry {mx:.2g} of its leaf's largest ({leaf}; tol "
        f"{STEP_ENTRY_TOL}); pre-activations across 0 on a rank: "
        f"{[r['flips'] for r in reports]} of {n_selu} recorded; weights "
        f"after the first Adam step: the ranks' {'equal' if same else 'DIFFER'}"
        f"; against one device's step, worst leaf {dw:.2g} relative L2, "
        f"{other} of {total} entries moved the other way, each with a "
        f"gradient at most {worst_g:.2g} of its leaf's largest (reported)")
    check(dl <= STEP_LOSS_RTOL, "17d: the replay's loss disagrees")
    check(l2 <= STEP_RTOL and mx <= STEP_ENTRY_TOL,
          f"17d: the mesh's replay gradients disagree with one device "
          f"({leaf})")
    check(same, "17d: the ranks' weights differ after the update")


def phase_mesh_generate_fine_tune(fused_enn, cfg, root: str, data: dict,
                                  job: str, pretrained: tuple) -> dict:
    """17d: a generate job of 2,000 samples as one process with
    dp_devices=2 (files byte-equal to the one-device job's), then one f32
    fine-tune step as one process with dp=2 x graph=2 on phase 13's raised
    GGNN against one device."""
    log("[17d generate job (2,000 samples) as ONE process with dp_devices=2,"
        " and one f32 fine-tune step with dp=2 x graph=2, against one "
        "device]")
    one = os.path.join(root, "mesh_gen_one")
    two = os.path.join(root, "mesh_gen_dp2")
    for d in (one, two):
        os.makedirs(d)
        copy_checkpoint(job, d, 2)
    gen_cfg = cfg.replace(job_type="generate", dataset_dir=data["dir"] + "/",
                          n_samples=2000, batch_size=B,
                          generation_epoch=2, tensorboard_dir="",
                          device="cuda", compute_dtype="bfloat16")
    fused_enn.reset_launch_counts()
    _, wall_one = run_job(gen_cfg, one)
    reports, wall = run_mesh_job(gen_cfg.replace(dp_devices=2), two, root,
                                 "mesh_gen")
    files = gen_files(one)
    check(files == gen_files(two), f"17d: files {files} vs {gen_files(two)}")
    same_files(one, two, files, "17d generate")
    for r in reports:
        rounds = sum(x for x, _ in r["batch_stats"])
        check(r["launches"] == per_forward(cfg) * rounds,
              f"17d rank {r['rank']}: {r['launches']} launches for {rounds} "
              "rounds")
    log(f"    generate: {len(files)} files byte-equal to the one-device "
        f"job's; one device {wall_one:.2f} s, two ranks (500 rows each) "
        f"{wall:.2f} s; launches per rank {[r['launches'] for r in reports]}")

    ft_one = os.path.join(root, "mesh_ft_one")
    ft_mesh = os.path.join(root, "mesh_ft_mesh")
    ft_cfg = fine_tune_cfg(cfg, data, pretrained[0], epochs=1,
                           sample_every=1).replace(compute_dtype="float32")
    fused_enn.reset_launch_counts()
    captured = {}
    with first_rl_loss(captured):
        wf, wall_one = run_job(ft_cfg, ft_one)
    step = wf.fine_tuner.start_step
    reports, wall = run_mesh_job(ft_cfg.replace(dp_devices=2,
                                                graph_devices=2),
                                 ft_mesh, root, "mesh_ft")
    want, got = read_convergence(ft_one)[0], read_convergence(ft_mesh)[0]
    dl = abs(got[2] - want[2]) / abs(want[2])
    l2, mx, leaf = grad_errors(torch.load(os.path.join(
        root, "mesh_ft_rank0.json.grads.pt")), step_grads(wf.fine_tuner.adam),
        "17d")
    for r in reports:
        rounds = sum(x for x, _ in r["batch_stats"])
        check(r["launches"] == per_forward(cfg) * (rounds
                                                  + sum(r["replay_steps"])),
              f"17d fine-tune rank {r['rank']}: {r['launches']} launches")
    log(f"    fine-tune step {step}: f32 loss {got[2]:.6f} vs one device "
        f"{want[2]:.6f} (rel {dl:.2g}, tol {STEP_LOSS_RTOL}); gradient "
        f"leaves, raw (each job on its own SELU branches): worst relative "
        f"L2 {l2:.2g}, worst entry {mx:.2g} of its leaf's largest ({leaf}); "
        f"one device {wall_one:.2f} s, four ranks {wall:.2f} s; launches "
        f"per rank {[r['launches'] for r in reports]} (replays at 3,500 "
        f"rows)")
    check(dl <= STEP_LOSS_RTOL, "17d: the fine-tune loss disagrees")
    phase_mesh_replay(ft_cfg, captured, root)
    return {f"17d fine-tune rank {r['rank']}": by_shape(r) for r in reports}


def phase_mesh_svc(root: str) -> None:
    """17e: ``train_qsar --classifier svc`` on the card on 15e's 2,000
    molecules; its predictions against the same fit on the CPU."""
    import pickle
    from graphinvent_tpu_torch.eval.qsar import fit_svc
    from graphinvent_tpu_torch.tools import train_qsar
    log("[17e train_qsar --classifier svc (RBF SVC) on the card, 15e's "
        "molecules]")
    qdir = os.path.join(root, "qsar")
    paths = [os.path.join(qdir, n) for n in ("actives.smi", "inactives.smi",
                                             "ring_svc.pickle")]
    t0 = time.time()
    q = train_qsar.main([*paths, "--classifier", "svc", "--device", "cuda"])
    fit_s = time.time() - t0
    with open(paths[2], "rb") as fh:
        card = pickle.load(fh)["classifier_sv"]
    X = np.concatenate([train_qsar.fingerprints(p) for p in paths[:2]])
    y = np.concatenate([np.ones(q["n_active"]),
                        np.zeros(q["n"] - q["n_active"])])
    t0 = time.time()
    cpu = fit_svc(X, y, device="cpu")
    cpu_s = time.time() - t0
    dd = np.abs(card.decision_function(X) - cpu.decision_function(X)).max()
    dp = np.abs(card.predict_proba(X) - cpu.predict_proba(X)).max()
    same = float(np.mean(card.predict(X) == cpu.predict(X)))
    log(f"    fit on the card {fit_s:.2f} s (train_qsar, fingerprints "
        f"included), on the CPU {cpu_s:.2f} s: {q['n']} molecules, "
        f"{len(card.support_vectors_)} support vectors, training accuracy "
        f"{q['train_accuracy']:.4f}; card vs CPU: labels equal {same:.4f}, "
        f"decision values {dd:.3g}, probabilities {dp:.3g} (tol {SVC_TOL})")
    check(same == 1.0 and dd <= SVC_TOL and dp <= SVC_TOL,
          "17e: the card's SVC disagrees with the CPU's")


def phase_mesh(fused_enn, cfg, model, root: str, data: dict, job: str,
               camp: dict, pretrained: tuple) -> list:
    """Phase 17; -> the timed rows of the new launch shapes."""
    from graphinvent_tpu_torch.utils.weights import (
        checkpoint_path, load_checkpoint,
    )
    t_start = time.time()
    model40 = load_checkpoint(camp["cfg"], checkpoint_path(camp["job"], 1)
                              ).to("cuda").eval()
    sites, errs = phase_mesh_kernels(fused_enn, model, model40)
    launches = phase_mesh_test(fused_enn, cfg, root, data, job)
    launches.update(phase_mesh_step(fused_enn, camp, root))
    launches.update(phase_mesh_generate_fine_tune(fused_enn, cfg, root,
                                                  data, job, pretrained))
    phase_mesh_svc(root)
    # one timed row a (layout, rows), with its launches in every rank's run
    groups, seen = [], set()
    for site in sites:
        key = shape_of(fused_enn, site)
        if key in seen:
            continue
        seen.add(key)
        by_job = {job_: {key[0]: counts[key]}
                  for job_, counts in launches.items() if key in counts}
        check(bool(by_job), f"{site.name}: no rank launched the kernel at "
              f"{key[1]} rows of layout {key[0]}")
        groups.append(("mesh", [site], errs, by_job))
    timed = phase_timings(fused_enn, groups,
                          "[17a timings at the mesh's new launch shapes, "
                          "bf16, CUDA events, warm L2]")
    log(f"    phase 17 took {time.time() - t_start:.1f} s")
    return timed


# --------------------------------------------------------------------------
# phase 18: a .h5 dataset written elsewhere, read on the card without h5py
# --------------------------------------------------------------------------

FIXTURE = os.path.join(ROOT, "tests", "torch_port_data", "ggnn_n13.json")


@contextlib.contextmanager
def without_h5py():
    """``import h5py`` raises inside, as on a machine without h5py,
    wherever h5py is installed."""
    saved = sys.modules.get("h5py")
    sys.modules["h5py"] = None
    try:
        yield
    finally:
        sys.modules.pop("h5py", None)
        if saved is not None:
            sys.modules["h5py"] = saved


def read_whole(path: str) -> tuple:
    """(arrays read whole from ``path`` through ``ReadStore``, seconds to
    open, seconds to read)."""
    from graphinvent_tpu_torch.data import store
    t0 = time.perf_counter()
    ds = store.ReadStore(path)
    t1 = time.perf_counter()
    arrays = {k: np.array(v) for k, v in ds.arrays.items()}
    t2 = time.perf_counter()
    ds.close()
    return arrays, t1 - t0, t2 - t1


def phase_h5_fixture(root: str, data: dict) -> dict:
    """18a: the committed fixture (written by the JAX package's
    preprocessing with h5py) through ``ReadStore``; -> two dataset dirs
    holding it as train / valid / test, one as ``.h5`` and one as a
    ``.npd`` copy, each with phase 7's csv files."""
    import hashlib
    from graphinvent_tpu_torch.data import store
    with open(FIXTURE) as fh:
        manifest = json.load(fh)
    log(f"[18a the committed .h5 fixture ({manifest['rows']} rows, "
        f"{manifest['bytes']} bytes; h5py {manifest['h5py']}, HDF5 "
        f"{manifest['hdf5']}) through ReadStore, import h5py blocked]")
    path = os.path.join(os.path.dirname(FIXTURE), manifest["file"])
    with without_h5py():
        arrays, open_s, read_s = read_whole(path)
    for name, want in manifest["arrays"].items():
        got = arrays[name]
        digest = hashlib.sha256(np.ascontiguousarray(got).tobytes())
        check(list(got.shape) == want["shape"]
              and str(got.dtype) == want["dtype"]
              and digest.hexdigest() == want["sha256"],
              f"{name}: {got.shape} {got.dtype} does not match the manifest")
    dirs = {}
    for backend in ("h5", "npd"):
        d = os.path.join(root, "fixture_" + backend)
        os.makedirs(d)
        for name in ("train.csv", "preprocessing_params.csv"):
            shutil.copy(os.path.join(data["dir"], name), d)
        for split in ("train", "valid", "test"):
            out = os.path.join(d, f"{split}.{backend}")
            if backend == "h5":
                shutil.copy(path, out)
            else:
                store.write_arrays(out, arrays)
        dirs[backend] = d
    _, npd_open, npd_read = read_whole(os.path.join(dirs["npd"], "train.npd"))
    log(f"    shapes, dtypes and sha256 of nodes, edges, APDs equal the "
        f"manifest; open {open_s * 1e3:.3f} ms, read whole "
        f"{read_s * 1e3:.3f} ms (.h5); the same arrays as .npd: open "
        f"{npd_open * 1e3:.3f} ms, read whole {npd_read * 1e3:.3f} ms")
    return {"dirs": dirs, "rows": manifest["rows"]}


def phase_h5_test(fused_enn, cfg, model, job: str, fixture: dict) -> dict:
    """18b: the test job through ``main`` on the fixture as test.h5 (and
    train.h5), phase 8's checkpoint, B=1000, bf16, against the same job on
    the .npd copy, and the kernel at its NLL batch's shapes (phase 3's:
    ``model``'s seeded weights, its inputs and bars); -> the .h5 job's
    launch counts."""
    log("[18b test job on the .h5 fixture against the .npd copy]")
    test_cfg = cfg.replace(
        job_type="test", batch_size=B, block_size=10000, n_samples=1000,
        tensorboard_dir="", device="cuda", compute_dtype="bfloat16")
    jobs, launches, walls = {}, {}, {}
    for backend, d in fixture["dirs"].items():
        jobs[backend] = os.path.join(os.path.dirname(d), "test_" + backend)
        os.makedirs(jobs[backend])
        copy_checkpoint(job, jobs[backend], 2)
        fused_enn.reset_launch_counts()
        workflow, walls[backend] = run_job(
            test_cfg.replace(dataset_dir=d + "/"), jobs[backend])
        rounds = sum(r for r, _ in workflow.batch_stats)
        nll = 2 * n_batches(min(test_cfg.n_samples, fixture["rows"]))
        launches[backend] = check_launches(
            fused_enn, test_cfg, f"test job on the {backend} fixture",
            rounds + nll)
    same_files(jobs["h5"], jobs["npd"], ["validation.log"] +
               gen_files(jobs["h5"]), "18b test job, .h5 vs .npd")
    scores = read_validation(jobs["h5"])["Test 2"]
    check(all(math.isfinite(x) for x in scores), f"18b scores {scores}")
    log(f"    validation.log and generation/ byte-equal; Test 2: NLL test "
        f"{scores[0]:.4f}, train {scores[1]:.4f}; {rounds} rounds + {nll} "
        f"NLL batches, {sum(launches['h5'].values())} launches; job "
        f"{walls['h5']:.2f} s (.h5) / {walls['npd']:.2f} s (.npd)")
    log("    kernel vs plain at the NLL batch's shapes (B=1000, N=13: phase "
        "3's shapes, weights, inputs and bars):")
    sites_check(fused_enn, main_path_sites(model))
    return launches["h5"]


def phase_h5_stream(fused_enn, cfg, job: str, fixture: dict) -> dict:
    """18c: one streamed epoch restarted from phase 8 on the fixture as
    train.h5 / valid.h5, against the same epoch on the .npd copy; -> the
    .h5 job's launch counts."""
    import graphinvent_tpu_torch.workflow as port_workflow
    log("[18c streamed epoch restarted from phase 8 on the .h5 fixture "
        "against the .npd copy]")
    stream_cfg = cfg.replace(
        job_type="train", batch_size=B, block_size=10000, restart=True,
        epochs=1, schedule_epochs=3, sample_every=1, n_samples=1000,
        device_data_gb=0.0, tensorboard_dir="", device="cuda",
        compute_dtype="bfloat16")
    inner = port_workflow.make_train_step
    losses, launches, jobs, wires, walls = {}, {}, {}, {}, {}
    for backend, d in fixture["dirs"].items():
        jobs[backend] = os.path.join(os.path.dirname(d), "stream_" + backend)
        os.makedirs(jobs[backend])
        copy_checkpoint(job, jobs[backend], 2)
        losses[backend] = []

        def recording(*args, _into=losses[backend], **kw):
            train_step = inner(*args, **kw)

            def step(*a, **k):
                loss = train_step(*a, **k)
                _into.append(loss.detach().clone())
                return loss
            return step

        fused_enn.reset_launch_counts()
        port_workflow.make_train_step = recording
        try:
            workflow, walls[backend] = run_job(
                stream_cfg.replace(dataset_dir=d + "/"), jobs[backend])
        finally:
            port_workflow.make_train_step = inner
        check(workflow.data_path == "streamed",
              f"18c took the {workflow.data_path} path")
        wires[backend] = workflow.apd_wire
        rounds = sum(r for r, _ in workflow.batch_stats)
        launches[backend] = check_launches(
            fused_enn, stream_cfg, f"streamed epoch on the {backend} fixture",
            n_batches(fixture["rows"]) + 2 + rounds)
    a, b = torch.stack(losses["h5"]), torch.stack(losses["npd"])
    check(len(a) == n_batches(fixture["rows"]) and torch.equal(a, b),
          f"18c per-step losses: {a.tolist()} vs {b.tolist()}")
    check(wires["h5"] == wires["npd"], f"18c APD wires {wires}")
    same_files(jobs["h5"], jobs["npd"], ["convergence.log", "validation.log"],
               "18c streamed epoch, .h5 vs .npd")
    log(f"    APD wire chosen once a dataset: {wires['h5']}; {len(a)} "
        f"per-step losses bit-equal ({[round(x, 5) for x in a.tolist()]}); "
        f"convergence.log and validation.log byte-equal; "
        f"{sum(launches['h5'].values())} launches; job {walls['h5']:.2f} s "
        f"(.h5) / {walls['npd']:.2f} s (.npd)")
    return launches["h5"]


# --------------------------------------------------------------------------
# phase 19: the benchmark's cells
# --------------------------------------------------------------------------

def fmt_reading(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k} {fmt_reading(x)}"
                               for k, x in v.items()) + "}"
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def phase_bench() -> None:
    log("[19 the benchmark's cells through python -m graphinvent_tpu_torch."
        "bench, one repeat]")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        cells = [w["name"] for w in json.load(fh)["workloads"]]
    for cell in cells:
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "graphinvent_tpu_torch.bench", "--cell",
             cell, "--repeats", "1"], cwd=ROOT, capture_output=True,
            text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        if len(lines) != 1:
            log(proc.stderr[-3000:])
        check(len(lines) == 1, f"{cell}: {len(lines)} lines on stdout, not "
              "one JSON record")
        rec = json.loads(lines[0])
        for name, c in rec["checks"].items():
            log(f"    {cell} {name}: {fmt_reading(c['value'])} (bar "
                f"{fmt_reading(c['bar'])}, {c['keeps']}) "
                f"{'ok' if c['ok'] else 'FAILED'}; control "
                f"{c['control']['fault']}: "
                f"{fmt_reading(c['control']['value'])} "
                f"{'fails' if c['control']['fails'] else 'DOES NOT FAIL'}")
        log(f"    {cell} in {time.time() - t0:.1f} s: " + ", ".join(
            f"{k} {fmt_reading(m['value'])} {m['unit']}"
            for k, m in rec["metrics"].items()) + "; layers " + ", ".join(
            f"{k} {fmt_reading(m['value'])} {m['unit']}"
            for k, m in rec["layer_metrics"].items()))
        check(rec["correct"] and proc.returncode == 0,
              f"{cell}: correct is {rec['correct']} (exit {proc.returncode})")


def main() -> None:
    # the port first: without the repo around it, fail before any output
    from graphinvent_tpu_torch.config import preset
    from graphinvent_tpu_torch.models import build_model, fused_enn
    device = phase_device()
    gxx_s = phase_build(fused_enn)
    cfg = preset("GGNN", device="cuda", seed=0)
    model = build_model(cfg, torch.Generator().manual_seed(0)).to("cuda")
    model.eval()
    errs = phase_kernels(fused_enn, model, cfg)
    phase_forward(fused_enn, model, cfg)
    by_job = {"generate": phase_generate(fused_enn, cfg, model)}
    phase_sampler_alone(cfg, model)
    models = build_models(preset)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        data = phase_dataset(cfg, root)
        by_job["train"], job = phase_train(fused_enn, cfg, root, data)
        phase_train_numerics(fused_enn, cfg, job, data)
        phase_train_timings(fused_enn, cfg, job, data)
        phase_train_graphs(fused_enn, cfg, job, data)
        by_job["test"] = phase_test(fused_enn, cfg, job, data)
        model_errs = phase_model_kernels(fused_enn, models)
        phase_model_forwards(fused_enn, models)
        model_jobs, jobs = phase_model_jobs(fused_enn, models, root, data)
        phase_model_numerics(fused_enn, models, jobs, data)
        phase_model_timings(fused_enn, models, jobs, data)
        groups = [("GGNN", main_path_sites(model), errs, by_job)]
        groups += [(tag, main_path_sites(models[tag][1]), model_errs[tag],
                    model_jobs[tag]) for tag in ("AttGGNN", "EMN",
                                                 "EMN dense")]
        timed = phase_timings(fused_enn, groups)
        pretrained = phase_pretrained(cfg, models, root, job, jobs)
        fine_tune = phase_fine_tune(fused_enn, cfg, models, root, data,
                                    pretrained)
        by_job["fine-tune"] = fine_tune["GGNN"]
        for name in ("AttGGNN", "EMN"):
            model_jobs[name]["fine-tune"] = fine_tune[name]
        tuner = phase_fine_tune_numerics(fused_enn, cfg, root, data,
                                         pretrained["GGNN"])
        phase_fine_tune_timings(tuner)
        by_job["two-phase generate"] = phase_two_phase(
            fused_enn, cfg, root, data, pretrained["GGNN"])
        phase_native(fused_enn, cfg, model, root, data, pretrained["GGNN"],
                     gxx_s)
        by_job.update(phase_checkpoints(fused_enn, cfg, root, data, job))
        camp = phase_campaign(fused_enn, root)
        timed += phase_campaign_kernels(fused_enn, camp)
        phase_moses(camp)
        phase_roofline(cfg, data, job, camp)
        phase_ab_two_phase(cfg, pretrained["GGNN"])
        by_job["fine-tune (QSAR)"] = phase_qsar_fine_tune(
            fused_enn, cfg, root, data, pretrained["GGNN"])
        phase_multi_preprocess(cfg, root, data)
        group_500 = phase_multi_train(fused_enn, cfg, root, data, job)
        phase_multi_generate(fused_enn, cfg, root, data, job, by_job)
        phase_multi_test_fine_tune(fused_enn, cfg, root, data, job,
                                   pretrained["GGNN"], by_job)
        timed += phase_timings(
            fused_enn, [group_500],
            "[16b timings at the 500-graph shapes, bf16, CUDA events, "
            "warm L2]")
        phase_multi_tools(root, data, job)
        timed += phase_mesh(fused_enn, cfg, model, root, data, job, camp,
                            pretrained["GGNN"])
        with without_h5py():
            fixture = phase_h5_fixture(root, data)
            by_job["test (.h5 fixture)"] = phase_h5_test(
                fused_enn, cfg, model, job, fixture)
            by_job["streamed epoch (.h5 fixture)"] = phase_h5_stream(
                fused_enn, cfg, job, fixture)
        phase_bench()
    print(json.dumps({"kernels": kernel_rows(timed)}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    if sys.argv[1:2] == ["--rank-job"]:
        rank_job(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--mesh-step"]:
        mesh_step_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--mesh-replay"]:
        mesh_replay_rank(sys.argv[2])
    else:
        main()
