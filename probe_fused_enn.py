#!/usr/bin/env python3
"""Where the bf16 fused ENN kernel spends its time, on one NVIDIA GPU.

    python3 probe_fused_enn.py

Builds instrumented copies of ``graphinvent_tpu_torch/models/csrc/
fused_enn.cu`` (text edits of the source, into ``graphinvent_tpu_torch/
_build/probe/``; the shipped kernel is not touched) and runs each at the
GGNN generate job's launch shapes (preset("GGNN"), B=1000, N=13):

  base    the kernel as shipped;
  noepi   each pass returns before its epilogue (bias, SELU, stores);
  phases  clock64() per pass: MMA issue and drain, waits for weight slabs,
          epilogue; per layer: the hand-over to the next layer; per block:
          start-up and the input tile;
  span    %globaltimer per block: the kernel's span against one block's.

Then the three 1,000-row heads under clusters of 1, 2, 4 and 8 blocks.
Times are device times per launch from torch.profiler (``dev``) and CUDA
events over 20 back-to-back launches (``ev``), in ms; cycles are SM clock
cycles, averaged over passes, layers or blocks.  An edit whose anchor text
is no longer in the source stops the script: keep the anchors in step with
the kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from graphinvent_tpu_torch.models import fused_enn as fe
from graphinvent_tpu_torch.models.core import MLP

BUILD = os.path.join(fe.BUILD_DIR, "probe")
COUNTERS = ("__device__ unsigned long long g_probe[8];\nnamespace {\n\n"
            "constexpr int kMaxLayers")
READ = ("void probe_read(unsigned long long* h, unsigned long long first) {\n"
        "  cudaMemcpyFromSymbol(h, g_probe, 64);\n"
        "  unsigned long long z[8] = {first, 0, 0, 0, 0, 0, 0, 0};\n"
        "  cudaMemcpyToSymbol(g_probe, z, 64);\n}\n"
        "const char* fused_enn_error_string")


def _add(i: str, v: str) -> str:
    return f"atomicAdd(&g_probe[{i}], (unsigned long long)({v}));"


EDITS = {
    "base": [],
    "noepi": [("  // epilogue: bias + SELU in f32 on the accumulators",
               "  if (p.R > 0) return;\n  //")],
    "phases": [
        ("namespace {\n\nconstexpr int kMaxLayers", COUNTERS),
        ("  float acc[NC][32];\n",
         "  long long t0 = clock64(), tw = 0;\n  float acc[NC][32];\n"),
        ("    mbar_wait(p.full_bar + 8 * s, (it / p.stages) & 1);\n",
         "    long long ta = clock64();\n"
         "    mbar_wait(p.full_bar + 8 * s, (it / p.stages) & 1);\n"
         "    tw += clock64() - ta;\n"),
        ("  // epilogue: bias + SELU in f32 on the accumulators",
         "  long long t1 = clock64();\n"
         "  // epilogue: bias + SELU in f32 on the accumulators"),
        (" " * 35 + "acc[c][4 * j + 2 * h + 1])));\n}\n",
         "                                   acc[c][4 * j + 2 * h + 1])));\n"
         "  if (threadIdx.x % 128 == 0) { " + _add("0", "t1 - t0 - tw")
         + _add("1", "tw") + _add("2", "clock64() - t1") + _add("3", "1")
         + " }\n}\n"),
        ("  const int C = L.cluster;\n",
         "  const int C = L.cluster;\n  long long tstart = clock64();\n"),
        ("    int it = 0, syncs = 0;\n",
         "    int it = 0, syncs = 0;\n    if (threadIdx.x == 0) { "
         + _add("4", "clock64() - tstart") + _add("5", "1") + " }\n"),
        ("      if (last) break;\n",
         "      if (last) break;\n      long long ts = clock64();\n"),
        ("      ++syncs;\n",
         "      if (threadIdx.x % 128 == 0) { " + _add("6", "clock64() - ts")
         + _add("7", "1") + " }\n      ++syncs;\n"),
        ("const char* fused_enn_error_string", READ),
    ],
    "span": [
        ("namespace {\n\nconstexpr int kMaxLayers", COUNTERS),
        ("  const int C = L.cluster;\n",
         "  const int C = L.cluster;\n  unsigned long long g0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"),
        ("  if (C > 1) cluster_sync_all();\n}",
         "  if (C > 1) cluster_sync_all();\n  unsigned long long g1;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
         "  if (threadIdx.x == 0) { atomicMin(&g_probe[0], g0); "
         "atomicMax(&g_probe[1], g1); " + _add("2", "g1 - g0")
         + _add("3", "1") + " }\n}"),
        ("const char* fused_enn_error_string", READ),
    ],
}

# (name, E, rows, I, hidden, O) at preset("GGNN"), B=1000, N=13
SITES = [
    ("msg_nns", 3, 13000, 100, [250] * 4, 100),
    ("gather.att_nn", 1, 13000, 108, [250] * 4, 100),
    ("gather.emb_nn", 1, 13000, 100, [250] * 4, 100),
    ("fAddNet1", 1, 13000, 100, [500] * 4, 45),
    ("fConnNet1", 1, 13000, 100, [500] * 4, 3),
    ("fAddNet2", 1, 1000, 685, [500] * 4, 585),
    ("fConnNet2", 1, 1000, 139, [500] * 4, 39),
    ("fTermNet2", 1, 1000, 100, [500] * 4, 1),
]


def build_variants() -> dict:
    src = open(fe.SOURCE).read()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"probe: anchor of {name!r} not in the source: "
                         f"{old[:60]!r}")
            text = text.replace(old, new)
        cu = os.path.join(BUILD, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [fe._nvcc(), *fe.NVCC_FLAGS, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"probe: nvcc failed on {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"{name}.so"))
        lib.fused_enn_forward.restype = ctypes.c_int
        lib.fused_enn_forward.argtypes = [
            ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
    return libs


def launcher(lib, flat, x, out, plan):
    dims = (ctypes.c_int * len(flat.dims))(*flat.dims)
    R, E = x.shape[0], flat.E

    def call():
        err = lib.fused_enn_forward(
            1, x.data_ptr(), flat.slabs.data_ptr(), flat.b.data_ptr(),
            out.data_ptr(), R, E, len(flat.dims) - 1, dims, plan.tile_rows,
            plan.cluster, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    return call


def times(call) -> tuple:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if "wgmma" in e.key]
    dev = (sum(e.self_device_time_total for e in ks)
           / max(1, sum(e.count for e in ks)) / 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    return dev, start.elapsed_time(end) / 20


def counters(lib, call, first: int) -> list:
    h = (ctypes.c_ulonglong * 8)()
    lib.probe_read(h, first)
    call()
    torch.cuda.synchronize()
    lib.probe_read(h, first)
    return list(h)


def probe_site(libs, name, E, R, I, hidden, O, plan, variants) -> None:
    g = torch.Generator().manual_seed(len(name))
    mlps = [MLP(I, hidden, O, generator=g).cuda() for _ in range(E)]
    flat = fe.flatten_weights(fe.stacked_layers(mlps), torch.bfloat16,
                              torch.device("cuda"))
    x = torch.randn(R, I, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(E, R, O, device="cuda", dtype=torch.bfloat16)
    parts = []
    for v in variants:
        call = launcher(libs[v], flat, x, out, plan)
        dev, ev = times(call)
        parts.append(f"{v} dev {dev:.4f} ev {ev:.4f}")
        if v == "phases":
            h = counters(libs[v], call, 0)
            n = max(1, h[3])
            parts.append(
                f"cycles per pass: mma {h[0] / n:.0f}, slab wait "
                f"{h[1] / n:.0f}, epilogue {h[2] / n:.0f} ({h[3]} passes); "
                f"per layer hand-over {h[6] / max(1, h[7]):.0f}; per block "
                f"start + input {h[4] / max(1, h[5]):.0f}")
        if v == "span":
            h = counters(libs[v], call, 2**64 - 1)
            parts.append(f"kernel span {(h[1] - h[0]) / 1e3:.1f} us, block "
                         f"span {h[2] / max(1, h[3]) / 1e3:.1f} us, "
                         f"{h[3]} blocks")
    print(f"{name} tile {plan.tile_rows} cluster {plan.cluster}: "
          + " | ".join(parts), flush=True)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build_variants()
    for name, E, R, I, hidden, O in SITES:
        plan = fe.launch_plan(R, E, (I, *hidden, O))
        probe_site(libs, name, E, R, I, hidden, O, plan, list(EDITS))
    print("1,000-row heads by cluster size:", flush=True)
    for name, E, R, I, hidden, O in SITES[5:]:
        for c in (1, 2, 4, 8):
            probe_site(libs, name, E, R, I, hidden, O, fe.LaunchPlan(64, c),
                       ["base", "span"])


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_fused_enn: no CUDA device")
    main()
