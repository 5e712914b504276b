"""Fused SELU-MLP tower stack: the hand-written Hopper kernel and its plain
version.

Counterpart of ``graphinvent_tpu/models/fused_enn.py``, whose Pallas TPU
kernel (``_kernel``/``_call``) runs every layer of E SELU MLPs for a tile of
rows with the intermediates on chip.  Here the kernel is CUDA C++ for
``sm_90a`` (``csrc/fused_enn.cu``; its header says what bounds it and how
the design answers that), built with ``nvcc`` at first use into
``graphinvent_tpu_torch/_build/`` and called through ``ctypes``.  In bf16
it runs ``wgmma`` on weight slabs that :func:`slab_image` lays out once per
model; :func:`launch_plan` picks its row tile and thread-block cluster.

Numerics, as the TPU kernel's: dots take the compute dtype with f32
accumulation; the bias, pre-rounded to the compute dtype, and SELU run in
f32; the result is rounded to the compute dtype between layers.  In f32
this matches ``core.stacked_mlp`` to summation order; in bf16 it differs
from ``core`` in low bits (``core`` rounds before the bias and SELU).

Dispatch (:func:`fused_stacked_mlp`, :func:`fused_mlp`): a CUDA tensor
launches the kernel or raises; a CPU tensor takes
:func:`fused_stacked_mlp_reference`; any other device raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import (
    Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple,
)

import torch

from graphinvent_tpu_torch.models.core import (
    MLP, SELU_ALPHA, SELU_SCALE, stacked_layers,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "models", "csrc", "fused_enn.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LAYERS = 8                     # kMaxLayers in the CUDA source
# the bf16 kernel's geometry, as in the CUDA source
CHUNK = 64                         # output columns per wgmma, K per slab
MAX_CHUNKS = 4                     # chunks per pass over K
MAX_STAGES = 8                     # weight ring
# cluster size the plan goes up to: the kernel takes 2, 4 or 8, but on the
# H100 16 clusters of 8 blocks with ~200 KB of shared memory each do not
# all fit on the card at once and run in two waves, 4 fit (PERF.md)
MAX_CLUSTER = 4
MAX_SMEM = 232448                  # shared memory a block may use
MIN_BLOCKS = 100                   # a plan fills at least this many blocks
_BARRIER_BYTES = 8 * (2 * MAX_STAGES + 2)
_BIAS_BYTES = 2 * MAX_CHUNKS * CHUNK * 2       # a pass's biases, bf16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel, per wrapper, per weight layout (E, I, ..., O) and
# per (layout, rows); a replay of a captured CUDA graph adds what its
# capture recorded (:func:`credit_launches`)
LAUNCHES: Dict[str, int] = {"fused_stacked_mlp": 0, "fused_mlp": 0}
LAUNCHES_BY_LAYOUT: Dict[Tuple[int, ...], int] = {}
LAUNCHES_BY_SHAPE: Dict[Tuple[Tuple[int, ...], int], int] = {}

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_LAYOUT.clear()
    LAUNCHES_BY_SHAPE.clear()


Counts = Tuple[Dict, Dict, Dict]


def launch_counts(since: Optional[Counts] = None) -> Counts:
    """A copy of the three counters (by wrapper, by layout, by shape), or,
    given such a copy, what each gained since (counts that did not move
    left out)."""
    now = dict(LAUNCHES), dict(LAUNCHES_BY_LAYOUT), dict(LAUNCHES_BY_SHAPE)
    if since is None:
        return now
    return tuple({k: v - old.get(k, 0) for k, v in new.items()
                  if v != old.get(k, 0)} for new, old in zip(now, since))


def credit_launches(delta: Counts) -> None:
    """Counts the launches of one replay of a captured CUDA graph: what
    its capture recorded (``delta``, as ``launch_counts(since=...)`` gives
    it; ``sampling/round_graphs.py``)."""
    for live, gained in zip((LAUNCHES, LAUNCHES_BY_LAYOUT, LAUNCHES_BY_SHAPE),
                            delta):
        for k, v in gained.items():
            live[k] = live.get(k, 0) + v


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Launches inside add nothing to the counters: those of a graph's
    warm-up or refresh are no replay's, and a capture launches nothing
    (``credit_launches`` counts each replay)."""
    before = launch_counts()
    try:
        yield
    finally:
        for live, saved in zip((LAUNCHES, LAUNCHES_BY_LAYOUT,
                                LAUNCHES_BY_SHAPE), before):
            live.clear()
            live.update(saved)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the fused ENN kernel is built from "
                       f"{SOURCE} with the CUDA toolkit")


def build_library() -> str:
    """Compiles the kernel (if this source is not built yet) and returns
    the shared library's path.  Raises on any build failure."""
    global BUILD_LOG
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libfused_enn_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.fused_enn_forward.restype = ctypes.c_int
            lib.fused_enn_forward.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.fused_enn_error_string.restype = ctypes.c_char_p
            lib.fused_enn_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

class FlatWeights(NamedTuple):
    """Every layer's weights for the kernel: per layer, (E, Kp, Op)
    transposed weights zero-padded to multiples of 16, back to back in
    ``w`` (the plain version and the f32 kernel read them); (E, Op) f32
    biases rounded through the compute dtype in ``b``; in bf16, the wgmma
    kernel's shared-memory image of every layer in ``slabs``
    (:func:`slab_image`), None in f32."""
    w: torch.Tensor
    b: torch.Tensor
    dims: Tuple[int, ...]          # I, O_0, ..., O_{n-1} (true widths)
    E: int
    slabs: Optional[torch.Tensor] = None

    @property
    def layout(self) -> Tuple[int, ...]:
        return (self.E, *self.dims)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _pad64(n: int) -> int:
    return -(-n // CHUNK) * CHUNK


def _swizzle_index() -> torch.Tensor:
    """(64, 8) index: in a K-major 128-byte-swizzled tile, row n keeps its
    16-byte group g at position g ^ (n % 8).  XOR is its own inverse, so the
    same gather swizzles and unswizzles."""
    n = torch.arange(CHUNK)[:, None] % 8
    return torch.arange(8)[None, :] ^ n


def swizzle_tiles(t: torch.Tensor) -> torch.Tensor:
    """Swizzles (or unswizzles) the last two dims (64, 64) of ``t``."""
    lead = t.shape[:-2]
    g = t.reshape(*lead, CHUNK, 8, 8)
    rows = torch.arange(CHUNK)[:, None]
    return g[..., rows, _swizzle_index(), :].reshape(*lead, CHUNK, CHUNK)


def slab_image(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One layer's weights (E, O, K) as the wgmma kernel's shared-memory
    image, flattened: (E, K-slabs, column chunks, 64 output columns, 64 K)
    with each 64 x 64 tile K-major in the 128-byte swizzle, zero-padded to
    multiples of 64.  The chunks of one K-slab lie back to back, so any run
    of them is one bulk copy."""
    E, O, K = w.shape
    wp = torch.zeros(E, _pad64(O), _pad64(K), dtype=dtype, device=w.device)
    wp[:, :O, :K] = w.to(dtype)
    tiles = wp.reshape(E, -1, CHUNK, wp.shape[2] // CHUNK, CHUNK)
    tiles = tiles.permute(0, 3, 1, 2, 4)       # (E, nk, nch, 64 n, 64 k)
    return swizzle_tiles(tiles).reshape(-1)


class LaunchPlan(NamedTuple):
    """How the bf16 kernel covers the rows: ``tile_rows`` rows a block (one
    warpgroup per 64), ``cluster`` blocks sharing each row tile."""
    tile_rows: int
    cluster: int


def smem_plan(dims: Sequence[int], plan: LaunchPlan
              ) -> Optional[Tuple[int, int]]:
    """(shared-memory bytes, ring stages) of the bf16 kernel under ``plan``,
    as ``plan_smem`` in the CUDA source computes them; None if fewer than 2
    stages fit.  Buffer 0 holds the input and odd layers' outputs, buffer 1
    even layers'; the last layer's output goes straight to device memory.
    Where the whole input tile leaves no room for 2 stages, a 64-row tile
    streams layer 0's input by 64-column K-slabs through two halves of
    buffer 0."""
    fits = _smem_plan(dims, plan, False)
    if fits is None and plan.tile_rows == 64:
        return _smem_plan(dims, plan, True)
    return fits


def _smem_plan(dims: Sequence[int], plan: LaunchPlan, stream_in: bool
               ) -> Optional[Tuple[int, int]]:
    pads = [_pad64(d) for d in dims]
    n = len(dims) - 1
    width = [2 * CHUNK if stream_in else pads[0], 0]
    for l in range(n - 1):
        width[(l + 1) % 2] = max(width[(l + 1) % 2], pads[l + 1])
    chunks = max(min(MAX_CHUNKS, -(-(p // CHUNK) // plan.cluster))
                 for p in pads[1:])
    stage = chunks * CHUNK * CHUNK * 2
    fixed = (plan.tile_rows * (width[0] + width[1]) * 2 + _BARRIER_BYTES
             + _BIAS_BYTES + 1024)
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // stage)
    if stages < 2:
        return None
    return fixed + stages * stage, stages


@functools.lru_cache(maxsize=256)
def launch_plan(R: int, E: int, dims: Tuple[int, ...]) -> LaunchPlan:
    """The bf16 kernel's plan for R rows of E towers: 128-row tiles where
    they fit in shared memory and still fill MIN_BLOCKS blocks (half the
    weight traffic per row of 64-row tiles); else 64-row tiles, shared by a
    cluster of up to MAX_CLUSTER blocks, each computing its share of every
    layer's columns, until the grid fills MIN_BLOCKS blocks.  Deterministic
    in its arguments."""
    rows128 = -(-R // 128) * E
    if rows128 >= MIN_BLOCKS and smem_plan(dims, LaunchPlan(128, 1)):
        return LaunchPlan(128, 1)
    tiles, cluster = -(-R // 64) * E, 1
    while cluster < MAX_CLUSTER and tiles * cluster < MIN_BLOCKS:
        cluster *= 2
    if smem_plan(dims, LaunchPlan(64, cluster)) is None:
        raise ValueError(f"layer widths {tuple(dims)} do not fit the "
                         "kernel's shared memory")
    return LaunchPlan(64, cluster)


def plan_choices(dims: Sequence[int]) -> List[LaunchPlan]:
    """The two kinds of plan for these widths: without a cluster (128-row
    tiles where they fit) and with the plan's largest cluster."""
    single = LaunchPlan(128, 1)
    if smem_plan(dims, single) is None:
        single = LaunchPlan(64, 1)
    return [single, LaunchPlan(64, MAX_CLUSTER)]


def flatten_weights(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    dtype: torch.dtype, device: torch.device) -> FlatWeights:
    """``layers``: per layer ((E, O, I) weight, (E, O) bias), as
    :func:`core.stacked_layers` gives them."""
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers, "
                         f"got {len(layers)}")
    E = layers[0][0].shape[0]
    dims = [layers[0][0].shape[2]]
    ws, bs, slabs = [], [], []
    with torch.no_grad():
        for w, b in layers:
            _, O, K = w.shape
            if K != dims[-1]:
                raise ValueError(f"layer input {K} != previous width "
                                 f"{dims[-1]}")
            wt = torch.zeros(E, _pad16(K), _pad16(O), dtype=dtype,
                             device=device)
            wt[:, :K, :O] = w.detach().to(device).transpose(1, 2).to(dtype)
            bp = torch.zeros(E, _pad16(O), dtype=torch.float32, device=device)
            bp[:, :O] = b.detach().to(device).to(dtype).float()
            ws.append(wt.reshape(-1))
            bs.append(bp.reshape(-1))
            if dtype == torch.bfloat16:
                slabs.append(slab_image(w.detach().to(device), dtype))
            dims.append(O)
    return FlatWeights(torch.cat(ws), torch.cat(bs), tuple(dims), E,
                       torch.cat(slabs) if slabs else None)


def _layer_views(flat: FlatWeights):
    """(E, K, O) weight and (E, O) bias views of each layer, unpadded."""
    w_off = b_off = 0
    for K, O in zip(flat.dims[:-1], flat.dims[1:]):
        Kp, Op = _pad16(K), _pad16(O)
        w = flat.w[w_off:w_off + flat.E * Kp * Op].view(flat.E, Kp, Op)
        b = flat.b[b_off:b_off + flat.E * Op].view(flat.E, Op)
        w_off += flat.E * Kp * Op
        b_off += flat.E * Op
        yield w[:, :K, :O], b[:, :O]


def _cached_flat(owner: torch.nn.Module, mlps: Sequence[torch.nn.Module],
                 dtype: torch.dtype, device: torch.device,
                 layers=None) -> FlatWeights:
    """Flattens once per model, dtype and device; rebuilt only when a
    parameter is replaced or modified in place (parameters made under
    ``inference_mode`` track no version: replace those, do not edit them).
    After an edit in place (only versions moved) the new values go into
    the same tensors, which a captured CUDA graph may read
    (``sampling/round_graphs.py``).  ``layers``: a function giving the
    layers to flatten, by default the towers of ``mlps`` stacked."""
    params = [p for m in mlps for p in m.parameters()]
    where = tuple((p.data_ptr(), tuple(p.shape)) for p in params)
    versions = tuple(-1 if p.is_inference() else p._version for p in params)
    key = (dtype, device, where, versions)
    cached = owner.__dict__.get("_fused_flat")
    if cached is None or cached[0] != key:
        made = layers() if layers is not None else stacked_layers(mlps)
        flat = flatten_weights(made, dtype, device)
        if cached is not None and cached[0][:3] == key[:3]:
            with torch.inference_mode():    # the tensors may be inference's
                for old, new in zip(cached[1], flat):
                    if isinstance(old, torch.Tensor):
                        old.copy_(new)
            flat = cached[1]
        cached = (key, flat)
        owner.__dict__["_fused_flat"] = cached
    return cached[1]


def cached_flats(model: torch.nn.Module) -> List[FlatWeights]:
    """The flattened weights that ``model``'s kernel sites hold now: what
    a CUDA graph captured on a hit of :func:`_cached_flat` reads, and must
    keep alive."""
    return [m.__dict__["_fused_flat"][1] for m in model.modules()
            if "_fused_flat" in m.__dict__]


# --------------------------------------------------------------------------
# the plain version and the kernel
# --------------------------------------------------------------------------

def _selu_f32(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x > 0, x, SELU_ALPHA * (torch.exp(x) - 1.0))


def fused_stacked_mlp_reference(flat: FlatWeights, x2d: torch.Tensor
                                ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: x2d (R, I) -> (E, R, O)."""
    dt = x2d.dtype
    y = x2d.unsqueeze(0).expand(flat.E, -1, -1)
    layers = list(_layer_views(flat))
    for l, (w, b) in enumerate(layers):
        a = torch.bmm(y.float(), w.float()) + b[:, None, :]
        a = _selu_f32(a)
        y = a if l == len(layers) - 1 else a.to(dt)
    return y.to(dt)


def fused_enn_cuda(flat: FlatWeights, x2d: torch.Tensor,
                   plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """Launches the kernel on the current stream: x2d (R, I) -> (E, R, O).
    bf16 runs under ``plan``, by default :func:`launch_plan`'s."""
    if x2d.device.type != "cuda" or flat.w.device != x2d.device:
        raise ValueError("fused_enn_cuda needs x and weights on one CUDA "
                         f"device, got {x2d.device} and {flat.w.device}")
    if x2d.dtype not in _DTYPE_CODE or flat.w.dtype != x2d.dtype:
        raise TypeError(f"fused_enn_cuda takes float32 or bfloat16 x with "
                        f"weights of the same dtype, got {x2d.dtype} and "
                        f"{flat.w.dtype}")
    R, I = x2d.shape
    if I != flat.dims[0]:
        raise ValueError(f"x has {I} features, the weights take "
                         f"{flat.dims[0]}")
    if not (x2d.is_contiguous() and flat.w.is_contiguous()
            and flat.b.is_contiguous()):
        raise ValueError("fused_enn_cuda needs contiguous tensors")
    out = torch.empty(flat.E, R, flat.dims[-1], dtype=x2d.dtype,
                      device=x2d.device)
    if R == 0:
        return out
    w = flat.w
    if x2d.dtype == torch.bfloat16:
        w = flat.slabs
        plan = plan or launch_plan(R, flat.E, flat.dims)
    else:
        plan = LaunchPlan(0, 0)
    lib = _library()
    dims = (ctypes.c_int * len(flat.dims))(*flat.dims)
    err = lib.fused_enn_forward(
        _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), w.data_ptr(),
        flat.b.data_ptr(), out.data_ptr(), R, flat.E, len(flat.dims) - 1,
        dims, plan.tile_rows, plan.cluster,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused ENN kernel launch failed: "
                           + lib.fused_enn_error_string(err).decode())
    return out


def _dispatch(flat: FlatWeights, x2d: torch.Tensor, wrapper: str
              ) -> torch.Tensor:
    if x2d.device.type == "cuda":
        out = fused_enn_cuda(flat, x2d.contiguous())
        LAUNCHES[wrapper] += 1
        LAUNCHES_BY_LAYOUT[flat.layout] = (
            LAUNCHES_BY_LAYOUT.get(flat.layout, 0) + 1)
        shape = (flat.layout, x2d.shape[0])
        LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
        return out
    if x2d.device.type == "cpu":
        return fused_stacked_mlp_reference(flat, x2d)
    raise RuntimeError(f"no fused ENN kernel for device {x2d.device}")


def fused_stacked_mlp(mlps: torch.nn.ModuleList, x: torch.Tensor
                      ) -> torch.Tensor:
    """Inference-path drop-in for ``core.stacked_mlp``: x (B, N, I) ->
    (E, B, N, O)."""
    B, N, I = x.shape
    flat = _cached_flat(mlps, list(mlps), x.dtype, x.device)
    out = _dispatch(flat, x.reshape(B * N, I), "fused_stacked_mlp")
    return out.reshape(flat.E, B, N, -1)


def fused_mlp(module: MLP, x: torch.Tensor) -> torch.Tensor:
    """Inference-path drop-in for ``core.mlp``: one MLP (E=1) over any
    leading dims, x (..., I) -> (..., O)."""
    lead = x.shape[:-1]
    flat = _cached_flat(module, [module], x.dtype, x.device)
    out = _dispatch(flat, x.reshape(-1, x.shape[-1]), "fused_mlp")
    return out.reshape(*lead, out.shape[-1])


def fused_layer(lin: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """One SELU layer (E=1, one layer) on the kernel, x (..., I) -> (...,
    O): a rank's slice of a layer of the APD head split over the model
    axis (``models/readout._split_mlp``).  The weights are cached on the
    slice's own module, so each slice keeps its own."""
    lead = x.shape[:-1]
    flat = _cached_flat(lin, [lin], x.dtype, x.device, layers=lambda: [
        (lin.weight[None], lin.bias[None])])
    out = _dispatch(flat, x.reshape(-1, x.shape[-1]), "fused_mlp")
    return out.reshape(*lead, out.shape[-1])


def fused_gate(cfg, train: bool) -> bool:
    """True when a forward may take the fused path: the config allows it,
    the forward is an eval forward and autograd is off (the kernel has no
    backward; training keeps ``core``, as in the JAX package)."""
    return (bool(cfg.fused_inference_enn) and not train
            and not torch.is_grad_enabled())
