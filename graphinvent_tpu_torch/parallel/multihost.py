"""Multi-process execution on ``torch.distributed``.

Counterpart of ``graphinvent_tpu/parallel/multihost.py``.  Every process
runs the same job with the coordinator's ``host:port``, the process count
and its own rank, from ``input.csv`` or the environment:

    coordinator_address | GRAPHINVENT_COORDINATOR    rank 0's host:port
    num_processes       | GRAPHINVENT_NUM_PROCESSES  process count
    process_id          | GRAPHINVENT_PROCESS_ID     this process's rank

Config fields win over the environment; ``num_processes`` 1 and
``process_id`` -1 are the fields' defaults and leave the environment's
values in force.  One process per card: rank p takes
``cuda:{p % device_count}``.

The process group's backend follows the device, ``nccl`` on ``cuda`` and
``gloo`` on ``cpu`` (the JAX package switches its CPU collectives to gloo
the same way), unless ``GRAPHINVENT_DIST_BACKEND`` names one.  NCCL refuses
two ranks on one card, so a machine with one card runs two ranks with
``GRAPHINVENT_DIST_BACKEND=gloo``; :func:`init_distributed` raises when
``nccl`` would put two ranks on one card and never switches by itself.

Host objects (packed sample bytes, the barriers of preprocessing, the
checkpoint's epoch) go through a ``gloo`` group made beside the default
one, so they never need the card's backend: the counterparts of
``multihost_utils.process_allgather``, ``broadcast_one_to_all`` and
``sync_global_devices``.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from graphinvent_tpu_torch.config import GraphInventConfig

BACKENDS = ("nccl", "gloo")
# set in the environment of ranks that ``main`` starts as the members of
# one process's mesh
ONE_PROCESS_MESH = "GRAPHINVENT_ONE_PROCESS_MESH"
# a rank that raises leaves its peers waiting in a collective: after this
# long they raise too (an evaluation on rank 0 runs while the others wait)
TIMEOUT = datetime.timedelta(minutes=30)

# the gloo group of the host collectives; set by init_distributed
_host_group = None


def _env(name: str) -> Optional[str]:
    v = os.environ.get(name)
    return v if v not in ("", None) else None


def distributed_settings(cfg: GraphInventConfig
                         ) -> Optional[Tuple[str, int, int]]:
    """-> (coordinator, process count, rank) of a multi-process job, or
    None for one process.  A count above 1 without a coordinator raises:
    such a job would otherwise run alone and quietly."""
    coord = cfg.coordinator_address or _env("GRAPHINVENT_COORDINATOR")
    nproc = (cfg.num_processes if cfg.num_processes > 1
             else int(_env("GRAPHINVENT_NUM_PROCESSES") or 1))
    pid = (cfg.process_id if cfg.process_id >= 0
           else int(_env("GRAPHINVENT_PROCESS_ID") or 0))
    if nproc <= 1:
        return None
    if not coord:
        raise ValueError(
            f"num_processes={nproc} needs the coordinator's host:port "
            "(coordinator_address in input.csv or GRAPHINVENT_COORDINATOR)")
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id={pid} is not a rank of {nproc} "
                         "processes")
    return coord, nproc, pid


def dist_backend(cfg: GraphInventConfig) -> str:
    name = _env("GRAPHINVENT_DIST_BACKEND") or (
        "nccl" if cfg.device == "cuda" else "gloo")
    if name not in BACKENDS:
        raise ValueError(f"GRAPHINVENT_DIST_BACKEND must be one of "
                         f"{BACKENDS}, got {name!r}")
    if name == "nccl" and cfg.device != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    return name


def rank_device(cfg: GraphInventConfig, pid: int) -> torch.device:
    """Rank ``pid``'s device: ``cuda:{pid % device_count}`` or the CPU."""
    if cfg.device != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but PyTorch sees no CUDA device; "
                           "set device='cpu' to run on the CPU")
    return torch.device("cuda", pid % torch.cuda.device_count())


def init_distributed(cfg: GraphInventConfig) -> bool:
    """Joins this process to the job's process group when more than one
    process is configured; -> True iff it did (or had).  One process: a
    no-op returning False."""
    settings = distributed_settings(cfg)
    if settings is None:
        return False
    coord, nproc, pid = settings
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (nproc, pid):
            raise RuntimeError(
                f"already rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for {pid} of {nproc}")
        return True
    join_group(coord, nproc, pid, dist_backend(cfg), rank_device(cfg, pid))
    return True


def join_group(coord: str, nproc: int, pid: int, backend: str,
               device: torch.device) -> None:
    """Rank ``pid`` of ``nproc`` joins the group at ``coord`` on
    ``backend``, with ``device`` as its card (any group size: a measuring
    tool may make a group of one), and makes the gloo group of the host
    collectives beside it."""
    global _host_group
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            rank=pid, world_size=nproc, timeout=TIMEOUT)
    _host_group = dist.new_group(backend="gloo", timeout=TIMEOUT)
    if backend == "nccl":
        # before any NCCL collective: two ranks on one card would fail
        # there with "Duplicate GPU detected"
        shared = shared_cards(all_gather_objects(
            (socket.gethostname(), device.index)))
        if shared:
            shutdown()
            raise RuntimeError(
                f"nccl would put two ranks on one card {shared}: give each "
                "rank a card of its own, or set "
                "GRAPHINVENT_DIST_BACKEND=gloo")
    print(f"* Process group: rank {pid} of {nproc}, backend {backend}, "
          f"device {device}", flush=True)


def shared_cards(where: Sequence[Tuple[str, int]]) -> List[Tuple[str, int]]:
    """The (host, card) pairs that more than one rank would use."""
    return sorted({w for w in where if list(where).count(w) > 1})


def shutdown() -> None:
    """Leaves the process group (safe to call without one)."""
    global _host_group
    _host_group = None
    if dist.is_initialized():
        dist.destroy_process_group()


def check_process_group(cfg: GraphInventConfig) -> None:
    """A config that asks for several processes must run in a group of
    that many (``main`` makes it): alone, the job would run quietly on one
    process."""
    if cfg.num_processes > 1 and cfg.num_processes != process_count():
        raise RuntimeError(
            f"num_processes={cfg.num_processes}, but this process is in a "
            f"group of {process_count()}: launch each rank through "
            "graphinvent_tpu_torch.main with coordinator_address, "
            "num_processes and process_id (parallel/multihost.py)")


def jax_process_count() -> int:
    """The processes of the JAX job this group stands for: 1 when ``main``
    started the ranks as one process's mesh (``ONE_PROCESS_MESH`` set in
    their environment), else the ranks.  The JAX package's workflow
    branches on its process count, which ranks alone cannot tell."""
    return 1 if _env(ONE_PROCESS_MESH) else process_count()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def global_steps_per_epoch(n_rows: int, local_batch: int, block_size: int,
                           num_shards: int, drop_last: bool = False) -> int:
    """Per-epoch step count every host can agree on without communicating:
    the minimum over all shards' batch counts for the round-robin block
    layout of ``BlockLoader`` (data/loader.py:77-92)."""
    n_blocks = (n_rows + block_size - 1) // block_size
    counts = []
    for shard in range(num_shards):
        total = 0
        for b in range(shard, n_blocks, num_shards):
            rows = min((b + 1) * block_size, n_rows) - b * block_size
            total += rows // local_batch if drop_last else \
                (rows + local_batch - 1) // local_batch
        counts.append(total)
    return min(counts) if counts else 0


# --------------------------------------------------------------------------
# host collectives (the gloo group)
# --------------------------------------------------------------------------

def barrier() -> None:
    """Waits for every process (``sync_global_devices``)."""
    dist.barrier(group=_host_group)


def all_gather_bytes(a: np.ndarray) -> np.ndarray:
    """(...) array of the same shape and type on every process -> (P, ...),
    in rank order (``process_allgather``).  It travels as its bytes, so
    any numpy type goes (the sparse APD wire's uint16 indices too)."""
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_host_group)
    return torch.stack(out).numpy().view(a.dtype).reshape(
        (len(out),) + a.shape)


def all_gather_objects(obj: Any) -> List[Any]:
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every process (``broadcast_one_to_all``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


# --------------------------------------------------------------------------
# device collectives (the default group)
# --------------------------------------------------------------------------

def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sums each tensor over the processes, in place, as one flat buffer:
    one collective however many tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int = 0
                       ) -> None:
    """Rank ``src``'s values into each tensor on every process, in place."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
