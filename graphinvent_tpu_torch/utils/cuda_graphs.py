"""What the port's captured CUDA graphs share: the capture, the capture
stream, and the library workspaces that a capture reads.

Two layers replay captured graphs (``torch.cuda.CUDAGraph``): the
sampler's rounds (``sampling/round_graphs.py``) and the resident train
epoch's steps (``train/step_graphs.py``).  Both capture on PyTorch's one
capture stream (``torch.cuda.graph``'s), so that the library's per-stream
workspace (cuBLAS: 32 MiB a handle) that a warm-up allocates there serves
every capture of the process.

**Any drop invalidates the graphs captured before it.**  A captured cuBLAS
call reads the workspace that was live at its capture.
:func:`drop_library_workspaces` frees every workspace of the process (the
train capture drops them so that the capture stream's do not stay
allocated beside the eager step's), and :func:`workspace_drops` counts the
drops: every user of these graphs puts that count in its capture key and
captures again once it moved.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Iterator, List, Tuple

import torch

# the drops of the library's workspaces in this process
_drops = 0


def workspace_drops() -> int:
    """How many times :func:`drop_library_workspaces` ran in this process."""
    return _drops


def drop_library_workspaces() -> None:
    """Drops the cuBLAS workspaces that PyTorch keeps per (handle, stream),
    as ``torch.compile``'s CUDA graphs do around a capture: a capture made
    right after allocates its own in its private pool, and none of the
    capture stream's stays allocated beside the eager path's.  Moves
    :func:`workspace_drops`."""
    global _drops
    torch._C._cuda_clearCublasWorkspaces()
    _drops += 1


@contextlib.contextmanager
def on_capture_stream(graph: torch.cuda.CUDAGraph, device: torch.device
                      ) -> Iterator[List[torch.Tensor]]:
    """Runs the body on PyTorch's one capture stream (``torch.cuda.graph``'s),
    after the current stream's work and before what it issues next.  The
    tensors put in the yielded list are marked as used on the current
    stream, so that their memory is not handed out before it has read
    them."""
    stream = torch.cuda.graph(graph).capture_stream
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    used: List[torch.Tensor] = []
    with torch.cuda.stream(stream):
        yield used
    current.wait_stream(stream)
    for t in used:
        t.record_stream(current)


def captured(graph: torch.cuda.CUDAGraph, pool: Tuple, fn: Callable):
    """``fn()`` captured into ``graph`` on the current stream, sharing the
    memory pool in ``pool`` (empty: a pool of its own).  What
    ``torch.cuda.graph`` does, without the device-wide synchronize and
    ``empty_cache`` it runs first: ``empty_cache`` would hand back the
    blocks a fine-tune step's gradient replay reuses (0.27 s a capture on
    the H100, PERF.md).

    The mode is ``capture_error_mode="thread_local"``: a potentially unsafe
    CUDA call of another thread (the jobs' analyzer and upload workers)
    does not invalidate the capture.  A capture is per stream, so the
    kernels that autograd's device thread issues onto the captured stream
    (a backward's) are captured whatever the thread; where anything on
    the stream was left out, the capture ends in an error.

    Python's cyclic garbage collector is off during the capture: a graph
    that it frees there (one held in a reference cycle of an earlier
    fine-tuner, say) destroys its executable graph, a call that the
    capturing thread may not make, and the capture ends in an error."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(*pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(RuntimeError):   # keep fn's error
                graph.capture_end()
            raise
        graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    return out
