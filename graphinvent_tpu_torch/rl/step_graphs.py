"""The fine-tune step's replays as captured CUDA graphs.

The JAX package compiles a fine-tune step into three programs
(``graphinvent_tpu/rl/workflow_rl.py``): the forward-only replay that gives
the prior's and the best agent's likelihoods (``_make_loglik``, an L-step
``lax.scan``), the agent's gradient replay (``_make_rl_grad``:
``value_and_grad`` over two rematerialised scans) and Adam
(``_make_adam``).  The port's eager step issues each of their launches
from Python.  Here, on a CUDA device with one process and no mesh (the
resident train epoch's rule, ``train/step_graphs.replays_steps``), for a
model without hooks (``train/step_graphs.keeps_eager_step``), both are
replays of captured CUDA graphs (``torch.cuda.CUDAGraph``) on static
buffers:

* **The forward-only replay** (:class:`LoglikGraphs`): one replay step
  (``sampling/replay.replay_step``: the forward through the fused kernel,
  the log-softmax, the chosen rows, the decode, the actions applied) is
  one graph, with the step index on the device.  The host uploads the
  actions and counts, zeroes the carry and replays the graph ``stop``
  times, ``stop`` taken from the host's counts, so nothing is read back
  before the sums.  The per-trajectory sums are the eager replay's bit for
  bit.  One entry a model (the prior; the BASF), keyed on what a replay
  cannot follow (:func:`loglik_key`): every parameter's and buffer's
  address, shape, dtype and version, the model's and the job's ``cfg``,
  the batch's shape, the modes and the library workspaces' drops.  A new
  BASF (``frozen_copy``) is a new model and captures once; the entry of a
  model that is gone (a weak reference) is dropped at the next lookup.
  Each replay credits the launches its capture recorded.
* **The gradient replay and Adam** (:class:`GradGraphs`): three graphs
  replayed back to back, so that the step's CUDA-event marks keep their
  pieces: the two rematerialised replays and the loss (``rl_loss``), its
  backward, and ``Adam.apply`` on the scalars staged from the host's
  OneCycle (``Adam.stage``).  Both replays run ``P`` steps, ``P`` the
  longer replay's ``stop`` rounded up to a multiple of :data:`BUCKET` (at
  most L).  A step past every row's count is inert: it adds +0 to each sum
  and sends zero gradients back, and autograd sums a parameter's gradient
  in the order its uses come back (the later steps first), so the loss and
  every gradient leaf are the eager replay's up to the sign of a zero.
  One entry a bucket, every bucket's graphs in one memory pool (they never
  run at once; each reads only its own work and the static buffers).  The
  key (:func:`grad_key`) holds the agent (by identity), every parameter's,
  buffer's and moment's address, shape and dtype, the ``cfg``s, Adam's
  constants, the batch's shape, the modes and the drops; a new key drops
  every bucket.  Versions are not in it: the graphs read the weights at
  their addresses, so an edit in place is followed.
* **Capture**: each begins with a warm-up, the same work run eagerly on
  PyTorch's capture stream (``utils/cuda_graphs.py``): the library's
  handles and workspaces of the main and the autograd thread on that
  stream, the kernel's build and flattened weights.  The gradient
  warm-up's gradients are dropped and Adam does not run, so a warm-up
  changes nothing.  The library's workspaces are not dropped: the
  sampler's rounds captured before stay valid.  The capture mode is
  ``thread_local`` (``cuda_graphs.captured``): the scoring worker's torch
  work on the card (the QSAR scorer) does not invalidate it.
* **Version counters**: Adam's replay moves no counter; after it every
  parameter's and moment's counter is moved
  (``train/step_graphs.mark_updated``), so the fused kernel's weight cache
  and the agent's sampler round (its refresh) read the new weights.
* **Memory**: the graphs' work lives in their private pools (reserved, not
  allocated); after a capture no ``.grad`` refers to the graphs'
  gradients, which the entry keeps.

Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.sampling.replay import initial_carry, replay_step
from graphinvent_tpu_torch.train.optim import SCALARS, Adam
from graphinvent_tpu_torch.train.step_graphs import _where, mark_updated
from graphinvent_tpu_torch.utils import cuda_graphs

# forward-only entries kept: the prior's, the BASF's, and a replaced BASF's
# until its model is gone
MAX_ENTRIES = 4
# the gradient replay runs the longer replay's steps rounded up to this
BUCKET = 4

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def bucket(stop: int, length: int) -> int:
    """The gradient replay's steps for a longest replay of ``stop``."""
    return min(length, max(1, math.ceil(stop / BUCKET)) * BUCKET)


def _modes(model: nn.Module) -> Tuple[bool, bool, bool]:
    return (model.training, torch.is_grad_enabled(),
            torch.is_inference_mode_enabled())


def _upload(dst: torch.Tensor, array: np.ndarray) -> None:
    """A host array into a static buffer, queued on the stream without
    waiting for the device (a pinned buffer, as ``Adam.stage``'s)."""
    src = torch.from_numpy(np.ascontiguousarray(array)).to(dst.dtype)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


# --------------------------------------------------------------------------
# the forward-only replay
# --------------------------------------------------------------------------

class LoglikKey(NamedTuple):
    """What a forward-only replay step's Python side reads."""
    weights: Tuple          # (data_ptr, shape, dtype) per tensor
    versions: Tuple         # each tensor's version (-1: an inference tensor)
    model_cfg: Any
    cfg: Any
    shape: Tuple[int, int]  # the actions' (B, L)
    device: torch.device
    modes: Tuple[bool, bool, bool]   # training, grad, inference mode
    workspaces: int         # ``cuda_graphs.workspace_drops()``


def loglik_key(cfg: Any, model: nn.Module, shape: Tuple[int, int],
               device: torch.device) -> LoglikKey:
    """The capture key of ``model``'s forward-only replay step."""
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    return LoglikKey(
        _where(tensors),
        tuple(-1 if t.is_inference() else t._version for t in tensors),
        getattr(model, "cfg", None), cfg, tuple(shape), device,
        _modes(model), cuda_graphs.workspace_drops())


class _ReplayState(NamedTuple):
    actions: torch.Tensor   # (B, L) long
    t_counts: torch.Tensor  # (B,) long
    step: torch.Tensor      # () long, the next step's index
    acc: torch.Tensor
    nodes: torch.Tensor
    edges: torch.Tensor
    n_nodes: torch.Tensor


class _Loglik:
    """One captured replay step: its graph, the state it acts on, the
    launches of one replay, and what it reads that must stay alive."""

    def __init__(self, model, key, state, graph, launches, keep) -> None:
        self.model = weakref.ref(model)
        self.key, self.state, self.graph = key, state, graph
        self.launches, self.keep = launches, keep


def _call(model, nodes, edges):
    return model(nodes, edges)


class LoglikGraphs:
    """The forward-only replays of a fine-tune job, one entry a model (at
    most :data:`MAX_ENTRIES`, the newest last)."""

    def __init__(self) -> None:
        self.entries: List[_Loglik] = []
        self.captures = self.replays = 0

    def loglik(self, cfg: Any, model: nn.Module, actions: np.ndarray,
               t_counts: np.ndarray, stop: int, device: torch.device
               ) -> np.ndarray:
        """(B,) float32 on the host: ``sampling/replay.trajectory_loglik``
        of the trajectories under ``model``, ``stop`` replays of one
        captured step."""
        with torch.inference_mode():
            entry = self._entry(cfg, model, actions.shape, device)
            st = entry.state
            _upload(st.actions, actions)
            _upload(st.t_counts, t_counts)
            for t in st[2:]:
                t.zero_()
            for _ in range(stop):
                entry.graph.replay()
                fused_enn.credit_launches(entry.launches)
            self.replays += stop
            return st.acc.to("cpu", copy=True).numpy()

    def _entry(self, cfg, model, shape, device) -> _Loglik:
        key = loglik_key(cfg, model, shape, device)
        self.entries = [e for e in self.entries if e.model() is not None]
        for e in self.entries:
            if e.model() is model and e.key == key:
                return e
        live = [e for e in self.entries if e.model() is not model
                and e.key.workspaces == key.workspaces]
        entry = self._capture(cfg, model, shape, device, key)
        self.entries = (live + [entry])[-MAX_ENTRIES:]
        return entry

    def _capture(self, cfg, model, shape, device, key) -> _Loglik:
        B, L = shape
        st = _ReplayState(
            torch.zeros(B, L, dtype=torch.long, device=device),
            torch.zeros(B, dtype=torch.long, device=device),
            torch.zeros((), dtype=torch.long, device=device),
            *initial_carry(cfg, B, device))

        held = weakref.ref(model)   # the step keeps no replaced BASF alive

        def step() -> None:
            carry = replay_step(cfg, _call, held(), st.actions, st.t_counts,
                                st.step, *st[3:])
            for buf, value in zip(st[3:], carry):
                buf.copy_(value)
            st.step.add_(1)

        graph = torch.cuda.CUDAGraph()
        with cuda_graphs.on_capture_stream(graph, device), \
                fused_enn.uncounted():
            step()      # the warm-up: the kernel's build, flattened weights
            before = fused_enn.launch_counts()
            cuda_graphs.captured(graph, (), step)
            launches = fused_enn.launch_counts(since=before)
        self.captures += 1
        keep = (fused_enn.cached_flats(model),
                [t.detach() for t in itertools.chain(model.parameters(),
                                                     model.buffers())])
        return _Loglik(model, key, st, graph, launches, keep)


# --------------------------------------------------------------------------
# the gradient replay and Adam
# --------------------------------------------------------------------------

class GradKey(NamedTuple):
    """What the gradient replay's and Adam's Python side reads."""
    model: int              # the agent's identity
    weights: Tuple          # (data_ptr, shape, dtype) per tensor
    model_cfg: Any
    cfg: Any
    adam: Tuple[float, float]       # beta2, eps
    shape: Tuple[int, int]  # the actions' (B, L)
    modes: Tuple[bool, bool, bool]
    workspaces: int


def grad_key(cfg: Any, model: nn.Module, adam: Adam,
             shape: Tuple[int, int]) -> GradKey:
    """The capture key of the gradient replay (:class:`GradKey`)."""
    return GradKey(
        id(model),
        _where(itertools.chain(model.parameters(), model.buffers(),
                               adam.params, adam.mu, adam.nu)),
        getattr(model, "cfg", None), cfg, (adam.beta2, adam.eps),
        tuple(shape), _modes(model), cuda_graphs.workspace_drops())


class _GradBuffers(NamedTuple):
    batches: Tuple[torch.Tensor, ...]   # actions, t_counts, target, mask x 2
    scalars: torch.Tensor               # Adam's (len(SCALARS),)


class _Grad(NamedTuple):
    """One bucket's graphs (the forward's, the backward's, Adam's) and
    what they leave: the loss (``value``) and the gradients (``grads``)."""
    graphs: List[torch.cuda.CUDAGraph]
    box: Dict[str, Any]


class GradGraphs:
    """The agent's gradient replay and Adam step, one entry a bucket.
    ``loss_fn(cfg, model, batch_a, batch_b, alpha, stop=...)`` is the
    loss (``rl/workflow_rl.rl_loss``)."""

    def __init__(self, cfg: Any, model: nn.Module, adam: Adam,
                 device: torch.device, loss_fn: Callable) -> None:
        self.cfg, self.model, self.adam = cfg, model, adam
        self.device, self.loss_fn = device, loss_fn
        self.key: Optional[GradKey] = None
        self.entries: Dict[int, _Grad] = {}
        self.buffers: Optional[_GradBuffers] = None
        self.pool: Tuple = ()
        self.last: Optional[_Grad] = None
        self.captures = self.replays = 0

    def learn(self, batch_a: Arrays, batch_b: Arrays, lr: float,
              beta1: float, clock=None) -> torch.Tensor:
        """The gradient of ``rl_loss`` of the two batches ((actions,
        t_counts, target, mask) on the host) and one Adam step at
        (``lr``, ``beta1``), by replays; -> the loss on the device.
        ``clock`` (a ``StepClock``) is marked after the forward and the
        backward."""
        shape = batch_a[0].shape
        key = grad_key(self.cfg, self.model, self.adam, shape)
        if key != self.key:
            self.entries.clear()            # frees their graphs and pool
            self.pool, self.last = (), None
            self.key = key
            self.buffers = self._buffers(shape)
        buf = self.buffers
        for dst, value in zip(buf.batches, tuple(batch_a) + tuple(batch_b)):
            _upload(dst, value)
        stop = max(int(min(t.max(), shape[1])) if len(t) else 0
                   for t in (batch_a[1], batch_b[1]))
        steps = bucket(stop, shape[1])
        entry = self.entries.get(steps)
        if entry is None:
            entry = self.entries[steps] = self._capture(steps)
        buf.scalars.copy_(self.adam.stage(lr, beta1))
        self.adam.zero_grad()
        for graph, mark in zip(entry.graphs,
                               ("grad_forward", "grad_backward", None)):
            graph.replay()
            if clock is not None and mark is not None:
                clock.mark(mark)
        mark_updated(self.adam)
        self.replays += 1
        self.last = entry
        return entry.box["value"].clone()

    def grads(self) -> List[torch.Tensor]:
        """The gradient leaves of the last replay, in ``adam.params``
        order (the graph's tensors: the next replay overwrites them)."""
        return self.last.box["grads"]

    def _buffers(self, shape: Tuple[int, int]) -> _GradBuffers:
        B, L = shape
        dev = self.device

        def batch():
            return (torch.zeros(B, L, dtype=torch.long, device=dev),
                    torch.zeros(B, dtype=torch.long, device=dev),
                    torch.zeros(B, dtype=torch.float32, device=dev),
                    torch.zeros(B, dtype=torch.float32, device=dev))
        return _GradBuffers(batch() + batch(),
                            torch.zeros(len(SCALARS), dtype=torch.float32,
                                        device=dev))

    def _capture(self, steps: int) -> _Grad:
        """The warm-up (forward and backward, eagerly, on the capture
        stream; its gradients dropped), then the three captures."""
        cfg, model, adam, buf = self.cfg, self.model, self.adam, self.buffers
        batch_a, batch_b = buf.batches[:4], buf.batches[4:]
        box: Dict[str, Any] = {}

        def forward() -> None:
            loss = self.loss_fn(cfg, model, batch_a, batch_b, cfg.alpha,
                                stop=steps)
            box["loss"], box["value"] = loss, loss.detach()

        def backward() -> None:
            box.pop("loss").backward()
            box["grads"] = adam.grads()

        def update() -> None:
            adam.apply(box["grads"], buf.scalars)

        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        pool = self.pool
        with cuda_graphs.on_capture_stream(graphs[0], self.device):
            adam.zero_grad()
            forward()
            backward()
            adam.zero_grad()
            box.clear()
            for graph, fn in zip(graphs, (forward, backward, update)):
                cuda_graphs.captured(graph, pool, fn)
                pool = pool or (graph.pool(),)
            # the graphs' gradients stay in the pool, referred to by the box
            adam.zero_grad()
        self.pool = pool
        self.captures += 1
        return _Grad(graphs, box)


class FineTuneGraphs:
    """A fine-tune job's captured graphs: the forward-only replays'
    (``loglik``) and the gradient replay's with Adam's (``grad``)."""

    def __init__(self, cfg: Any, agent: nn.Module, adam: Adam,
                 device: torch.device, loss_fn: Callable) -> None:
        self.loglik = LoglikGraphs()
        self.grad = GradGraphs(cfg, agent, adam, device, loss_fn)

    def counts(self) -> Dict[str, int]:
        """Captures and replays so far (forward-only: replayed steps)."""
        return dict(loglik_captures=self.loglik.captures,
                    loglik_replays=self.loglik.replays,
                    grad_captures=self.grad.captures,
                    grad_replays=self.grad.replays)

