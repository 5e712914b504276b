"""The resident train epoch's steps as replays of one captured CUDA graph.

The JAX package runs a resident epoch as one jitted ``lax.scan`` over the
shuffled batches (``graphinvent_tpu/train/device_data.py``): the gather,
forward, backward, OneCycle and Adam of every step run in one device
program.  The port's eager step issues each of its launches from Python.
Here, on a CUDA device with one process and no mesh (:func:`replays_steps`,
decided before the epoch), each step of ``device_data.make_epoch_train_fn``
is one replay of a captured graph (``torch.cuda.CUDAGraph``) holding the
row gather from the resident dataset, the int8 -> compute-dtype cast, the
training forward with its dropout, the loss and its backward, and Adam's
arithmetic (``optim.Adam.apply``) on that step's staged scalars: the
eager step's own body (``step.make_train_step``) given those scalars.

* **Per step** the host copies the step's row ids and its row of the
  epoch's scalar table (``Adam.scalar_table``: OneCycle's lr and beta1 in
  float64 on the host, the bias corrections; uploaded once an epoch) into
  the graph's static buffers, advances ``Adam.step``, and replays.  Each
  step yields a copy of the graph's static loss (on the device), which
  the epoch adds to its total; it reads one ``.item()`` at its end, as
  before.
* **Capture**, once a key (:func:`step_key`): the model (by identity), its
  ``cfg`` and the epoch's, every parameter's (the model's and Adam's),
  buffer's and moment's ``data_ptr``, shape and dtype, Adam's constants,
  the rows a step, the dataset tensors' addresses, the generator's device,
  and the training, grad and inference modes.  Versions are not in it:
  an edit in place (a restart's ``load_state_dict``, the moments'
  ``copy_``) keeps the graph, which reads the tensors at their addresses;
  a replaced tensor or another ``cfg`` recaptures.  The step before a
  capture is the epoch's own step, run eagerly on the capture stream (the warm-up a capture needs: it makes
  the cuBLAS handles and workspaces of the main and autograd threads on
  that stream); the capture runs nothing.  So no step is added, and
  ``Adam.step``, the dropout offsets and the weights follow the eager
  loop's from the first step on.  The capture takes PyTorch's one capture
  stream, which the sampler's graphs take too (``utils/cuda_graphs.py``).
  The library's workspaces are dropped after the warm-up and after the
  capture (``cuda_graphs.drop_library_workspaces``): the capture's go to
  its private pool, and those the warm-up made on the capture stream (32
  MiB a thread's handle) do not stay allocated beside the eager step's.
  The drop frees what the sampler's rounds captured before it read, so
  they capture again (their key holds ``cuda_graphs.workspace_drops``).
* **The backward** runs on autograd's device thread, which issues its
  kernels onto the forward's stream, here the capture stream: a capture
  is per stream, so they are captured whatever the thread.  The capture
  uses ``capture_error_mode="thread_local"`` (``cuda_graphs.captured``),
  as the sampler's does: a potentially unsafe CUDA call of another thread
  (the train job's analyzer or upload workers) does not invalidate it,
  while the capture ends in an error where anything on the stream was
  left out.  A step whose replay differs from the eager step shows as
  such: the card's tests hold a graphed epoch byte-equal to an eager one.
* **Randomness**: dropout draws from a generator of the graph's own,
  registered with it (``CUDAGraph.register_generator_state``); the
  caller's generator state goes into it before the epoch's first replay
  and comes back after its last (and around an eager step between
  replays), so the masks drawn and the generator's final state are the
  eager loop's.
* **Version counters**: a replayed update moves no version counter, and
  the fused kernel's weight cache (``fused_enn._cached_flat``) and the
  sampler's graph key (``sampling/round_graphs.py``) key on them.  After
  replays, before an eager step and at the epoch's end, every parameter's
  and moment's counter is moved (:func:`mark_updated`), so the validation
  and NLL epochs after a train epoch, and a sampler in the same process,
  read the new weights.
* **Hooks**: a step runs eagerly, on the same tensors, where a replay
  would skip Python that an eager step calls (:func:`keeps_eager_step`):
  a forward hook or pre-hook on the model, a hook on a submodule, a
  global module hook, a backward hook, or a hook on a parameter.  The
  hook fires as it does on the eager loop, and an ``Adam`` subclass's
  ``update`` runs on such steps only.
* **Memory**: the graph's activations live in its private pool (reserved,
  not allocated); after the capture no ``.grad`` refers to the graph's
  gradients, so an eager step's gradients never stand beside them.

Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as nn_module

from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.parallel import multihost
from graphinvent_tpu_torch.sampling.round_graphs import keeps_eager_loop
from graphinvent_tpu_torch.train.optim import SCALARS, Adam
from graphinvent_tpu_torch.utils import cuda_graphs

Batch = Any


def replays_steps(device: torch.device, mesh=None) -> bool:
    """The rule, decided before an epoch: a CUDA device, no mesh with
    members, one process.  The CPU, a mesh (its sharded step's
    collectives), several processes and the streamed ``BlockLoader`` path
    (which never calls the resident epoch) keep the eager loop."""
    return (device.type == "cuda" and (mesh is None or mesh.size == 1)
            and multihost.process_count() == 1)


def keeps_eager_step(model: nn.Module) -> bool:
    """True where a step calls Python that a replay would skip: forward
    hooks or pre-hooks on the model or a submodule, global module hooks,
    backward hooks, hooks on a parameter."""
    modules = list(model.modules())
    return (keeps_eager_loop(model) or bool(model._forward_hooks)
            or bool(nn_module._global_backward_pre_hooks
                    or nn_module._global_backward_hooks)
            or any(m._backward_pre_hooks or m._backward_hooks
                   for m in modules)
            or any(p._backward_hooks
                   or getattr(p, "_post_accumulate_grad_hooks", None)
                   for p in model.parameters()))


class StepKey(NamedTuple):
    """What a step's Python side reads."""
    model: int              # the model's identity
    weights: Tuple          # (data_ptr, shape, dtype) per tensor
    model_cfg: Any
    cfg: Any
    adam: Tuple[float, float]       # beta2, eps
    batch_size: int
    data: Tuple             # (data_ptr, shape) of the dataset's tensors
    generator: Optional[torch.device]
    modes: Tuple[bool, bool, bool]  # training, grad, inference mode


def _where(tensors) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def step_key(cfg: Any, model: nn.Module, adam: Adam, data: Any,
             batch_size: int, generator: Optional[torch.Generator]
             ) -> StepKey:
    """The capture key of a step (:class:`StepKey`)."""
    return StepKey(
        id(model),
        _where(itertools.chain(model.parameters(), model.buffers(),
                               adam.params, adam.mu, adam.nu)),
        getattr(model, "cfg", None), cfg, (adam.beta2, adam.eps),
        batch_size,
        tuple((t.data_ptr(), tuple(t.shape))
              for t in (data.nodes, data.edges, data.apds)),
        None if generator is None else generator.device,
        (model.training, torch.is_grad_enabled(),
         torch.is_inference_mode_enabled()))


def mark_updated(adam: Adam) -> None:
    """Moves the version counter of every parameter and moment, as an
    eager update in place does."""
    for t in itertools.chain(adam.params, adam.mu, adam.nu):
        torch.autograd.graph.increment_version(t)


class _Captured:
    """One captured step: its graph, the static row ids and scalars it
    reads, the loss it writes, the generator it draws dropout from, and
    the launches of one replay."""

    def __init__(self, key, graph, idx, scalars, loss, gen,
                 launches) -> None:
        self.key, self.graph, self.idx = key, graph, idx
        self.scalars, self.loss, self.gen = scalars, loss, gen
        self.launches = launches


class StepGraphs:
    """The captured step of one resident epoch function: one entry, for
    the newest key (a new key drops the old graph, then captures).
    ``schedule`` is the epoch's OneCycle, ``gather(idx)`` its row gather,
    ``train_step(batch, generator, scalars=None)`` its step
    (``step.make_train_step``), which a capture records with scalars."""

    def __init__(self, cfg: Any, schedule, model: nn.Module, adam: Adam,
                 data: Any, gather: Callable[[torch.Tensor], Batch],
                 train_step: Callable[..., torch.Tensor]) -> None:
        self.cfg, self.schedule, self.model = cfg, schedule, model
        self.adam, self.data = adam, data
        self.gather, self.train_step = gather, train_step
        self.entry: Optional[_Captured] = None
        self.captures = self.replays = 0

    def steps(self, batches: torch.Tensor,
              generator: Optional[torch.Generator]
              ) -> Iterator[torch.Tensor]:
        """Runs the epoch's steps over the rows of ``batches`` (int64 on
        the device), yielding each step's loss on the device."""
        adam, model = self.adam, self.model
        table = torch.from_numpy(adam.scalar_table(
            self.schedule, len(batches))).to(self.data.device)
        held: Optional[_Captured] = None   # its generator has the state
        entry: Optional[_Captured] = None  # checked since the last eager step
        dirty = False                      # replayed since the last bump

        def hand_back() -> None:
            """The dropout generator's state back to the caller's, and
            the replayed updates' version counters moved."""
            nonlocal held, dirty
            if held is not None:
                generator.set_state(held.gen.get_state())
                held = None
            if dirty:
                mark_updated(adam)
                dirty = False

        try:
            for i, idx in enumerate(batches):
                if keeps_eager_step(model):
                    hand_back()
                    entry = None
                    yield self.train_step(self.gather(idx), generator)
                    continue
                if entry is None:
                    entry = self._lookup(len(idx), generator)
                if entry is None:
                    hand_back()
                    # this step is the warm-up; the next replays
                    yield self._capture(idx, generator)
                    continue
                if held is not entry and generator is not None:
                    hand_back()
                    entry.gen.set_state(generator.get_state())
                    held = entry
                entry.idx.copy_(idx)
                entry.scalars.copy_(table[i])
                adam.step += 1
                entry.graph.replay()
                fused_enn.credit_launches(entry.launches)
                self.replays += 1
                dirty = True
                yield entry.loss.clone()
        finally:
            hand_back()

    def _key(self, batch_size: int, generator) -> StepKey:
        return step_key(self.cfg, self.model, self.adam, self.data,
                        batch_size, generator)

    def _lookup(self, batch_size: int, generator) -> Optional[_Captured]:
        key = self._key(batch_size, generator)
        if self.entry is not None and self.entry.key != key:
            self.entry = None                 # frees its graph and pool
        return self.entry

    def _capture(self, idx: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """Runs this step eagerly on the capture stream, then captures the
        step; returns the eager step's loss."""
        adam, device = self.adam, self.data.device
        key = self._key(len(idx), generator)
        graph = torch.cuda.CUDAGraph()
        gen = None
        if generator is not None:
            gen = torch.Generator(device=device)
            graph.register_generator_state(gen)
        static_idx = idx.clone()
        scalars = torch.empty(len(SCALARS), dtype=torch.float32,
                              device=device)

        def step() -> torch.Tensor:
            return self.train_step(self.gather(static_idx), gen, scalars)

        with cuda_graphs.on_capture_stream(graph, device) as used:
            loss = self.train_step(self.gather(idx), generator)
            used.append(loss)
            # the capture's library workspaces go to its own pool, and
            # none of the capture stream's stays allocated after it
            cuda_graphs.drop_library_workspaces()
            with fused_enn.uncounted():
                before = fused_enn.launch_counts()
                out = cuda_graphs.captured(graph, (), step)
                launches = fused_enn.launch_counts(since=before)
            cuda_graphs.drop_library_workspaces()
            # the graph's gradients stay in its pool, referred to by none
            adam.zero_grad()
        self.entry = _Captured(key, graph, static_idx, scalars, out, gen,
                               launches)
        self.captures += 1
        return loss
