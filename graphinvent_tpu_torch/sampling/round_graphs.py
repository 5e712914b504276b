"""The sampler's round as captured CUDA graphs.

The JAX package runs a whole rollout as one jitted ``lax.while_loop``
(``graphinvent_tpu/sampling/generator.py``).  The port's eager round holds
about 1.5 ms of device work and spends several times that issuing it from
Python.  Here, on a CUDA device and no mesh, each round of
``_sample_loop`` is two replays of captured CUDA graphs
(``torch.cuda.CUDAGraph``) acting on static state buffers: the model forward's (its kernel launches
included), then the rest's (the log-softmax, the Gumbel draw, the decode,
the slot writes and ``apply_actions``).  The host reads ``done`` after
each round, as the eager loop does, so the rounds run and the bytes
packed are the eager loop's.

* **Capture**, once a key (:func:`round_key`): everything the Python side
  of a round reads, since a replay re-runs none of it: the model (by
  identity), its ``cfg`` (``fused_inference_enn``, the dtype), every
  parameter's and buffer's ``data_ptr``, shape and dtype, the sampler's
  cfg and batch, the training, grad and inference modes, and the drops
  of the library's workspaces so far (``utils/cuda_graphs.py``: a drop
  frees the workspace a captured round reads).  An eager
  warm-up round on the capture stream (a side stream) first builds the
  kernel and fills ``fused_enn._cached_flat``, so the graphs hold no
  flatten; the entry keeps the flattened weights and the parameters they
  read alive.
* **Refresh**: where only the tensors' versions moved (an edit in place,
  as the fine-tune agent's after each Adam step), the graphs stay: one
  eager forward makes ``_cached_flat`` write the new flattened weights
  into the tensors the graphs read, which read the parameters themselves
  at their addresses.  Parameters made under ``inference_mode`` track no
  version (``_cached_flat``'s rule): replace those, do not edit them.
* **Randomness**: the rest's graph draws from a generator of its own,
  registered with it (``CUDAGraph.register_generator_state``): the
  caller's seed and offset go into it before the first round and come
  back out after the last, so the numbers drawn and the caller's
  generator's final state are the eager loop's.
* **Launch counts** (``fused_enn.LAUNCHES*``) count the rounds' device
  launches: the warm-up, the capture and a refresh add nothing, and each
  round adds what its capture recorded, by wrapper, layout and shape.
* **Hooks**: between the forward's replay and the rest's, the model's own
  forward hooks run as an eager forward runs them, on copies of the
  round's input and logits; a value a hook returns (or an edit it makes
  to the logits it was given) is what the rest of the round reads.  A
  model with forward pre-hooks, hooks on a submodule, or global module
  hooks samples on the eager loop (:func:`keeps_eager_loop`), as does a
  sampler with an ``apply_fn`` of its own.

Nothing falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, List, NamedTuple, Tuple

import torch
from torch.nn.modules import module as nn_module

from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.utils import cuda_graphs

# captured rounds kept by one sampler (the fine-tune job samples its agent
# and its BASF on one)
MAX_ENTRIES = 4


class RoundKey(NamedTuple):
    """What the Python side of a round reads (:func:`round_key`)."""
    weights: Tuple          # (data_ptr, shape, dtype) per tensor
    versions: Tuple         # each tensor's version (-1: an inference tensor)
    model_cfg: Any
    sampler_cfg: Any
    batch_size: int
    device: torch.device
    modes: Tuple[bool, bool, bool]   # training, grad, inference mode
    workspaces: int = 0     # ``cuda_graphs.workspace_drops()`` before it


def round_key(sampler_cfg: Any, model: torch.nn.Module, batch_size: int,
              device: torch.device) -> RoundKey:
    """What a round's Python side reads, besides the model's identity."""
    tensors = list(itertools.chain(model.parameters(), model.buffers()))
    return RoundKey(
        tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors),
        tuple(-1 if t.is_inference() else t._version for t in tensors),
        getattr(model, "cfg", None), sampler_cfg, batch_size, device,
        (model.training, torch.is_grad_enabled(),
         torch.is_inference_mode_enabled()), cuda_graphs.workspace_drops())


def keeps_eager_loop(model: Any) -> bool:
    """True for what a replayed round cannot call as an eager forward
    does: anything but a module, forward pre-hooks, global module hooks,
    hooks on a submodule (a round calls only the model's own forward
    hooks, between the forward's replay and the rest's)."""
    return (not isinstance(model, torch.nn.Module)
            or bool(model._forward_pre_hooks)
            or bool(nn_module._global_forward_pre_hooks
                    or nn_module._global_forward_hooks)
            or any(m._forward_pre_hooks or m._forward_hooks
                   for m in model.modules() if m is not model))


class _Captured:
    """One captured round: its graphs (the forward's, the rest's), the
    static state they act on, the logits the forward's graph writes (as
    the forward gives them and in float32, which the rest reads), the
    "all done" flag the rest writes, the generator it draws from, the
    launches of one round, and what they read that must stay alive."""

    def __init__(self, model, key: RoundKey, state, graphs, logits,
                 all_done, gen, launches, keep) -> None:
        self.model = weakref.ref(model)
        self.key, self.state, self.graphs = key, state, graphs
        self.logits, self.all_done, self.gen = logits, all_done, gen
        self.launches, self.keep = launches, keep


class RoundGraphs:
    """A sampler's captured rounds, the newest last (at most
    ``MAX_ENTRIES``; a model's entries on tensors it no longer has are
    dropped at its next capture)."""

    def __init__(self) -> None:
        self.entries: List[_Captured] = []
        self.captures = self.refreshes = 0

    def run(self, cfg, model: torch.nn.Module, generator: torch.Generator,
            batch_size: int, initial, max_rounds: int, step: Callable
            ) -> Tuple[Any, int]:
        """``_sample_loop``'s rounds from ``initial`` (a ``RoundState``)
        by replays; ``step(cfg, logits, generator, batch_size, rows,
        state)`` is its round after the forward.  Returns the final state
        (tensors of their own) and the rounds run."""
        entry = self._entry(cfg, model, generator.device, batch_size,
                            initial, step)
        st = entry.state
        for buf, value in zip(st, initial):
            buf.copy_(value)
        entry.gen.set_state(generator.get_state())
        rounds = 0
        all_done = bool(st.done.all().item())
        while rounds < max_rounds and not all_done:
            entry.graphs[0].replay()                 # the forward
            if model._forward_hooks:
                _call_hooks(model, st, *entry.logits)
            entry.graphs[1].replay()                 # the rest of the round
            fused_enn.credit_launches(entry.launches)
            rounds += 1
            all_done = bool(entry.all_done.item())
        generator.set_state(entry.gen.get_state())
        return type(st)(*(buf.clone() for buf in st)), rounds

    def _entry(self, cfg, model, device, batch_size, initial, step
               ) -> _Captured:
        key = round_key(cfg, model, batch_size, device)
        live = []
        for e in list(self.entries):
            m = e.model()
            if m is model and e.key._replace(versions=key.versions) == key:
                if e.key == key or self._refresh(e, model):
                    e.key = key
                    self.entries.remove(e)
                    self.entries.append(e)
                    return e
                continue     # its flattened weights are other tensors now
            if m is not None and e.key.workspaces == key.workspaces and not (
                    m is model and e.key.weights != key.weights):
                live.append(e)
        entry = self._capture(cfg, model, device, batch_size, initial, step,
                              key)
        self.entries = (live + [entry])[-MAX_ENTRIES:]
        return entry

    def _refresh(self, entry: _Captured, model) -> bool:
        """After an edit in place: one eager forward, whose
        ``_cached_flat`` writes the new flattened weights into the tensors
        the graphs read.  False where they are other tensors now."""
        with fused_enn.uncounted():
            model.forward(entry.state.nodes, entry.state.edges)
        flats = fused_enn.cached_flats(model)
        if len(flats) != len(entry.keep[0]) or any(
                a is not b for a, b in zip(flats, entry.keep[0])):
            return False
        self.refreshes += 1
        return True

    def _capture(self, cfg, model, device, batch_size, initial, step,
                 key: RoundKey) -> _Captured:
        st = type(initial)(*(v.clone() for v in initial))
        gen = torch.Generator(device=device)
        rows = slice(0, batch_size)

        def forward():
            # the forward without the hooks, which run between replays
            logits = model.forward(st.nodes, st.edges)
            return logits, logits.float()

        def rest(logits_f32):
            new = step(cfg, logits_f32, gen, batch_size, rows, st)
            for buf, value in zip(st, new):
                if value is not buf:
                    buf.copy_(value)
            return st.done.all()

        graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
        graphs[1].register_generator_state(gen)
        # the warm-up round and the captures run on PyTorch's one capture
        # stream, so that the library's per-stream workspace (cuBLAS: 32
        # MiB) they allocate serves every capture of the process
        with cuda_graphs.on_capture_stream(graphs[0], device), \
                fused_enn.uncounted():
            rest(forward()[1])                   # the warm-up round
            before = fused_enn.launch_counts()
            logits = cuda_graphs.captured(graphs[0], (), forward)
            launches = fused_enn.launch_counts(since=before)
            all_done = cuda_graphs.captured(graphs[1], (graphs[0].pool(),),
                                            lambda: rest(logits[1]))
        self.captures += 1
        keep = (fused_enn.cached_flats(model),
                [t.detach() for t in itertools.chain(model.parameters(),
                                                     model.buffers())])
        return _Captured(model, key, st, graphs, logits, all_done, gen,
                         launches, keep)


def _call_hooks(model: torch.nn.Module, st, logits: torch.Tensor,
                logits_f32: torch.Tensor) -> None:
    """The model's forward hooks, as ``nn.Module.__call__`` runs them after
    a forward of ``(nodes, edges)``: on copies of the round's input and
    logits, a hook's returned value taking the logits' place for the hooks
    after it and for the rest of the round, which reads ``logits_f32``
    (and so sees an edit a hook makes in place, as the eager round does)."""
    args = (st.nodes.clone(), st.edges.clone())
    result = logits.clone()
    for hook_id, hook in list(model._forward_hooks.items()):
        if hook_id in model._forward_hooks_with_kwargs:
            out = hook(model, args, {}, result)
        else:
            out = hook(model, args, result)
        if out is not None:
            result = out
    if not (isinstance(result, torch.Tensor)
            and result.shape == logits.shape):
        raise TypeError("a forward hook of a sampled model returned "
                        f"{type(result).__name__} "
                        f"{tuple(getattr(result, 'shape', ()))}, not logits "
                        f"of shape {tuple(logits.shape)}")
    logits_f32.copy_(result)
