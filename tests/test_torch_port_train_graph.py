"""The host side of the resident epoch's captured step
(``train/step_graphs.py``) on the CPU: Adam split into staged scalars and
their arithmetic, the epoch's scalar table, the capture key, the rules
that keep a step or an epoch on the eager loop, the version counters after
replayed updates, and the epoch loop itself with a stand-in graph that runs
the captured function at each replay.  Capture and replay need the card:
``tests/test_torch_port_gpu.py`` holds them against the eager loop there.

Tolerances, against ``graphinvent_tpu.train.optim``: 20 Adam steps with a
cycling beta1 rtol 1e-5 (``tests/test_torch_port_optim.py``'s); the
schedule's lr and beta1 rtol 1e-5 (JAX evaluates them in f32, the port in
float64 on the host), the bias corrections rtol 1e-5, beta2's 5e-5 (JAX's
f32 0.999 is 1.3e-8 off, which 1 - 0.999^t at t=1 makes 1.3e-5 relative).
The port against itself: byte for byte.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.modules import module as nn_module

from graphinvent_tpu.train import optim as joptim

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import build_model, core, fused_enn
from graphinvent_tpu_torch.models.core import MLP
from graphinvent_tpu_torch.parallel import multihost
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_DROPOUT, seeded_generator,
)
from graphinvent_tpu_torch.train import device_data as pdd
from graphinvent_tpu_torch.train import optim as poptim
from graphinvent_tpu_torch.train import step_graphs as sg
from graphinvent_tpu_torch.utils import cuda_graphs

import _torch_port_util  # noqa: F401  (caps torch's threads)

CPU = torch.device("cpu")
MODELS = ("MNN", "S2V", "AttS2V", "GGNN", "AttGGNN", "EMN")


# --------------------------------------------------------------------------
# Adam on staged scalars
# --------------------------------------------------------------------------

def _mlp_and_tree(seed):
    m = MLP(5, [7, 6], 3, generator=torch.Generator().manual_seed(seed))
    tree = {n: jnp.array(p.detach().numpy().copy())
            for n, p in m.named_parameters()}
    return m, tree


def test_split_adam_20_steps_with_cycling_beta1_match_jax():
    """The replay's path (a row of the epoch's table, then ``apply``)
    against ``adam_update``, and byte-equal to the eager ``update``."""
    model, params = _mlp_and_tree(0)
    twin, _ = _mlp_and_tree(0)
    adam, eager = poptim.Adam(model), poptim.Adam(twin)
    state = joptim.adam_init(params)
    sched = poptim.OneCycle(max_lr=1e-2, total_steps=20)
    jsched = joptim.OneCycle(max_lr=1e-2, total_steps=20)
    table = adam.scalar_table(sched, 20)
    assert table.shape == (20, len(poptim.SCALARS))
    assert table.dtype == np.float32
    rng = np.random.default_rng(0)
    for step in range(20):
        grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for m in (model, twin):
            for n, p in m.named_parameters():
                p.grad = torch.from_numpy(grads[n].copy())
        adam.step += 1
        adam.apply(adam.grads(), torch.from_numpy(table[step]))
        eager.update(*sched(eager.step))
        jlr, jb1 = jsched(state.step)
        params, state = joptim.adam_update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params,
            jlr, jb1)
    assert adam.step == eager.step == int(state.step) == 20
    for i, (n, p) in enumerate(model.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(adam.mu[i].numpy(),
                                   np.asarray(state.mu[n]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(adam.nu[i].numpy(),
                                   np.asarray(state.nu[n]), rtol=1e-5,
                                   atol=1e-7)
    for a, b in zip(adam.params + adam.mu + adam.nu,
                    eager.params + eager.mu + eager.nu):
        assert torch.equal(a, b)


def test_stage_advances_the_step_and_apply_reads_only_the_device_scalars():
    model, _ = _mlp_and_tree(1)
    adam = poptim.Adam(model)
    for p in adam.params:
        p.grad = torch.ones_like(p)
    scalars = adam.stage(1e-3, 0.9)
    assert adam.step == 1 and scalars.dtype == torch.float32
    np.testing.assert_array_equal(
        scalars.numpy(),
        poptim.adam_scalars(1, 1e-3, 0.9, adam.beta2))
    before = [p.detach().clone() for p in adam.params]
    adam.apply(adam.grads(), scalars)
    assert adam.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, adam.params))
    with pytest.raises(RuntimeError, match="no gradient"):
        adam.zero_grad()
        adam.grads()


def test_apply_reads_no_value_back_from_its_scalars():
    """No op of the update turns a staged scalar into a Python number
    (``aten._local_scalar_dense``, ``.item()``): on the card that would be
    a sync in every eager step and would end a capture in an error."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    model, _ = _mlp_and_tree(3)
    adam = poptim.Adam(model)
    for p in adam.params:
        p.grad = torch.ones_like(p)
    scalars = adam.stage(1e-3, 0.9)
    with Ops():
        adam.apply(adam.grads(), scalars)
    names = [str(f) for f in Ops.seen]
    assert not [n for n in names if "_local_scalar_dense" in n], names
    assert sum(n.startswith("aten._foreach") for n in names) == 11, names


@pytest.mark.parametrize("name,start", [
    ("train", 0), ("train", 45), ("train-no-cycle", 3), ("fine-tune", 0),
    ("short", 0)])
def test_scalar_table_matches_onecycle_at_every_step_incl_past_total(
        name, start):
    kw = {"train": dict(max_lr=1e-4, total_steps=50),
          "train-no-cycle": dict(max_lr=1e-4, total_steps=50,
                                 cycle_momentum=False),
          "fine-tune": dict(max_lr=1e-4, total_steps=40, pct_start=0.05,
                            div_factor=1.0, final_div_factor=1e4),
          "short": dict(max_lr=3e-3, total_steps=2)}[name]
    psched, jsched = poptim.OneCycle(**kw), joptim.OneCycle(**kw)
    model, _ = _mlp_and_tree(2)
    adam = poptim.Adam(model)
    adam.step = start
    n = kw["total_steps"] + 12 - start       # runs past the plan's end
    table = adam.scalar_table(psched, n)
    assert adam.step == start
    for i in range(n):
        step = start + i
        lr, b1 = poptim.onecycle_eval(psched, step)
        row = table[i]
        assert row[4] == np.float32(lr) and row[0] == np.float32(b1)
        assert row[1] == np.float32(1.0 - b1)
        jlr, jb1 = jsched(step)
        np.testing.assert_allclose(row[4], float(jlr), rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(row[0], float(jb1), rtol=1e-5)
        # the bias corrections: float64 on the host, rounded once
        assert row[2] == np.float32(1.0 - b1 ** (step + 1))
        assert row[3] == np.float32(1.0 - 0.999 ** (step + 1))
        t = jnp.float32(step + 1)
        np.testing.assert_allclose(
            row[2], float(1.0 - jnp.power(jnp.float32(jb1), t)), rtol=1e-5)
        np.testing.assert_allclose(row[3], float(1.0 - 0.999 ** t),
                                   rtol=5e-5)
    # past the plan the rows clip and stay at the plan's last values
    np.testing.assert_array_equal(table[-1, [0, 1, 4]], table[-2, [0, 1, 4]])
    assert adam.scalar_table(psched, 0).shape == (0, len(poptim.SCALARS))


def test_adam_at_lr_zero_moves_nothing():
    """At lr 0 the parameters stay as they were, as JAX's ``adam_update``
    leaves them, also where a gradient and so ``nu`` is 0."""
    model, params = _mlp_and_tree(4)
    adam = poptim.Adam(model)
    state = joptim.adam_init(params)
    before = [p.detach().clone() for p in adam.params]
    for p in adam.params:
        p.grad = torch.zeros_like(p)          # nu stays 0 for these
    adam.params[0].grad = torch.ones_like(adam.params[0])
    adam.update(0.0, 0.9)
    grads = {n: jnp.asarray(p.grad.numpy())
             for n, p in zip(adam.names, adam.params)}
    new, _ = joptim.adam_update(grads, state, params, 0.0, 0.9)
    for n, p, b in zip(adam.names, adam.params, before):
        assert torch.equal(p.detach(), b)
        np.testing.assert_array_equal(np.asarray(new[n]), b.numpy())


# --------------------------------------------------------------------------
# the capture key
# --------------------------------------------------------------------------

def _data(cfg, rows, seed=0):
    from graphinvent_tpu_torch.utils.synthetic import synthetic_graphs
    nodes, edges = synthetic_graphs(cfg, rows, seed=seed)
    rng = np.random.default_rng(seed)
    apds = np.zeros((rows, cfg.dim_apd), np.int8)
    apds[np.arange(rows), rng.integers(0, cfg.dim_apd, rows)] = 1
    apds[::3, 2] += 1

    def put(a):
        return torch.from_numpy(a.astype(np.int8))
    return SimpleNamespace(nodes=put(nodes), edges=put(edges), apds=put(apds),
                           device=CPU, n_rows=rows)


def _setup(name="GGNN", rows=37, dropout=0.0):
    cfg = port_tiny(name, device="cpu")
    if dropout:
        cfg = cfg.replace(**{f.name: dropout for f in dataclasses.fields(cfg)
                             if f.name.endswith("_dropout_p")})
    model = build_model(cfg, torch.Generator().manual_seed(0))
    return cfg, model, poptim.Adam(model), _data(cfg, rows)


def test_key_is_stable_across_in_place_edits_and_load_state_dict():
    cfg, model, adam, data = _setup()
    gen = torch.Generator()
    key = sg.step_key(cfg, model, adam, data, 8, gen)
    state = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.APDReadout.fTermNet2.linears[-1].bias.add_(1.0)
        adam.mu[0].add_(1.0)
    model.load_state_dict(state)
    adam.step = 5
    adam.load_state_dict(adam.state_dict())
    assert sg.step_key(cfg, model, adam, data, 8, gen) == key


def test_key_moves_on_what_a_replay_cannot_follow():
    cfg, model, adam, data = _setup()
    gen = torch.Generator()

    def key(**kw):
        args = dict(cfg=cfg, model=model, adam=adam, data=data,
                    batch_size=8, generator=gen)
        args.update(kw)
        return sg.step_key(**args)

    base = key()
    lin = model.APDReadout.fTermNet2.linears[-1]
    old = lin.bias                     # alive, so its address is not reused
    lin.bias = torch.nn.Parameter(old.detach().clone())
    assert key().weights != base.weights
    lin.bias = old
    assert key() == base
    moment = adam.nu[3]
    adam.nu[3] = moment.clone()
    assert key().weights != base.weights
    adam.nu[3] = moment
    model.cfg = cfg.replace(fused_inference_enn=False)
    assert key().model_cfg != base.model_cfg
    model.cfg = cfg
    assert key(cfg=cfg.replace(compute_dtype="bfloat16")) != base
    assert key(batch_size=9) != base
    assert key(data=_data(cfg, 37, seed=1)) != base
    assert key(generator=None) != base
    assert key(model=build_model(cfg)).model != base.model
    with torch.no_grad():
        assert key() != base
    model.eval()
    assert key() != base
    model.train()
    assert key() == base


def test_a_workspace_drop_moves_the_sampler_round_key(monkeypatch):
    """A round captured before the library's workspaces were dropped reads
    a freed workspace: the drop moves the sampler's key, which recaptures
    (``tests/test_torch_port_gpu.py`` drops them at each train capture)."""
    from graphinvent_tpu_torch.sampling import round_graphs as rg
    cfg = port_tiny("GGNN", device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    drops = []
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: drops.append(1), raising=False)
    key = rg.round_key(cfg, model, 8, CPU)
    cuda_graphs.drop_library_workspaces()
    moved = rg.round_key(cfg, model, 8, CPU)
    assert drops == [1] and moved.workspaces == key.workspaces + 1
    assert moved._replace(workspaces=key.workspaces) == key


# --------------------------------------------------------------------------
# the rules that keep the eager loop
# --------------------------------------------------------------------------

def _noop(*args):
    return None


HOOKS = {
    "forward": lambda m: m.register_forward_hook(_noop),
    "forward pre": lambda m: m.register_forward_pre_hook(_noop),
    "submodule forward": lambda m: m.msg_nns[0].register_forward_hook(_noop),
    "submodule forward pre":
        lambda m: m.APDReadout.register_forward_pre_hook(_noop),
    "global forward": lambda m: nn_module.register_module_forward_hook(_noop),
    "global forward pre":
        lambda m: nn_module.register_module_forward_pre_hook(_noop),
    "backward": lambda m: m.register_full_backward_hook(_noop),
    "backward pre": lambda m: m.gather.register_full_backward_pre_hook(_noop),
    "global backward":
        lambda m: nn_module.register_module_full_backward_hook(_noop),
    "parameter": lambda m: next(m.parameters()).register_hook(_noop),
    "parameter post-accumulate": lambda m: next(
        m.parameters()).register_post_accumulate_grad_hook(_noop),
}


@pytest.mark.parametrize("kind", sorted(HOOKS))
def test_each_kind_of_hook_keeps_a_step_eager(kind):
    _, model, _, _ = _setup()
    assert not sg.keeps_eager_step(model)
    handle = HOOKS[kind](model)
    try:
        assert sg.keeps_eager_step(model)
    finally:
        handle.remove()
    assert not sg.keeps_eager_step(model)


def test_the_cpu_a_mesh_and_several_processes_keep_the_eager_loop(
        monkeypatch):
    cuda = torch.device("cuda")
    assert sg.replays_steps(cuda)
    assert sg.replays_steps(cuda, SimpleNamespace(size=1))
    assert not sg.replays_steps(CPU)
    assert not sg.replays_steps(cuda, SimpleNamespace(size=2))
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    assert not sg.replays_steps(cuda)
    monkeypatch.undo()
    cfg, model, adam, data = _setup()
    fn = pdd.make_epoch_train_fn(cfg, poptim.onecycle_for_config(cfg, 5),
                                 data, model, adam)
    assert fn.graphs is None


# --------------------------------------------------------------------------
# version counters after replayed updates
# --------------------------------------------------------------------------

def test_fused_wrappers_see_replayed_updates_after_the_version_bump():
    """A replay writes the weights without moving a version counter
    (here: writes through ``.data``, which moves none either); the
    wrappers' plain path keeps its stale flattened weights until
    ``mark_updated``, then reads the new ones (atol 1e-5: f32, another
    summation order)."""
    cfg, model, adam, _ = _setup()
    x = torch.randn(5, cfg.hidden_node_features,
                    generator=torch.Generator().manual_seed(3))
    mlp = model.gather.emb_nn
    with torch.no_grad():
        before = fused_enn.fused_mlp(mlp, x)
        stacked_before = fused_enn.fused_stacked_mlp(model.msg_nns, x[None])
    versions = [t._version for t in adam.params + adam.mu + adam.nu]
    for p in adam.params:
        p.data.mul_(1.5)
    assert [p._version for p in adam.params] == versions[:len(adam.params)]
    with torch.no_grad():
        assert torch.equal(fused_enn.fused_mlp(mlp, x), before)   # stale
        sg.mark_updated(adam)
        fresh = fused_enn.fused_mlp(mlp, x)
        stacked = fused_enn.fused_stacked_mlp(model.msg_nns, x[None])
        want = core.mlp(mlp, x)
        want_stacked = core.stacked_mlp(list(model.msg_nns), x[None])
    assert all(t._version > v for t, v in
               zip(adam.params + adam.mu + adam.nu, versions))
    assert not torch.equal(fresh, before)
    assert not torch.equal(stacked, stacked_before)
    np.testing.assert_allclose(fresh.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(stacked.numpy(), want_stacked.numpy(),
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the epoch loop with a stand-in graph
# --------------------------------------------------------------------------

class _StandInGraph:
    """Captures nothing: its replay runs the captured function eagerly
    and writes its result into the output the capture returned."""
    made = []

    def __init__(self):
        self.fn = self.out = None
        self.generators = []
        _StandInGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.out.copy_(self.fn())


def _stand_in_capture(graph, pool, fn):
    graph.fn, graph.out = fn, torch.zeros(())
    return graph.out


@contextlib.contextmanager
def _same_stream(graph, device):
    yield []


@pytest.fixture
def stand_in(monkeypatch):
    """``step_graphs`` on the CPU with the stand-in graph; the rule says
    replay."""
    _StandInGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(cuda_graphs, "captured", _stand_in_capture)
    monkeypatch.setattr(cuda_graphs, "on_capture_stream", _same_stream)
    monkeypatch.setattr(cuda_graphs, "drop_library_workspaces",
                        lambda: None)
    monkeypatch.setattr(pdd, "replays_steps", lambda device, mesh: True)
    return _StandInGraph


def _run(name, graphed, arm_after=None, epochs=2):
    """Trains ``epochs`` epochs of 5 steps; a one-shot forward hook is
    armed after step ``arm_after`` of the last epoch.  -> (model, adam,
    per epoch (mean, step losses, generator state), hooked logits, the
    epoch function)."""
    cfg, model, adam, data = _setup(name, dropout=0.1)
    fn = pdd.make_epoch_train_fn(cfg, poptim.onecycle_for_config(cfg, 5),
                                 data, model, adam, _eager=not graphed)
    seen = []

    class Arming(list):
        def append(self, loss):
            super().append(loss)
            if len(self) == arm_after:
                box = {}

                def hook(module, args, output):
                    seen.append(output.detach().clone())
                    box["handle"].remove()
                box["handle"] = model.register_forward_hook(hook)

    out = []
    for e in range(epochs):
        perm = pdd.epoch_permutation(data.n_rows, cfg.batch_size,
                                     np.random.default_rng(e))
        gen = seeded_generator([3, e], CPU, STREAM_DROPOUT)
        losses = Arming() if e == epochs - 1 else []
        mean = fn(perm, gen, losses)
        out.append((mean, torch.stack(losses), gen.get_state()))
    return model, adam, out, seen, fn


def _assert_same(a, b):
    assert a[1].step == b[1].step
    for x, y in zip(a[2], b[2]):
        assert x[0] == y[0] and torch.equal(x[1], y[1])
        assert torch.equal(x[2], y[2])
    for s, t in zip(list(a[0].parameters()) + a[1].mu + a[1].nu,
                    list(b[0].parameters()) + b[1].mu + b[1].nu):
        assert torch.equal(s, t)
    assert len(a[3]) == len(b[3])
    assert all(torch.equal(s, t) for s, t in zip(a[3], b[3]))


@pytest.mark.parametrize("name", MODELS)
def test_epoch_loop_with_a_stand_in_graph_equals_the_eager_loop(stand_in,
                                                                 name):
    """The loop's host side: the warm-up step, the table's rows, Adam's
    step, the dropout generator handed to the graph's and back, a hooked
    eager step between replays: byte-equal to the eager loop."""
    graphed = _run(name, True, arm_after=2)
    eager = _run(name, False, arm_after=2)
    _assert_same(graphed, eager)
    graphs = graphed[4].graphs
    assert (graphs.captures, graphs.replays) == (1, 4 + 4)
    assert len(stand_in.made) == 1 and len(stand_in.made[0].generators) == 1
    assert len(graphed[3]) == 1
    assert graphed[1].step == 10


def test_epoch_loop_without_a_generator_captures_no_dropout_state(stand_in):
    cfg, model, adam, data = _setup("GGNN", dropout=0.1)
    fn = pdd.make_epoch_train_fn(cfg, poptim.onecycle_for_config(cfg, 5),
                                 data, model, adam)
    twin = build_model(cfg, torch.Generator().manual_seed(0))
    twin_adam = poptim.Adam(twin)
    eager = pdd.make_epoch_train_fn(cfg, poptim.onecycle_for_config(cfg, 5),
                                    data, twin, twin_adam, _eager=True)
    perm = pdd.epoch_permutation(data.n_rows, cfg.batch_size,
                                 np.random.default_rng(0))
    assert fn(perm) == eager(perm)
    assert stand_in.made[0].generators == []
    assert fn.graphs.entry.gen is None
    # a generator now is another key: the next epoch recaptures
    fn(perm, torch.Generator())
    assert fn.graphs.captures == 2 and len(stand_in.made) == 2


def test_epoch_loop_recaptures_on_a_replaced_parameter(stand_in):
    cfg, model, adam, data = _setup("GGNN")
    sched = poptim.onecycle_for_config(cfg, 5)
    fn = pdd.make_epoch_train_fn(cfg, sched, data, model, adam)
    perm = pdd.epoch_permutation(data.n_rows, cfg.batch_size,
                                 np.random.default_rng(0))
    fn(perm)
    fn(perm)
    assert fn.graphs.captures == 1
    lin = model.APDReadout.fTermNet2.linears[-1]
    i = next(k for k, p in enumerate(adam.params) if p is lin.bias)
    lin.bias = adam.params[i] = torch.nn.Parameter(lin.bias.detach().clone())
    fn(perm)
    assert fn.graphs.captures == 2
    assert fn.graphs.replays == 4 + 5 + 4
