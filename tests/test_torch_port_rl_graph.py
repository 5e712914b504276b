"""The host side of the fine-tune step's captured graphs
(``rl/step_graphs.py``) on the CPU: the gradient replay padded to its
bucket and to L against the replay to ``stop`` and against the JAX
package's ``value_and_grad``; the forward-only replays and whole
fine-tune steps with a stand-in graph that runs the captured function at
each replay, against the eager step; the capture keys; and the rules that
keep the eager step.  Capture and replay need the card:
``tests/test_torch_port_gpu.py`` holds them against the eager step there.

Tolerances: the padded replay against the replay to ``stop``, the
stand-in graphs against the eager step: equal (``torch.equal``, which
counts -0 equal to +0: an inert step adds +0 and sends back zeros whose
sign may differ); against JAX's ``_make_rl_grad``: the loss and every
gradient leaf rtol 1e-4, atol 1e-6 (``tests/test_torch_port_rl.py``'s).
"""

import contextlib
import gc
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.rl.workflow_rl import _make_rl_grad

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.parallel import multihost
from graphinvent_tpu_torch.rl import step_graphs as rg
from graphinvent_tpu_torch.rl import workflow_rl as prl
from graphinvent_tpu_torch.sampling import GraphSampler
from graphinvent_tpu_torch.sampling.generator import batch_generator
from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
from graphinvent_tpu_torch.train import step_graphs as sg
from graphinvent_tpu_torch.train.optim import Adam
from graphinvent_tpu_torch.utils import cuda_graphs, weights
from graphinvent_tpu_torch.workflow import Workflow
from _torch_port_util import bias_head, jax_init

CPU = torch.device("cpu")
B = 16
MODELS = ("GGNN", "AttGGNN", "EMN")
SCORE = dict(score_components=("QED", "target_size=3"),
             score_thresholds=(0.0, 0.0), score_type="continuous",
             qsar_models={}, sigma=10.0)


def _params(jcfg, seed):
    return bias_head(jcfg, jax_init(jcfg, seed))


# --------------------------------------------------------------------------
# the gradient replay padded with inert steps
# --------------------------------------------------------------------------

_ROLLOUTS = {}


def _rollouts():
    """Two GGNN sampler batches of the port (the replay takes any
    trajectories, so they serve every model)."""
    if not _ROLLOUTS:
        pcfg = port_tiny("GGNN", device="cpu", batch_size=B)
        model = weights.model_from_jax_params(
            pcfg, _params(jax_tiny("GGNN"), 1))
        sampler = GraphSampler(pcfg, B, device=CPU)
        for key in (5, 6):
            _ROLLOUTS[key] = sampler.sample(
                model, batch_generator(key, 0, CPU), quiet=True)
    return _ROLLOUTS[5], _ROLLOUTS[6]


def _rl_batch(pcfg, agent, res, seed):
    """Targets 9-11 below the agent's log-likelihoods and a mask that is
    not all ones, as ``tests/test_torch_port_rl.py``'s."""
    rng = np.random.default_rng(seed)
    with torch.inference_mode():
        ll = trajectory_loglik(pcfg, agent, torch.from_numpy(res.actions),
                               torch.from_numpy(res.t_counts)).numpy()
    target = (ll - 10.0 + rng.normal(size=B)).astype(np.float32)
    mask = (rng.random(B) < 0.7).astype(np.float32)
    mask[:2] = (0, 1)
    return res.actions, res.t_counts, target, mask


def _loss_and_grads(pcfg, agent, batch_a, batch_b, alpha, stop):
    agent.zero_grad(set_to_none=True)
    loss = prl.rl_loss(pcfg, agent, tuple(map(torch.from_numpy, batch_a)),
                       tuple(map(torch.from_numpy, batch_b)), alpha,
                       stop=stop)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in agent.named_parameters()}


@pytest.mark.parametrize("model", MODELS)
def test_padded_gradient_replay_equals_the_replay_to_stop_and_jax(model):
    kw = dict(SCORE, job_type="fine-tune", batch_size=B, alpha=0.4,
              message_passes=1)
    jcfg = jax_tiny(model, **kw)
    pcfg = port_tiny(model, device="cpu", **kw)
    params = _params(jcfg, 1)
    agent = weights.model_from_jax_params(pcfg, params)
    res_a, res_b = _rollouts()
    batch_a = _rl_batch(pcfg, agent, res_a, 0)
    batch_b = _rl_batch(pcfg, agent, res_b, 1)
    L = res_a.actions.shape[1]
    stop = int(max(res_a.t_counts.max(), res_b.t_counts.max()))
    assert 4 < stop < L
    want_loss, want = _loss_and_grads(pcfg, agent, batch_a, batch_b, 0.4,
                                      None)
    pads = sorted({rg.bucket(stop, L), L})
    assert pads[0] >= stop and (len(pads) == 2 or stop % rg.BUCKET == 0)
    for steps in pads:
        loss, grads = _loss_and_grads(pcfg, agent, batch_a, batch_b, 0.4,
                                      steps)
        assert torch.equal(loss, want_loss), steps
        for n, g in grads.items():
            assert torch.equal(g, want[n]), (steps, n)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jloss, jgrads = _make_rl_grad(jcfg)(
        jparams, *map(jnp.asarray, batch_a), *map(jnp.asarray, batch_b),
        jnp.asarray(0.4, jnp.float32))
    jwant = weights.state_dict_from_jax_params(
        pcfg, jax.tree_util.tree_map(np.array, jgrads))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                               atol=1e-6)
    assert sorted(grads) == sorted(jwant)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jwant[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_buckets_round_up_to_a_multiple_and_stop_at_l():
    assert [rg.bucket(s, 26) for s in (0, 1, 4, 5, 14, 16, 17, 25, 26)] == \
        [4, 4, 4, 8, 16, 16, 20, 26, 26]
    assert rg.bucket(3, 3) == 3
    # the buckets a job at L=26 can take
    assert len({rg.bucket(s, 26) for s in range(27)}) == 7


# --------------------------------------------------------------------------
# the stand-in graph
# --------------------------------------------------------------------------

class _StandInGraph:
    """Captures nothing: its replay runs the captured function."""

    def __init__(self):
        self.fn = None

    def pool(self):
        return ("pool", id(self))

    def replay(self):
        self.fn()


def _stand_in_capture(graph, pool, fn):
    graph.fn = fn


@contextlib.contextmanager
def _same_stream(graph, device):
    yield []


@pytest.fixture
def stand_in(monkeypatch):
    """``rl/step_graphs`` on the CPU with the stand-in graph; the rule
    says replay."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(cuda_graphs, "captured", _stand_in_capture)
    monkeypatch.setattr(cuda_graphs, "on_capture_stream", _same_stream)
    monkeypatch.setattr(prl, "replays_steps", lambda device, mesh=None: True)


def _agent(pcfg, model, seed=2):
    return weights.model_from_jax_params(
        pcfg, _params(jax_tiny(model), seed))


def _tuner(root, name, model="GGNN", eager=False):
    job = os.path.join(str(root), name) + "/"
    os.makedirs(job)
    pcfg = port_tiny(model, device="cpu", job_type="fine-tune",
                     batch_size=B, job_dir=job, dataset_dir=job,
                     tensorboard_dir="", **SCORE)
    return prl.FineTuner(Workflow(pcfg), _agent(pcfg, model), 1,
                         _eager=eager)


class _Reads(TorchDispatchMode):
    """Counts the ops that turn a tensor into a host number."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "_local_scalar_dense" in str(func):
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_loglik_replays_equal_the_eager_replay_and_read_nothing_back(
        stand_in):
    pcfg = port_tiny("GGNN", device="cpu", batch_size=B)
    prior = prl.frozen_copy(_agent(pcfg, "GGNN"))
    res_a, res_b = _rollouts()
    graphs = rg.LoglikGraphs()
    for res in (res_a, res_b, res_a):
        stop = int(res.t_counts.max())
        want = prl.replay_loglik(pcfg, prior, res.actions, res.t_counts, CPU)
        with _Reads() as mode:
            got = graphs.loglik(pcfg, prior, res.actions, res.t_counts, stop,
                                CPU)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert mode.reads == 0
    assert (graphs.captures, len(graphs.entries)) == (1, 1)
    assert graphs.replays == (2 * int(res_a.t_counts.max())
                              + int(res_b.t_counts.max()))
    # an edit in place moves a version: a capture on the new weights
    with torch.no_grad():
        prior.APDReadout.fTermNet2.linears[-1].bias.add_(1.0)
    want = prl.replay_loglik(pcfg, prior, res_a.actions, res_a.t_counts, CPU)
    got = graphs.loglik(pcfg, prior, res_a.actions, res_a.t_counts,
                        int(res_a.t_counts.max()), CPU)
    assert np.array_equal(got, want)
    assert (graphs.captures, len(graphs.entries)) == (2, 1)


def test_a_replaced_model_captures_and_the_gone_ones_entry_is_dropped(
        stand_in):
    pcfg = port_tiny("GGNN", device="cpu", batch_size=B)
    agent = _agent(pcfg, "GGNN")
    prior, basf = prl.frozen_copy(agent), prl.frozen_copy(agent)
    res, _ = _rollouts()
    stop = int(res.t_counts.max())
    graphs = rg.LoglikGraphs()
    for _ in range(2):
        for model in (prior, basf):
            graphs.loglik(pcfg, model, res.actions, res.t_counts, stop, CPU)
    del model
    assert graphs.captures == 2
    basf = prl.frozen_copy(agent)          # the old BASF is gone
    gc.collect()
    got = graphs.loglik(pcfg, basf, res.actions, res.t_counts, stop, CPU)
    assert graphs.captures == 3 and len(graphs.entries) == 2
    assert {e.model() for e in graphs.entries} == {prior, basf}
    assert np.array_equal(got, prl.replay_loglik(pcfg, basf, res.actions,
                                                 res.t_counts, CPU))


def _files(job):
    out = {}
    for dirpath, _, names in os.walk(job):
        for name in names:
            if not name.endswith(".pth") and name != "params.csv":
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, job)] = open(path, "rb").read()
    if "generation.log" in out:       # but for the analyzer's clock
        out["generation.log"] = b"\n".join(
            line for line in out["generation.log"].splitlines()
            if b"run_time" not in line)
    return out


def _recording(tuner):
    """Records every forward-only replay's likelihoods."""
    seen, replay = [], tuner.replay

    def recorded(model, res):
        ll = replay(model, res)
        seen.append(ll)
        return ll
    tuner.replay = recorded
    return seen


@pytest.mark.parametrize("model", MODELS)
def test_fine_tune_steps_with_a_stand_in_graph_equal_the_eager_steps(
        stand_in, tmp_path, model):
    """Two steps with an evaluation after each (a better score makes a new
    BASF): the likelihoods, losses, weights, Adam's moments and step, the
    prior and BASF, and the logs equal the eager steps'."""
    graphed = _tuner(tmp_path, "graphed", model)
    eager = _tuner(tmp_path, "eager", model, eager=True)
    assert graphed.graphs is not None and eager.graphs is None
    lls = {}
    for tuner in (graphed, eager):
        lls[id(tuner)] = _recording(tuner)
        tuner.pre_evaluation()
    losses = []
    for step in (1, 2):
        losses.append((graphed.step(step), eager.step(step)))
        for tuner in (graphed, eager):
            tuner.evaluate(step)
    assert all(a == b and np.isfinite(a) for a, b in losses)
    for a, b in zip(lls[id(graphed)], lls[id(eager)]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(lls[id(graphed)]) == 4
    for a, b in ((graphed.agent, eager.agent), (graphed.basf, eager.basf),
                 (graphed.prior, eager.prior)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    assert graphed.adam.step == eager.adam.step == 2
    for x, y in zip(graphed.adam.mu + graphed.adam.nu,
                    eager.adam.mu + eager.adam.nu):
        assert torch.equal(x, y)
    assert graphed.replay_steps == eager.replay_steps
    assert sorted(graphed.step_timings[0]) == sorted(eager.step_timings[0])
    fa, fb = _files(graphed.cfg.job_dir), _files(eager.cfg.job_dir)
    assert sorted(fa) == sorted(fb) and "fine-tuning.log" in fa
    for name in fa:
        assert fa[name] == fb[name], name
    counts = graphed.graphs.counts()
    basf_copies = 1 + sum(1 for line in fa["fine-tuning.log"].splitlines()
                          [2:] if line)      # an improved evaluation each
    assert counts["loglik_replays"] == sum(graphed.replay_steps)
    assert 2 <= counts["loglik_captures"] <= 1 + basf_copies
    assert counts["grad_replays"] == 2
    assert counts["grad_captures"] == len(graphed.graphs.grad.entries)


def test_the_gradient_replays_read_nothing_back(stand_in, tmp_path):
    tuner = _tuner(tmp_path, "reads")
    tuner.step(1)
    res_a, res_b = _rollouts()
    target = np.full(B, -20.0, np.float32)
    mask = np.ones(B, np.float32)
    batches = [(r.actions, r.t_counts, target, mask) for r in (res_a, res_b)]
    tuner.graphs.grad.learn(*batches, 1e-4, 0.9)      # captures its bucket
    captures = tuner.graphs.grad.captures
    with _Reads() as mode:
        loss = tuner.graphs.grad.learn(*batches, 1e-4, 0.9)
    assert mode.reads == 0 and tuner.graphs.grad.captures == captures
    assert loss.shape == () and torch.isfinite(loss)


def test_grad_key_follows_edits_in_place_and_moves_on_what_it_cannot():
    cfg = port_tiny("GGNN", device="cpu", batch_size=B)
    model = _agent(cfg, "GGNN")
    adam = Adam(model)
    key = rg.grad_key(cfg, model, adam, (B, 26))
    with torch.no_grad():
        model.APDReadout.fTermNet2.linears[-1].bias.add_(1.0)
        adam.mu[0].add_(1.0)
    adam.step = 4
    assert rg.grad_key(cfg, model, adam, (B, 26)) == key
    lin = model.APDReadout.fTermNet2.linears[-1]
    old = lin.bias
    lin.bias = torch.nn.Parameter(old.detach().clone())
    assert rg.grad_key(cfg, model, adam, (B, 26)).weights != key.weights
    lin.bias = old
    assert rg.grad_key(cfg.replace(alpha=0.3), model, adam, (B, 26)) != key
    assert rg.grad_key(cfg, model, adam, (B, 27)) != key
    model.eval()
    assert rg.grad_key(cfg, model, adam, (B, 26)) != key


def test_loglik_key_moves_on_versions_and_workspace_drops(monkeypatch):
    cfg = port_tiny("GGNN", device="cpu", batch_size=B)
    model = prl.frozen_copy(_agent(cfg, "GGNN"))
    key = rg.loglik_key(cfg, model, (B, 26), CPU)
    assert rg.loglik_key(cfg, model, (B, 26), CPU) == key
    with torch.no_grad():
        model.APDReadout.fTermNet2.linears[-1].bias.add_(1.0)
    moved = rg.loglik_key(cfg, model, (B, 26), CPU)
    assert moved.versions != key.versions
    assert moved._replace(versions=key.versions) == key
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: None, raising=False)
    cuda_graphs.drop_library_workspaces()
    assert rg.loglik_key(cfg, model, (B, 26), CPU).workspaces == \
        moved.workspaces + 1


# --------------------------------------------------------------------------
# the rules that keep the eager step
# --------------------------------------------------------------------------

def test_the_cpu_a_mesh_two_processes_and_a_hooked_model_keep_eager(
        tmp_path, monkeypatch):
    assert _tuner(tmp_path, "cpu").graphs is None
    real = sg.replays_steps
    monkeypatch.setattr(prl, "replays_steps",
                        lambda device, mesh=None: real(
                            torch.device("cuda"), mesh))
    assert _tuner(tmp_path, "card").graphs is not None
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    assert _tuner(tmp_path, "two").graphs is None
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    job = str(tmp_path / "mesh") + "/"
    os.makedirs(job)
    wf = Workflow(port_tiny("GGNN", device="cpu", job_type="fine-tune",
                            batch_size=B, job_dir=job, dataset_dir=job,
                            tensorboard_dir="", **SCORE))
    wf.on_mesh, wf.mesh = True, SimpleNamespace(data=1, size=2)
    wf._get_sampler = lambda *args, **kw: None
    assert prl.FineTuner(wf, _agent(wf.cfg, "GGNN"), 1).graphs is None


def test_a_hooked_model_takes_the_eager_replays(stand_in, tmp_path):
    tuner = _tuner(tmp_path, "hooked")
    calls = []
    handle = tuner.prior.register_forward_hook(
        lambda module, args, out: calls.append(1))
    hook = tuner.agent.register_forward_pre_hook(lambda module, args: None)
    tuner.step(1)
    counts = tuner.graphs.counts()
    assert calls and counts["loglik_captures"] == 1    # the BASF's
    assert counts["grad_captures"] == counts["grad_replays"] == 0
    handle.remove()
    hook.remove()
    tuner.step(2)
    counts = tuner.graphs.counts()
    assert counts["loglik_captures"] == 2 and counts["grad_replays"] == 1


def test_no_cyclic_garbage_collection_runs_during_a_capture():
    """A graph freed by the collector during a capture would end it: the
    collector is off while the captured function runs, and on after, also
    where the function raises."""
    seen = []

    class Graph:
        def capture_begin(self, *pool, capture_error_mode):
            seen.append(("begin", pool, capture_error_mode))

        def capture_end(self):
            seen.append("end")

    def body():
        seen.append(gc.isenabled())
        return 7

    def fails():
        seen.append(gc.isenabled())
        raise ValueError("in the capture")

    assert gc.isenabled()
    assert cuda_graphs.captured(Graph(), ("p",), body) == 7
    with pytest.raises(ValueError, match="in the capture"):
        cuda_graphs.captured(Graph(), (), fails)
    assert gc.isenabled()
    assert seen == [("begin", ("p",), "thread_local"), False, "end",
                    ("begin", (), "thread_local"), False, "end"]
    gc.disable()
    try:
        cuda_graphs.captured(Graph(), (), body)
        assert not gc.isenabled()
    finally:
        gc.enable()
