"""The port's trajectory replay (``sampling/replay.py``) against the JAX
package's ``trajectory_loglik`` on bridged weights, on the CPU.

* the actions and ``t_counts`` of one JAX sampler batch, replayed under
  each of the six models (packed and dense where a model has both) by both
  packages: per-row log-likelihoods within rtol 1e-4, atol 1e-5, under
  autograd (the plain path, rematerialised) and grad-free (the kernel's
  wrappers, whose plain version runs on a CPU tensor).  The JAX package
  runs all L steps; the port stops after max(t_counts);
* the port's replay of the port sampler's own batch equals the batch's
  summed ``ll`` (atol 1e-5);
* ``rl_remat_segment`` 1, 2, 3 and 40 give one gradient (rtol 1e-6), and a
  replay under autograd reaches no fused wrapper, neither in its forward
  nor in the backward's recompute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.sampling import GraphSampler as JaxSampler
from graphinvent_tpu.sampling.replay import trajectory_loglik as jax_replay

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.sampling import GraphSampler
from graphinvent_tpu_torch.sampling.generator import batch_generator
from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
from graphinvent_tpu_torch.utils import weights
from _torch_port_util import bias_head, jax_init

CPU = torch.device("cpu")
FORMS = [("GGNN", True), ("MNN", True), ("S2V", True), ("AttS2V", True),
         ("AttS2V", False), ("AttGGNN", True), ("AttGGNN", False),
         ("EMN", True), ("EMN", False)]
IDS = [f"{m}-{'packed' if p else 'dense'}" for m, p in FORMS]
B = 16


def _pair(model, packed=True, seed=3):
    # one message pass: the replay does not depend on the count, and the
    # JAX package compiles each pass anew
    jcfg = jax_tiny(model, emn_packed=packed, message_passes=1)
    pcfg = port_tiny(model, device="cpu", emn_packed=packed, message_passes=1)
    params = bias_head(jcfg, jax_init(jcfg, seed), add_nodes=3, term=3.0)
    return jcfg, params, pcfg, weights.model_from_jax_params(pcfg, params)


_BATCH = {}


def _jax_batch():
    """Actions and t_counts of one JAX GGNN sampler batch (the replay takes
    any trajectories; one batch serves every model)."""
    if not _BATCH:
        jcfg, params, _, _ = _pair("GGNN", seed=11)
        res = JaxSampler(jcfg, B).sample(params, jax.random.PRNGKey(5),
                                         quiet=True)
        _BATCH["a"] = (res.actions, res.t_counts)
    return _BATCH["a"]


@pytest.mark.parametrize("model,packed", FORMS, ids=IDS)
def test_replay_equals_jax(model, packed):
    actions, t_counts = _jax_batch()
    assert t_counts.max() > 4 and t_counts.max() < actions.shape[1]
    jcfg, params, pcfg, port_model = _pair(model, packed)
    want = np.asarray(jax_replay(jcfg, jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(actions), jnp.asarray(t_counts)))
    a, t = torch.from_numpy(actions), torch.from_numpy(t_counts)
    got = trajectory_loglik(pcfg, port_model, a, t)
    assert got.requires_grad and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    with torch.inference_mode():
        fused = trajectory_loglik(pcfg, port_model, a, t)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-4, atol=1e-5)
    assert (want < 0).all()


def test_replay_of_the_port_samplers_batch_equals_its_ll():
    _, _, pcfg, model = _pair("GGNN", seed=2)
    res = GraphSampler(pcfg, 32, device=CPU).sample(
        model, batch_generator(2, 0, CPU), quiet=True)
    assert res.t_counts.max() > 4
    with torch.inference_mode():
        ll = trajectory_loglik(pcfg, model, torch.from_numpy(res.actions),
                               torch.from_numpy(res.t_counts))
    np.testing.assert_allclose(ll.numpy(), res.final_loglikelihoods,
                               rtol=0, atol=1e-5)


def _grads(cfg, model, actions, t_counts, w):
    model.zero_grad()
    ll = trajectory_loglik(cfg, model, actions, t_counts)
    (ll * w).sum().backward()
    return ll.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("model", ["GGNN", "EMN"])
def test_remat_segments_give_one_gradient_and_launch_nothing(model,
                                                             monkeypatch):
    actions, t_counts = map(torch.from_numpy, _jax_batch())
    _, _, pcfg, port_model = _pair(model)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=B)
                         .astype(np.float32))
    calls = []
    dispatch = fused_enn._dispatch
    monkeypatch.setattr(fused_enn, "_dispatch",
                        lambda *a: calls.append(1) or dispatch(*a))
    ll1, g1 = _grads(pcfg.replace(rl_remat_segment=1), port_model, actions,
                     t_counts, w)
    assert not calls, "a replay under autograd took the fused wrappers"
    for seg in (2, 3, 40):
        ll, g = _grads(pcfg.replace(rl_remat_segment=seg), port_model,
                       actions, t_counts, w)
        np.testing.assert_allclose(ll.numpy(), ll1.numpy(), rtol=1e-6)
        for n in g1:
            np.testing.assert_allclose(g[n].numpy(), g1[n].numpy(),
                                       rtol=1e-6, atol=1e-12, err_msg=n)
    assert not calls
    assert any(g.abs().max() > 0 for g in g1.values())
    with torch.inference_mode():
        trajectory_loglik(pcfg, port_model, actions, t_counts)
    assert calls, "the grad-free replay did not take the fused wrappers"


def test_steps_after_the_last_real_action_are_inert():
    """Actions past t_counts (whatever their ids) change nothing, so the
    loop may stop at max(t_counts)."""
    actions, t_counts = _jax_batch()
    _, _, pcfg, model = _pair("GGNN")
    junk = actions.copy()
    L = actions.shape[1]
    past = np.arange(L)[None, :] >= t_counts[:, None]
    junk[past] = np.random.default_rng(1).integers(0, pcfg.dim_apd,
                                                   past.sum())
    with torch.inference_mode():
        a = trajectory_loglik(pcfg, model, torch.from_numpy(actions),
                              torch.from_numpy(t_counts))
        b = trajectory_loglik(pcfg, model, torch.from_numpy(junk),
                              torch.from_numpy(t_counts))
        empty = trajectory_loglik(pcfg, model, torch.from_numpy(actions),
                                  torch.zeros(B, dtype=torch.long))
    assert torch.equal(a, b)
    assert torch.equal(empty, torch.zeros(B))
