"""The port's RL loss and learning step (``rl/workflow_rl.py``) against
the JAX package's ``rl/workflow_rl.py`` on bridged weights, on the CPU
(``test_torch_port_rl_job.py`` has the rest of the fine-tune job).

* ``rl_loss`` and its gradient against ``_make_rl_grad(cfg)`` for GGNN,
  AttGGNN and EMN, on sampled trajectories with masks that are not all
  ones: loss and every gradient leaf rtol 1e-4, atol 1e-6;
* one learning step on the same agent, prior and BASF weights and the same
  two rollouts (fed as data: the random streams differ), with the BASF
  gate, then Adam + OneCycle: the agent's weights equal JAX's
  ``adam_update`` result (rtol 1e-4, atol 1e-6) wherever the gradient lies
  above its f32 rounding (1e-6 of its leaf's largest; elsewhere both moved
  by at most lr, Adam's step on a gradient of rounding); the prior and the
  BASF are byte-equal to before; the fused wrappers' weight caches follow
  each model's own weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.eval.analyzer import Analyzer as JaxAnalyzer
from graphinvent_tpu.eval.scoring import ScoringFunction as JaxScoring
from graphinvent_tpu.rl.workflow_rl import (
    _make_adam, _make_loglik, _make_rl_grad,
)
from graphinvent_tpu.sampling import GraphSampler as JaxSampler
from graphinvent_tpu.train.optim import adam_init
from graphinvent_tpu.train.optim import onecycle_for_config as jax_onecycle
from graphinvent_tpu.utils.logging import JobLogger as JaxLogger

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.models import fused_enn
from graphinvent_tpu_torch.models.core import stacked_layers
from graphinvent_tpu_torch.rl import workflow_rl as prl
from graphinvent_tpu_torch.sampling import GraphSampler
from graphinvent_tpu_torch.sampling.generator import batch_generator
from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
from graphinvent_tpu_torch.utils import weights
from graphinvent_tpu_torch.workflow import Workflow
from _torch_port_util import bias_head, jax_init

CPU = torch.device("cpu")
B = 16
SCORE = dict(score_components=("target_size=4",), score_thresholds=(0.0,),
             score_type="continuous", qsar_models={})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _params(cfg, seed):
    return bias_head(cfg, jax_init(cfg, seed))


def _cfgs(model="GGNN", **kw):
    # one message pass: the loss and the step do not depend on the count,
    # and the JAX package compiles each pass anew
    kw = dict(SCORE, job_type="fine-tune", batch_size=B, sigma=4.0,
              alpha=0.4, message_passes=1, **kw)
    return jax_tiny(model, **kw), port_tiny(model, device="cpu", **kw)


_ROLLOUTS = {}


def _rollouts():
    """Two GGNN sampler batches of the port (the replay takes any
    trajectories, so they serve every model): per batch its packed buffer
    and the JAX package's decode of it (the two samplers pack one layout)."""
    if not _ROLLOUTS:
        jcfg, pcfg = _cfgs()
        model = weights.model_from_jax_params(pcfg, _params(jcfg, 1))
        sampler = GraphSampler(pcfg, B, device=CPU)
        for key in (5, 6):
            packed = sampler.sample_packed(model,
                                           batch_generator(key, 0, CPU))
            _ROLLOUTS[key] = (packed, JaxSampler(jcfg, B)._decode_packed(
                packed, 0.0, True))
    return _ROLLOUTS[5], _ROLLOUTS[6]


_JITTED = {}


def _jax_fn(make, jcfg):
    """One jitted JAX function per maker and model for the whole file (the
    configs here differ in nothing these functions read)."""
    key = (make.__name__, jcfg.model)
    if key not in _JITTED:
        _JITTED[key] = make(jcfg)
    return _JITTED[key]


def _rl_batch(pcfg, agent, res, seed):
    """Targets 9-11 below the agent's own log-likelihoods (a gradient well
    above the one that the f32 rounding of a log-likelihood of ~-20 makes),
    and a mask that is not all ones."""
    rng = np.random.default_rng(seed)
    with torch.inference_mode():
        ll = trajectory_loglik(pcfg, agent, torch.from_numpy(res.actions),
                               torch.from_numpy(res.t_counts)).numpy()
    target = (ll - 10.0 + rng.normal(size=B)).astype(np.float32)
    mask = (rng.random(B) < 0.7).astype(np.float32)
    mask[:2] = (0, 1)
    return res.actions, res.t_counts, target, mask


@pytest.mark.parametrize("model", ["GGNN", "AttGGNN", "EMN"])
def test_rl_loss_and_gradient_equal_jax(model):
    jcfg, pcfg = _cfgs(model)
    params = _params(jcfg, 1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (_, res_a), (_, res_b) = _rollouts()
    assert res_a.t_counts.max() > 4 and res_b.t_counts.max() > 4
    agent = weights.model_from_jax_params(pcfg, params)
    batch_a = _rl_batch(pcfg, agent, res_a, 0)
    batch_b = _rl_batch(pcfg, agent, res_b, 1)
    alpha = 0.4
    want_loss, want_grads = _jax_fn(_make_rl_grad, jcfg)(
        jparams, *map(jnp.asarray, batch_a), *map(jnp.asarray, batch_b),
        jnp.asarray(alpha, jnp.float32))
    want = weights.state_dict_from_jax_params(pcfg, _np_tree(want_grads))

    loss = prl.rl_loss(pcfg, agent, tuple(map(torch.from_numpy, batch_a)),
                       tuple(map(torch.from_numpy, batch_b)), alpha)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4,
                               atol=1e-6)
    named = dict(agent.named_parameters())
    assert sorted(named) == sorted(want)
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    assert max(float(g.abs().max()) for g in want.values()) > 1e-3


def _workflow(tmp_path, pcfg):
    job = str(tmp_path / "job")
    return Workflow(pcfg.replace(job_dir=job + "/", dataset_dir=job + "/",
                                 tensorboard_dir=""))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _equal(model, state):
    return all(torch.equal(v, state[k]) for k, v in model.state_dict().items())


def test_one_learning_step_equals_jax(tmp_path):
    """Agent, prior and BASF with weights of their own, the same two
    rollouts, the BASF gate at 0.3: one step in each package."""
    jcfg, pcfg = _cfgs(init_lr=1e-3, epochs=4)
    agent_p, prior_p, basf_p = (_params(jcfg, s) for s in (1, 2, 3))
    jx = {k: jax.tree_util.tree_map(jnp.asarray, p) for k, p in
          (("agent", agent_p), ("prior", prior_p), ("basf", basf_p))}
    step, best = 1, 0.3
    wf = _workflow(tmp_path, pcfg)
    port = {role: (GraphSampler(pcfg, B, device=CPU)._decode_packed(
        packed, 0.0, True), jres)
        for role, (packed, jres) in zip("ab", _rollouts())}

    # the JAX package's step (workflow_rl.learning_phase, one iteration)
    logger = JaxLogger(str(tmp_path / "jax") + "/")
    analyzer = JaxAnalyzer(jcfg, logger)
    scoring = JaxScoring(jcfg)
    loglik = _jax_fn(_make_loglik, jcfg)

    def jax_side(res, params, write):
        ll = np.asarray(loglik(params, jnp.asarray(res.actions),
                               jnp.asarray(res.t_counts)))
        valid, unique, _ = analyzer.evaluate_generated_graphs(
            res.graphs, res.properly_terminated, res.final_loglikelihoods,
            epoch_key="Step 1", write=write, plot=False)
        return ll, scoring.compute_score(res.graphs, res.properly_terminated,
                                         valid, unique), unique

    prior_ll, scores_a, unique_a = jax_side(port["a"][1], jx["prior"], False)
    basf_ll, scores_b, unique_b = jax_side(port["b"][1], jx["basf"], False)
    assert 0 < (scores_b > best).sum() < B and scores_a.max() > 0
    unique_b = np.where(scores_b > best, unique_b, 0)
    loss, grads = _jax_fn(_make_rl_grad, jcfg)(
        jx["agent"], jnp.asarray(port["a"][1].actions),
        jnp.asarray(port["a"][1].t_counts),
        jnp.asarray(prior_ll + jcfg.sigma * scores_a, jnp.float32),
        jnp.asarray(unique_a != 0, jnp.float32),
        jnp.asarray(port["b"][1].actions), jnp.asarray(port["b"][1].t_counts),
        jnp.asarray(basf_ll - jcfg.sigma * scores_b, jnp.float32),
        jnp.asarray(unique_b != 0, jnp.float32), jcfg.alpha)
    opt = adam_init(jx["agent"])
    lr, beta1 = jax_onecycle(jcfg, 1)(opt.step)
    new_params, _ = _make_adam(jcfg)(grads, opt, jx["agent"], lr, beta1)
    want = weights.state_dict_from_jax_params(pcfg, _np_tree(new_params))
    want_grad = weights.state_dict_from_jax_params(pcfg, _np_tree(grads))

    # the port's step on the same weights and rollouts
    tuner = prl.FineTuner(wf, weights.model_from_jax_params(pcfg, agent_p), 1)
    tuner.prior = prl.frozen_copy(weights.model_from_jax_params(pcfg, prior_p))
    tuner.basf = prl.frozen_copy(weights.model_from_jax_params(pcfg, basf_p))
    tuner.best_avg_score = best
    prior0, basf0, agent0 = (_state(tuner.prior), _state(tuner.basf),
                             _state(tuner.agent))
    # fill every model's weight cache before the step
    x = torch.randn(3, pcfg.hidden_node_features)
    caches = {}
    for name in ("agent", "prior", "basf"):
        m = getattr(tuner, name)
        with torch.inference_mode():
            caches[name] = fused_enn.fused_stacked_mlp(m.msg_nns, x[None])
    p_ll = tuner.replay(tuner.prior, port["a"][0])
    b_ll = tuner.replay(tuner.basf, port["b"][0])
    np.testing.assert_allclose(p_ll, prior_ll, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b_ll, basf_ll, rtol=1e-4, atol=1e-5)
    got_loss = tuner.learn(step, port["a"][0], p_ll, port["b"][0], b_ll)

    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4, atol=1e-6)
    assert tuner.adam.step == 1
    assert tuner.basf_gated == [int((unique_b != 0).sum())]
    n_noise = n_all = 0
    for n, p in tuner.agent.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        # Adam's first step moves an entry by ~lr * sign(gradient): where
        # the gradient lies within its f32 rounding of 0 in both packages,
        # the sign is rounding's, and the entry only has to have moved by
        # at most lr in each
        g, wg = p.grad.abs().numpy(), want_grad[n].abs().numpy()
        floor = 1e-6 * float(wg.max())
        noise = (g <= floor) & (wg <= floor) & ((g > 0) | (wg > 0))
        np.testing.assert_allclose(got[~noise], w[~noise], rtol=1e-4,
                                   atol=1e-6, err_msg=n)
        start = agent0[n].numpy()
        assert (np.abs(got - start)[noise] <= 1.001 * float(lr)).all(), n
        assert (np.abs(w - start)[noise] <= 1.001 * float(lr)).all(), n
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise <= 0.02 * n_all, (n_noise, n_all)     # 221 of 40,821
    assert not _equal(tuner.agent, agent0)
    assert _equal(tuner.prior, prior0) and _equal(tuner.basf, basf0)
    # each model's grad-free forward sees its own, current weights
    for name in ("agent", "prior", "basf"):
        m = getattr(tuner, name)
        with torch.inference_mode():
            got = fused_enn.fused_stacked_mlp(m.msg_nns, x[None])
            fresh = fused_enn.fused_stacked_mlp_reference(
                fused_enn.flatten_weights(stacked_layers(list(m.msg_nns)),
                                          torch.float32, CPU), x)
        assert torch.equal(got[:, 0], fresh)
        assert torch.equal(got, caches[name]) == (name != "agent")
    log = open(os.path.join(wf.cfg.job_dir, "convergence.log")).read()
    assert log.splitlines()[1].startswith("1, ")
