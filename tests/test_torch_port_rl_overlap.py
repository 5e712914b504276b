"""The overlapped fine-tune step (``FineTuner.step``: host scoring on a
worker thread beside the replays and the BASF rollout) and the sampler's
``sample_async`` / ``finish`` on the CPU.

* ``sample_async`` + ``finish`` give ``sample``'s batch byte for byte, and
  ``sample_packed`` its buffer;
* the overlapped step is bit-equal to the same step composed from
  ``rollout`` / ``replay`` / ``learn`` one piece after another: the loss,
  the agent's weights after Adam, Adam's moments, and the files
  (``fine-tuning.log``, ``convergence.log``, the generation log);
* the agent batch's scoring really runs beside the BASF rollout: a scorer
  that waits (30-s timeout) on an event the BASF rollout sets finishes,
  and runs without autograd; in sequence it would fail on the timeout;
* an exception raised in the worker's scoring comes out of ``step``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from graphinvent_tpu.config import test_config as jax_tiny

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.rl import workflow_rl as prl
from graphinvent_tpu_torch.sampling.generator import (
    GraphSampler, batch_generator,
)
from graphinvent_tpu_torch.utils import weights
from graphinvent_tpu_torch.workflow import Workflow
from _torch_port_util import bias_head, jax_init

CPU = torch.device("cpu")
SCORE = dict(score_components=("QED", "target_size=3"),
             score_thresholds=(0.0, 0.0), score_type="continuous",
             qsar_models={}, sigma=10.0)


def _agent(pcfg, seed=2):
    jcfg = jax_tiny("GGNN")
    return weights.model_from_jax_params(pcfg,
                                         bias_head(jcfg, jax_init(jcfg, seed)))


def _tuner(root, name):
    job = os.path.join(str(root), name) + "/"
    os.makedirs(job)
    pcfg = port_tiny("GGNN", device="cpu", job_type="fine-tune",
                     batch_size=16, job_dir=job, dataset_dir=job,
                     tensorboard_dir="", **SCORE)
    return prl.FineTuner(Workflow(pcfg), _agent(pcfg), 1)


def _sequential_step(tuner, step):
    res_a = tuner.rollout(tuner.agent, step, prl.ROLE_AGENT)
    prior_ll = tuner.replay(tuner.prior, res_a)
    res_b = tuner.rollout(tuner.basf, step, prl.ROLE_BASF)
    basf_ll = tuner.replay(tuner.basf, res_b)
    return tuner.learn(step, res_a, prior_ll, res_b, basf_ll)


def _files(job):
    out = {}
    for dirpath, _, names in os.walk(job):
        for name in names:
            if not name.endswith(".pth"):
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, job)] = open(path, "rb").read()
    return out


def test_sample_async_and_finish_are_sample():
    cfg = port_tiny("GGNN", device="cpu")
    model = _agent(cfg)
    sampler = GraphSampler(cfg, 12, device=CPU)
    handle = sampler.sample_async(model, batch_generator(0, 3, CPU))
    assert handle.copied is None and handle.packed.device == CPU
    got = sampler.finish(handle, quiet=True)
    want = sampler.sample(model, batch_generator(0, 3, CPU), quiet=True)
    for k in ("actions", "t_counts", "final_loglikelihoods",
              "properly_terminated", "done", "action_nlls"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.n_rounds == want.n_rounds > 1
    assert [g.n_nodes for g in got.graphs] == [g.n_nodes for g in want.graphs]
    np.testing.assert_array_equal(
        sampler.sample_packed(model, batch_generator(0, 3, CPU)),
        handle.packed.numpy())


def test_overlapped_step_is_the_sequential_composition(tmp_path):
    over, seq = _tuner(tmp_path, "over"), _tuner(tmp_path, "seq")
    for tuner in (over, seq):
        tuner.pre_evaluation()
    losses = []
    for step in (1, 2):
        losses.append((over.step(step), _sequential_step(seq, step)))
        for tuner in (over, seq):
            tuner.evaluate(step)
    for a, b in losses:
        assert a == b and np.isfinite(a)
    assert sum(over.basf_gated) == sum(seq.basf_gated)
    for a, b in ((over.agent, seq.agent), (over.basf, seq.basf),
                 (over.prior, seq.prior)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    ma, mb = over.adam.state_dict(), seq.adam.state_dict()
    assert all(torch.equal(ma["mu"][k], mb["mu"][k]) for k in ma["mu"])
    assert all(torch.equal(ma["nu"][k], mb["nu"][k]) for k in ma["nu"])
    fa, fb = _files(over.cfg.job_dir), _files(seq.cfg.job_dir)
    assert sorted(fa) == sorted(fb)
    assert {"fine-tuning.log", "convergence.log", "generation.log",
            "generation/epoch_agent_Step_2_agent.smi"} <= set(fa)
    for name in set(fa) - {"params.csv"}:     # params.csv names the dir
        a, b = fa[name], fb[name]
        if name == "generation.log":          # but for the analyzer's clock
            a, b = (b"\n".join(line for line in x.splitlines()
                               if b"run_time" not in line) for x in (a, b))
        assert a == b, name
    assert len(over.scoring_waits) == len(over.step_timings) == 2
    assert all(w >= 0 for w in over.scoring_waits)


def test_agent_scoring_runs_beside_the_basf_rollout(tmp_path):
    tuner = _tuner(tmp_path, "job")
    basf_started = threading.Event()
    seen = []
    inner_rollout, inner_score = tuner.rollout, tuner.scoring.compute_score

    def rollout(model, step, role):
        if role == prl.ROLE_BASF:
            basf_started.set()
        return inner_rollout(model, step, role)

    def compute_score(*a, **k):
        if not seen:         # the agent's batch: wait for the BASF rollout
            if not basf_started.wait(timeout=30):
                raise TimeoutError("the BASF rollout never started while "
                                   "the agent batch was scored")
        seen.append((threading.current_thread() is not
                     threading.main_thread(), torch.is_grad_enabled()))
        return inner_score(*a, **k)

    tuner.rollout = rollout
    tuner.scoring.compute_score = compute_score
    loss = tuner.step(1)
    assert np.isfinite(loss)
    assert seen == [(True, False), (True, False)]   # worker, no autograd
    assert tuner.scoring_waits[0] >= 0


def test_an_exception_in_the_workers_scoring_comes_out_of_step(tmp_path):
    tuner = _tuner(tmp_path, "job")

    def broken(*a, **k):
        raise RuntimeError("scoring failed on the worker")

    tuner.scoring.compute_score = broken
    with pytest.raises(RuntimeError, match="scoring failed on the worker"):
        tuner.step(1)
    assert tuner.adam.step == 0 and not tuner.step_timings
