"""The port's fine-tune job (``rl/workflow_rl.py``) on the CPU: the BASF
update, the collapse alarm, the RL random streams, the job through
``main`` after a port train job, and the pre-trained model's discovery
(``test_torch_port_rl.py`` holds the loss and a learning step against the
JAX package).

* a better evaluation makes the BASF a new frozen copy of the agent; a
  worse one keeps it; prior and BASF never alias the agent;
* the collapse alarm fires below 0.5 unique per batch (as the JAX
  package's ``test_collapse_warning_fires``);
* no RL stream shares its numbers with a generate, evaluation, dropout or
  test stream;
* the job's ``fine-tuning.log`` (a pre-fine-tuning line and one per
  evaluation), ``convergence.log``, and ``model_restart_<step>.pth`` with
  its optimizer sidecar, which the port loads and the JAX package loads to
  logits within 2e-5;
* one step of the job through ``main`` for each of the six models;
* a JAX ``.ckpt`` where the newest pre-trained model would be raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.models import apply_model
from graphinvent_tpu.utils.torch_import import load_torch_checkpoint

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.main import main as port_main
from graphinvent_tpu_torch.models import build_model
from graphinvent_tpu_torch.rl import workflow_rl as prl
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_DROPOUT, STREAM_TEST, batch_generator, seeded_generator,
)
from graphinvent_tpu_torch.utils import weights
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles
from graphinvent_tpu_torch.workflow import Workflow, eval_sample_generator
from _torch_port_util import bias_head, jax_init

CPU = torch.device("cpu")


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _equal(model, state):
    return all(torch.equal(v, state[k]) for k, v in model.state_dict().items())


def _agent(pcfg, seed):
    """A tiny GGNN whose head adds to node 0 or terminates (``bias_head``),
    so that graphs grow for a few rounds and terminate."""
    jcfg = jax_tiny("GGNN")
    params = jax_init(jcfg, seed)
    return weights.model_from_jax_params(pcfg, bias_head(jcfg, params))


def test_basf_is_replaced_by_a_new_copy_on_a_better_evaluation(tmp_path):
    job = str(tmp_path / "job") + "/"
    pcfg = port_tiny("GGNN", device="cpu", job_type="fine-tune",
                     batch_size=16, score_components=("target_size=2",),
                     score_thresholds=(0.0,), score_type="continuous",
                     qsar_models={}, job_dir=job, dataset_dir=job,
                     tensorboard_dir="")
    wf = Workflow(pcfg)
    agent = _agent(pcfg, 2)
    tuner = prl.FineTuner(wf, agent, 1)
    old = tuner.basf
    assert tuner.prior is not agent and old is not agent
    assert not any(p.requires_grad for p in tuner.prior.parameters())
    score = tuner.evaluate(1)
    assert score > 0 and tuner.best_avg_score == score
    assert tuner.basf is not old and tuner.basf is not agent
    assert _equal(tuner.basf, _state(agent))
    assert not any(p.requires_grad for p in tuner.basf.parameters())
    for name in ("model_restart_1.pth", "optimizer_restart_1.pth"):
        assert os.path.exists(os.path.join(wf.cfg.job_dir, name))
    # a worse evaluation keeps the BASF
    tuner.best_avg_score = 2.0
    kept = tuner.basf
    tuner.evaluate(2)
    assert tuner.basf is kept


def test_collapse_warning_fires(capsys):
    class NullLogger:
        def tb_scalar(self, *a, **k):
            pass

    collapsed = np.zeros(100, np.int8)
    collapsed[:2] = 1                    # 2% unique
    frac = prl._warn_on_collapse(NullLogger(), 7, collapsed)
    assert frac == pytest.approx(0.02)
    out = capsys.readouterr()
    assert "WARNING" in out.err and "uniqueness" in out.err
    assert "step 7" in out.err
    healthy = np.ones(100, np.int8)
    healthy[:5] = 0
    assert prl._warn_on_collapse(NullLogger(), 8, healthy) == pytest.approx(
        0.95)
    assert "WARNING" not in capsys.readouterr().err
    assert prl.COLLAPSE_UNIQUENESS_THRESHOLD == 0.5


def test_rl_streams_never_collide_with_other_streams():
    seed = 3
    draws = {}

    def add(key, gen):
        draws[key] = tuple(torch.rand(4, generator=gen).tolist())

    for step in range(0, 6):
        for role in range(4):
            add(("rl", step, role), prl.rl_generator(seed, step, role, CPU))
    for k in range(8):
        add(("generate", k), batch_generator(seed, k, CPU))
    for epoch in range(6):
        for b in range(3):
            add(("eval", epoch, b), eval_sample_generator(seed, epoch, b, CPU))
        add(("dropout", epoch), seeded_generator([seed, epoch], CPU,
                                                 STREAM_DROPOUT))
    add(("test",), seeded_generator([seed], CPU, STREAM_TEST))
    assert len(set(draws.values())) == len(draws)
    again = torch.rand(4, generator=prl.rl_generator(seed, 2, 1, CPU))
    assert tuple(again.tolist()) == draws[("rl", 2, 1)]


def test_step_clock_sums_the_seconds_of_each_piece(monkeypatch):
    ticks = iter([1.0, 1.5, 4.0, 4.25])
    monkeypatch.setattr(prl.time, "perf_counter", lambda: next(ticks))
    clock = prl.StepClock(CPU)
    for name in ("a", "b", "a"):
        clock.mark(name)
    assert clock.seconds() == {"a": 0.75, "b": 2.5}


# --------------------------------------------------------------------------
# the job
# --------------------------------------------------------------------------

def _run(job, data, job_type, **kw):
    os.makedirs(job, exist_ok=True)
    cfg = port_tiny("GGNN", device="cpu", job_type=job_type,
                    job_dir=job + "/", dataset_dir=data, tensorboard_dir="",
                    batch_size=16, block_size=96, n_samples=16, **kw)
    cfg.write_csv(os.path.join(job, "input.csv"))
    return port_main(["--job-dir", job])


def test_fine_tune_job_after_a_train_job(tmp_path, capsys):
    data = str(tmp_path / "data") + "/"
    os.makedirs(data)
    with open(data + "train.smi", "w") as fh:
        fh.write("SMILES\n" + "\n".join(synthesize_smiles(40, 3, 8, seed=2))
                 + "\n")
    for name in ("valid", "test"):
        with open(data + name + ".smi", "w") as fh:
            fh.write("SMILES\n" + "\n".join(synthesize_smiles(
                8, 3, 8, seed=3)) + "\n")
    pre = str(tmp_path / "train")
    _run(pre, data, "preprocess")
    _run(pre, data, "train", epochs=1)
    job = str(tmp_path / "ft")
    wf = _run(job, data, "fine-tune", epochs=2, sample_every=1,
              pretrained_model_dir=pre + "/", score_type="continuous",
              score_components=("QED", "target_size=5"),
              score_thresholds=(0.0, 0.0), qsar_models={}, sigma=10.0)
    out = capsys.readouterr().out
    assert "model_restart_1.pth" in out and "Step 2: loss" in out
    log = open(os.path.join(job, "fine-tuning.log")).read().splitlines()
    assert log[0] == "Step, Score"
    assert [l.split(",")[0] for l in log[1:]] == ["Step 1", "Step 2",
                                                   "Step 3"]
    conv = open(os.path.join(job, "convergence.log")).read().splitlines()
    assert [r.split(",")[0] for r in conv[1:]] == ["2", "3"]
    assert all(np.isfinite(float(x)) for r in conv[1:] for x in r.split(","))
    tuner = wf.fine_tuner
    assert len(tuner.step_timings) == 2 and tuner.adam.step == 2
    pieces = ["agent_rollout", "prior_replay", "basf_rollout_and_replay",
              "scoring", "grad_forward", "grad_backward", "adam"]
    assert all(list(t) == pieces and min(t.values()) >= 0
               for t in tuner.step_timings)
    assert len(tuner.replay_steps) == 4 and min(tuner.replay_steps) > 0
    # one batch a rollout: pre-evaluation, 2 x (agent, BASF, evaluation)
    assert len(wf.batch_stats) == 7

    # the checkpoint loads in the port and in the JAX package, same logits
    path = os.path.join(job, "model_restart_3.pth")
    assert os.path.exists(os.path.join(job, "optimizer_restart_3.pth"))
    pcfg = wf.cfg
    model = weights.load_checkpoint(pcfg, path)
    assert _equal(model, {k: v for k, v in
                          weights.reference_state_dict(tuner.agent).items()})
    jcfg = jax_tiny("GGNN")
    params = load_torch_checkpoint(jcfg, path)
    nodes = np.zeros((4, jcfg.max_n_nodes, jcfg.n_node_features), np.float32)
    edges = np.zeros((4, jcfg.max_n_nodes, jcfg.max_n_nodes,
                      jcfg.n_edge_features), np.float32)
    nodes[1:, 0, 0] = 1
    nodes[2:, 1, 1] = 1
    edges[2:, 0, 1, 0] = edges[2:, 1, 0, 0] = 1
    want = np.asarray(apply_model(jcfg, params, jnp.asarray(nodes),
                                  jnp.asarray(edges)))
    with torch.no_grad():
        got = model(torch.from_numpy(nodes), torch.from_numpy(edges))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("model", ["MNN", "S2V", "AttS2V", "GGNN", "AttGGNN",
                                   "EMN"])
def test_fine_tune_job_runs_for_every_model(tmp_path, model):
    """One step of each model's fine-tune job through ``main`` on the CPU,
    from a seeded pre-trained model in ``dataset_dir``."""
    job = str(tmp_path / "job")
    os.makedirs(job)
    cfg = port_tiny(model, device="cpu", job_type="fine-tune",
                    job_dir=job + "/", dataset_dir=job + "/",
                    pretrained_model_dir=str(tmp_path / "none") + "/",
                    batch_size=8, epochs=1, sample_every=1,
                    score_components=("target_size=3",),
                    score_thresholds=(0.0,), qsar_models={},
                    tensorboard_dir="")
    cfg.write_csv(os.path.join(job, "input.csv"))
    torch.save(weights.reference_state_dict(
        build_model(cfg, torch.Generator().manual_seed(1))),
        os.path.join(job, "pretrained_model.pth"))
    wf = port_main(["--job-dir", job])
    assert wf.fine_tuner.adam.step == 1 and wf.fine_tuner.start_step == 1
    conv = open(os.path.join(job, "convergence.log")).read().splitlines()
    assert len(conv) == 2 and np.isfinite(float(conv[1].split(",")[2]))
    assert os.path.exists(os.path.join(job, "model_restart_1.pth"))


def test_a_jax_ckpt_pretrained_model_raises(tmp_path):
    pre = tmp_path / "pre"
    os.makedirs(pre)
    (pre / "model_restart_4.ckpt").write_bytes(b"")
    cfg = port_tiny("GGNN", device="cpu",
                    pretrained_model_dir=str(pre) + "/",
                    dataset_dir=str(tmp_path) + "/")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prl.find_pretrained(cfg)
    # a .pth of the same epoch is taken; an older one is not
    (pre / "model_restart_3.pth").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ckpt"):
        prl.find_pretrained(cfg)
    (pre / "model_restart_4.pth").write_bytes(b"")
    assert prl.find_pretrained(cfg) == (str(pre / "model_restart_4.pth"), 4)
    # the dataset dir's pretrained_model.ckpt raises as well
    cfg = cfg.replace(pretrained_model_dir=str(tmp_path / "none") + "/")
    (tmp_path / "pretrained_model.ckpt").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prl.find_pretrained(cfg)
    (tmp_path / "pretrained_model.pth").write_bytes(b"")
    assert prl.find_pretrained(cfg) == (
        str(tmp_path / "pretrained_model.pth"), 0)
