"""RL fine-tuning: agent, prior and best agent so far (BASF).

Counterpart of ``graphinvent_tpu/rl/workflow_rl.py`` (reference
Workflow.learning_phase + learning_step, Workflow.py:515-612, and the
augmented-likelihood loss, Workflow.py:862-898):

  loss_i = (agent_ll_i - (prior_ll_i + sigma * score_i))^2 * unique_i
  loss   = (1 - alpha) * mean(loss_agent_batch) + alpha * mean(loss_basf_batch)

Gradients reach the agent through the differentiable replay of the sampled
actions (``sampling/replay.py``), not through the sampling loop.

The three models are three modules.  In the JAX package the prior and the
BASF are the agent's parameter pytree at some moment (``prior = agent``),
which is a snapshot because pytrees are immutable; here the same
assignment would alias the agent, whose parameters Adam updates in place.
So the prior is a frozen deep copy made once, and every BASF update makes a
new frozen deep copy of the agent.  Each module keeps its own weight cache
for the fused kernel (``models/fused_enn._cached_flat``, keyed on the
parameters' addresses and versions), so each forward sees its own model's
current weights.

A step runs the JAX package's work in its order
(``graphinvent_tpu/rl/workflow_rl.py:241-264``): the agent's rollout; the
agent batch's host scoring (analyzer + scoring function) on a worker
thread while the main thread runs the prior's replay and the BASF's
rollout; then the BASF batch's scoring on the worker while its replay
runs; the gradient replay and Adam.  The JAX step gets its overlap from
``sample_async``; here the rollout (``GraphSampler.sample``, which is
``finish(sample_async(...))``) reads ``done`` on the host every round and
so cannot run ahead of the host, and the worker thread gives the overlap
instead.  One worker keeps the analyzer's writes in order (the agent's
first).  ``FineTuner.learn`` is the same step with the scoring in
sequence, for callers that run the pieces themselves; both give the same
bytes.  The rollouts and the two forward-only replays take the fused
kernel; the gradient replay takes the plain path.  On a card, in one
process with no mesh, the forward-only replays and the gradient replay
with Adam are replays of captured CUDA graphs (``rl/step_graphs.py``;
``FineTuner(..., _eager=True)`` keeps the eager step), as the JAX package
runs them as compiled programs.
``FineTuner.step_timings`` holds each piece's seconds per step: on a
card, between CUDA events recorded where each piece ends and read once the
step's loss is on the host, so the marks never stall the queue;
``FineTuner.scoring_waits`` the host seconds the main thread waited for
the worker in each overlapped step.

On one process's mesh (the JAX package's single-process mesh fine-tune,
``graphinvent_tpu/rl/workflow_rl.py:195-218``) every rank runs the step:
the rollouts' rows split over ``data`` (``sampling/generator``, every rank
then holds the whole batch), the forward-only replays and the gradient
replay take this rank's trajectory rows under ``edge_sharding`` (nodes
over ``graph``), the replays' likelihoods are gathered over ``data`` and
the gradients summed over every rank (``parallel/mesh.py``).  Rank 0
alone scores and writes; the scores, and so the targets, masks and the
best score, go to every rank, broadcast from the main thread after the
worker's join (a collective from the worker would pair with the replay's
on the other ranks).  The parameters stay whole, as in the JAX
package (no head split in the fine-tune job).
"""

from __future__ import annotations

import copy
import os
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.models.annotate import edge_sharding
from graphinvent_tpu_torch.parallel import multihost
from graphinvent_tpu_torch.parallel.mesh import (
    sum_gradients_, data_rows, gather_data_rows,
)
from graphinvent_tpu_torch.eval.analyzer import Analyzer
from graphinvent_tpu_torch.eval.scoring import ScoringFunction
from graphinvent_tpu_torch.rl.step_graphs import FineTuneGraphs
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_FINE_TUNE, SampleResult, seeded_generator,
)
from graphinvent_tpu_torch.sampling.replay import trajectory_loglik
from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
from graphinvent_tpu_torch.train.step_graphs import (
    keeps_eager_step, replays_steps,
)
from graphinvent_tpu_torch.utils.weights import (
    latest_checkpoint, load_checkpoint, save_checkpoint,
)

# what a fine-tune rollout is for: the third entry of its seed sequence
ROLE_AGENT, ROLE_BASF, ROLE_EVALUATE, ROLE_PRE_FINE_TUNING = range(4)

# fraction-unique below this trips the collapse warning: healthy
# fine-tuning stays > 0.8 unique per batch; a collapsing agent (seen at
# N=40 with the reference's default sigma and lr) falls from 0.95 to 0.02
# within ~40 steps
COLLAPSE_UNIQUENESS_THRESHOLD = 0.5

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def rl_generator(seed: int, step: int, role: int, device: torch.device
                 ) -> torch.Generator:
    """The generator of the ``role`` rollout of fine-tune step ``step``.
    Its own stream tag keeps it apart from every generate, evaluation,
    dropout and test stream; (step, role) keeps the rollouts of one job
    apart."""
    return seeded_generator([seed, step, role], device, STREAM_FINE_TUNE)


def rl_loss(cfg: GraphInventConfig, agent: nn.Module, batch_a: Batch,
            batch_b: Batch, alpha: float,
            apply_fn: Optional[Callable] = None,
            stop: Optional[int] = None) -> torch.Tensor:
    """The combined loss (a scalar, differentiable in the agent's
    parameters).  ``batch_a`` / ``batch_b``: (actions (B, L), t_counts
    (B,), target (B,), mask (B,)) of the agent's and the BASF's rollout on
    the agent's device; ``apply_fn`` and ``stop`` (both replays' steps) as
    in ``trajectory_loglik``.  Two B-row replays, not one 2B-row replay, as
    in the JAX package."""
    actions_a, t_a, target_a, mask_a = batch_a
    actions_b, t_b, target_b, mask_b = batch_b
    diff_a = (trajectory_loglik(cfg, agent, actions_a, t_a, apply_fn, stop)
              - target_a)
    loss_a = torch.mean(diff_a * diff_a * mask_a)
    # BASF term: the agent enters as "prior" (model_b); the gradient flows
    # through its log-likelihood of BASF's samples (Workflow.py:588-595)
    diff_b = target_b - trajectory_loglik(cfg, agent, actions_b, t_b,
                                          apply_fn, stop)
    loss_b = torch.mean(diff_b * diff_b * mask_b)
    return (1.0 - alpha) * loss_a + alpha * loss_b


def sharded_rl_backward(cfg: GraphInventConfig, agent: nn.Module,
                        adam: Adam, batch_a: Batch, batch_b: Batch,
                        alpha: float, mesh,
                        clock: Optional["StepClock"] = None) -> torch.Tensor:
    """The gradient of ``rl_loss`` of the global batches on one process's
    mesh, into every rank's ``adam.params``: this rank's trajectory rows
    (``data``) under ``edge_sharding``, their loss over the ranks that
    compute each row, and the gradients summed over every rank
    (``parallel/mesh.py``); -> the global loss."""
    rows = data_rows(len(batch_a[0]), mesh)
    with edge_sharding(mesh):
        # this rank's rows: their mean is 1 / data of the global mean,
        # and model x graph ranks compute each row
        loss = rl_loss(cfg, agent, tuple(t[rows] for t in batch_a),
                       tuple(t[rows] for t in batch_b), alpha) / mesh.size
        if clock is not None:
            clock.mark("grad_forward")
        # the replay's rematerialised forwards run in the backward
        loss.backward()
    if clock is not None:
        clock.mark("grad_backward")
    loss = loss.detach().reshape(1)
    sum_gradients_(adam.params, adam.names, [loss], agent, mesh)
    return loss[0]


def replay_loglik(cfg: GraphInventConfig, model: nn.Module,
                  actions: np.ndarray, t_counts: np.ndarray,
                  device: torch.device, mesh=None) -> np.ndarray:
    """Forward-only replay (the prior's and the BASF's likelihoods, data
    for the loss targets): (B,) float32 on the host.  Grad-free, so every
    forward takes the fused kernel on a CUDA device.  On ``mesh``: this
    rank's rows, nodes over ``graph``, every row's value on every rank."""
    with torch.inference_mode():
        if mesh is None:
            ll = trajectory_loglik(cfg, model,
                                   torch.from_numpy(actions).to(device),
                                   torch.from_numpy(t_counts).to(device))
        else:
            rows = data_rows(len(actions), mesh)
            with edge_sharding(mesh):
                ll = trajectory_loglik(
                    cfg, model, torch.from_numpy(actions[rows]).to(device),
                    torch.from_numpy(t_counts[rows]).to(device))
            ll = gather_data_rows(ll, mesh)
        return ll.cpu().numpy()


def _warn_on_collapse(logger, step: int, unique: np.ndarray) -> float:
    """Loud mode-collapse alarm on the agent rollout's batch uniqueness."""
    frac = float(np.mean(np.asarray(unique) != 0))
    if frac < COLLAPSE_UNIQUENESS_THRESHOLD:
        msg = (f"*** WARNING step {step}: batch uniqueness {frac:.3f} < "
               f"{COLLAPSE_UNIQUENESS_THRESHOLD} -- the agent is likely "
               f"mode-collapsing. Lower init_lr / sigma or use binary "
               f"scoring; consider restarting from the last good "
               f"checkpoint. ***")
        print(msg, file=sys.stderr, flush=True)
        print(msg, flush=True)
        logger.tb_scalar("Fine-tuning/uniqueness_collapse", frac, step)
    return frac


def frozen_copy(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` that no optimizer and no backward touches."""
    out = copy.deepcopy(model)
    out.requires_grad_(False)
    return out


def find_pretrained(cfg: GraphInventConfig) -> Tuple[str, int]:
    """(path, epoch) of the pre-trained model: the newest
    ``model_restart_<n>.pth`` or ``.ckpt`` in ``pretrained_model_dir`` (at
    equal epoch the ``.pth``), else ``dataset_dir/pretrained_model.pth`` or
    ``.ckpt`` (epoch 0)."""
    found = latest_checkpoint(cfg.pretrained_model_dir)
    if found is not None:
        return found
    base = os.path.join(cfg.dataset_dir, "pretrained_model")
    for ext in (".pth", ".ckpt"):
        if os.path.exists(base + ext):
            return base + ext, 0
    raise FileNotFoundError(f"no pre-trained checkpoint in "
                            f"{cfg.pretrained_model_dir} or {cfg.dataset_dir}")


class StepClock:
    """The ends of a step's pieces: a CUDA event recorded on the device's
    stream at each mark (the host enqueues on without waiting), or the host
    clock on the CPU.  ``seconds`` reads them all once, after the step."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks: List[Tuple[str, object]] = []
        self.mark("")

    def mark(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            self.marks.append((name, event))
        else:
            self.marks.append((name, time.perf_counter()))

    def seconds(self) -> Dict[str, float]:
        """Seconds of each named piece, summed where a name repeats."""
        if self.cuda:
            self.marks[-1][1].synchronize()
        out: Dict[str, float] = {}
        for (_, start), (name, end) in zip(self.marks, self.marks[1:]):
            s = (start.elapsed_time(end) / 1e3 if self.cuda
                 else end - start)
            out[name] = out.get(name, 0.0) + s
        return out


class FineTuner:
    """The state of a fine-tune job: the agent and its Adam + OneCycle, the
    frozen prior, the frozen BASF and the best evaluation score so far."""

    def __init__(self, workflow, agent: nn.Module, start_step: int, *,
                 _eager: bool = False) -> None:
        cfg: GraphInventConfig = workflow.cfg
        self.cfg = cfg
        self.workflow = workflow
        self.device = workflow.device
        self.logger = workflow.logger
        # one process's mesh: every rank runs the step (module docstring)
        self.mesh = workflow.mesh if workflow.on_mesh else None
        self.primary = workflow.primary
        if self.mesh is not None and cfg.batch_size % self.mesh.data:
            raise ValueError(
                f"batch_size={cfg.batch_size} must divide by the data axis "
                f"({self.mesh.data}) for sharded fine-tuning")
        self.analyzer = (Analyzer(cfg, self.logger,
                                  workflow._load_ts_properties(),
                                  workflow.start_time)
                         if self.primary else None)
        self.scoring = ScoringFunction(cfg)
        self.sampler = workflow._get_sampler(cfg.batch_size, on_mesh=True)
        self.agent = agent
        self.prior = frozen_copy(agent)
        self.basf = frozen_copy(agent)      # "best agent so far"
        self.adam = Adam(agent)
        self.schedule = onecycle_for_config(cfg, 1)
        # on the card, one process, no mesh: the replays and Adam are
        # captured graphs (rl/step_graphs.py); ``_eager`` keeps the eager
        # step there, for the checks that hold the two against each other
        self.graphs = (FineTuneGraphs(cfg, agent, self.adam, self.device,
                                      rl_loss)
                       if not _eager and self.mesh is None
                       and replays_steps(self.device) else None)
        self.best_avg_score = 0.0
        self.start_step = start_step
        # per step: seconds of each piece, the host seconds spent waiting
        # for the scoring worker, the BASF rows past the gate; forward
        # steps of each forward-only replay
        self.step_timings: List[Dict[str, float]] = []
        self.scoring_waits: List[float] = []
        self.basf_gated: List[int] = []
        self.replay_steps: List[int] = []

    # ------------------------------------------------------------------
    def rollout(self, model: nn.Module, step: int, role: int
                ) -> SampleResult:
        res = self.sampler.sample(model, rl_generator(
            self.cfg.seed, step, role, self.device), quiet=True)
        self.workflow.batch_stats.append((res.n_rounds, res.elapsed_s))
        return res

    def replay(self, model: nn.Module, res: SampleResult) -> np.ndarray:
        # the forward steps this process runs: on a mesh, its rows'
        t_counts = (res.t_counts if self.mesh is None else
                    res.t_counts[data_rows(len(res.t_counts), self.mesh)])
        steps = int(min(t_counts.max(), res.actions.shape[1]))
        self.replay_steps.append(steps)
        if self.graphs is not None and not keeps_eager_step(model):
            return self.graphs.loglik.loglik(self.cfg, model, res.actions,
                                             res.t_counts, steps, self.device)
        return replay_loglik(self.cfg, model, res.actions, res.t_counts,
                             self.device, self.mesh)

    def score(self, res: SampleResult, step: int, label: str, write: bool
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, uniqueness) of a rollout: rank 0 scores, every rank of
        a mesh gets them."""
        return self._share(self._score_here(res, step, label, write))

    def _score_here(self, res: SampleResult, step: int, label: str,
                    write: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Rank 0's (scores, uniqueness) of a rollout; None elsewhere.  Host
        work and no collective, so it may run on the worker thread; its
        torch calls (the QSAR scorer's) build no autograd graph."""
        if not self.primary:
            return None
        with torch.inference_mode():
            validity, uniqueness, _ = \
                self.analyzer.evaluate_generated_graphs(
                    res.graphs, res.properly_terminated,
                    res.final_loglikelihoods,
                    epoch_key=f"Step {step} {label}", write=write,
                    label=label, plot=False)
            scores = self.scoring.compute_score(
                res.graphs, res.properly_terminated, validity, uniqueness)
        return scores, uniqueness

    def _share(self, out: Optional[Tuple[np.ndarray, np.ndarray]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Rank 0's scores on every rank of a mesh (the calling thread)."""
        if self.mesh is not None:
            out = multihost.broadcast_object(out)
        return out

    def _batch(self, res: SampleResult, target: np.ndarray,
               mask: np.ndarray) -> Batch:
        dev = self.device
        return (torch.from_numpy(res.actions).to(dev),
                torch.from_numpy(res.t_counts).to(dev),
                torch.from_numpy(target.astype(np.float32)).to(dev),
                torch.from_numpy(mask.astype(np.float32)).to(dev))

    # ------------------------------------------------------------------
    def pre_evaluation(self) -> float:
        """Scores one agent rollout before any update
        (Workflow.py:536-542); starts fine-tuning.log."""
        step = self.start_step - 1
        res = self.rollout(self.agent, step, ROLE_PRE_FINE_TUNING)
        scores, _ = self.score(res, step, "pre-fine-tuning", True)
        if self.primary:
            self.logger.save_rl_metrics(step, float(np.mean(scores)),
                                        append=False)
        return float(np.mean(scores))

    def step(self, step: int) -> float:
        """One learning step, the host's scoring beside the device's work
        (module docstring); -> the loss."""
        clock = StepClock(self.device)
        waited = 0.0

        def join(pending: Optional[Future]) -> Tuple[np.ndarray, np.ndarray]:
            nonlocal waited
            t0 = time.perf_counter()
            out = pending.result() if pending is not None else None
            waited += time.perf_counter() - t0
            return self._share(out)

        with ThreadPoolExecutor(max_workers=1) as pool:
            def submit(res, label, write) -> Optional[Future]:
                return (pool.submit(self._score_here, res, step, label, write)
                        if self.primary else None)

            res_a = self.rollout(self.agent, step, ROLE_AGENT)
            clock.mark("agent_rollout")
            pending = submit(res_a, "agent", True)
            prior_ll = self.replay(self.prior, res_a)
            clock.mark("prior_replay")
            res_b = self.rollout(self.basf, step, ROLE_BASF)
            scored_a = join(pending)
            pending = submit(res_b, "BASF", False)
            basf_ll = self.replay(self.basf, res_b)
            clock.mark("basf_rollout_and_replay")
            scored_b = join(pending)
        loss = self.learn(step, res_a, prior_ll, res_b, basf_ll, clock,
                          scored=(scored_a, scored_b))
        self.scoring_waits.append(waited)
        return loss

    def learn(self, step: int, res_a: SampleResult, prior_ll: np.ndarray,
              res_b: SampleResult, basf_ll: np.ndarray,
              clock: Optional[StepClock] = None,
              scored: Optional[Tuple[Tuple, Tuple]] = None) -> float:
        """Takes the gradient replay and one Adam step at
        ``schedule(adam.step)``; -> the loss.  ``scored``: both rollouts'
        (scores, uniqueness) where the caller has them (``step``), else
        they are scored here, one after the other.  Appends the step's
        timings to ``step_timings``."""
        cfg, logger = self.cfg, self.logger
        clock = StepClock(self.device) if clock is None else clock
        sigma, alpha = cfg.sigma, cfg.alpha
        if scored is None:
            scored = (self.score(res_a, step, "agent", True),
                      self.score(res_b, step, "BASF", False))
        (scores_a, unique_a), (scores_b, unique_b) = scored
        target_a = prior_ll + sigma * scores_a
        mask_a = unique_a != 0
        if self.primary:
            _warn_on_collapse(logger, step, unique_a)
            # per-step likelihood traces (reference: Workflow.py:738-743 +
            # util.tbwrite_loglikelihoods writes the negated
            # loglikelihoods)
            logger.tb_scalar("Fine-tuning/agent_nll",
                             float(-np.mean(res_a.final_loglikelihoods)),
                             step)
            logger.tb_scalar("Fine-tuning/prior_nll",
                             float(-np.mean(prior_ll)), step)
        # loss_b = (basf_ll - (agent_ll + sigma*score))^2, the mask with
        # the score > best_avg_score gate
        target_b = basf_ll - sigma * scores_b
        mask_b = np.where(scores_b > self.best_avg_score, unique_b, 0) != 0
        self.basf_gated.append(int(mask_b.sum()))
        clock.mark("scoring")

        self.adam.zero_grad()
        lr, beta1 = self.schedule(self.adam.step)
        if self.graphs is not None and not keeps_eager_step(self.agent):
            loss = self.graphs.grad.learn(
                (res_a.actions, res_a.t_counts, target_a, mask_a),
                (res_b.actions, res_b.t_counts, target_b, mask_b),
                lr, beta1, clock)
        else:
            batch_a = self._batch(res_a, target_a, mask_a)
            batch_b = self._batch(res_b, target_b, mask_b)
            if self.mesh is None:
                loss = rl_loss(cfg, self.agent, batch_a, batch_b, alpha)
                clock.mark("grad_forward")
                loss.backward()
                clock.mark("grad_backward")
            else:
                loss = sharded_rl_backward(cfg, self.agent, self.adam,
                                           batch_a, batch_b, alpha,
                                           self.mesh, clock)
            self.adam.update(lr, beta1)
        clock.mark("adam")

        loss_value = loss.item()
        times = clock.seconds()
        self.step_timings.append(times)
        avg_score = float(np.mean(scores_a))
        print(f"Step {step}: loss {loss_value:.4f} avg_score "
              f"{avg_score:.4f} ({sum(times.values()):.1f}s)", flush=True)
        if self.primary:
            logger.write_training_status(step, float(lr), loss_value, 0.0,
                                         score=avg_score)
        return loss_value

    def evaluate(self, step: int) -> float:
        """Scores an agent rollout, saves the agent and Adam's state, and
        makes a new BASF where the score beats the best."""
        res = self.rollout(self.agent, step, ROLE_EVALUATE)
        scores, _ = self.score(res, step, "eval", True)
        eval_score = float(np.mean(scores))
        if self.primary:
            self.logger.save_rl_metrics(step, eval_score)
            save_checkpoint(self.agent, self.cfg.job_dir, step,
                            self.adam.state_dict())
        if eval_score > self.best_avg_score:
            self.best_avg_score = eval_score
            self.basf = frozen_copy(self.agent)
            print("-- Updated best model.", flush=True)
        return eval_score


def learning_phase(workflow) -> Optional[FineTuner]:
    """Fine-tunes a pre-trained model by policy-gradient RL; -> the
    fine-tuner after the last step.  Under several processes rank 0 runs
    the job and the others return None at once: one writer, as in the JAX
    package (its fine-tune job shards over a mesh of one process only);
    on one process's mesh every rank runs it."""
    if not workflow.primary and not workflow.on_mesh:
        return None
    cfg: GraphInventConfig = workflow.cfg
    path, restart_epoch = find_pretrained(cfg)
    print(f"-- Loading pre-trained model from {path}", flush=True)
    agent = load_checkpoint(cfg, path).to(workflow.device)
    start_step = restart_epoch + 1
    tuner = FineTuner(workflow, agent, start_step)
    tuner.pre_evaluation()
    print("* Begin learning.", flush=True)
    for step in range(start_step, start_step + cfg.epochs):
        tuner.step(step)
        if step % cfg.sample_every == 0:
            tuner.evaluate(step)
    return tuner
