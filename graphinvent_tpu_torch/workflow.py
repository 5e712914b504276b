"""Job orchestration for the PyTorch port.

Counterpart of ``graphinvent_tpu/workflow.py`` (reference Workflow.py).
The port runs all five job types, ``preprocess``, ``train``, ``generate``,
``test`` and ``fine-tune`` (``rl/workflow_rl.py``), for all six models,
in one process or in several (``parallel/``: one rank a card, launched
through ``main``), as the JAX package's multi-process jobs do:

* preprocess: one shard of each split a process, rank 0 combines;
* train: each rank streams its own round-robin share of the blocks, a
  global batch of ``batch_size`` rows is the ranks' local batches of
  ``batch_size / num_processes`` rows in rank order, and the gradients are
  summed over the ranks before every rank takes the same Adam step;
  validation runs on each rank's own share, evaluation on rank 0;
* generate: rank p samples global batch ``r * P + p`` with that batch's own
  generator, and rank 0 gathers the packed batches, decodes and writes;
* test and fine-tune: rank 0 runs the single-process job, the others
  return at once.

One process's mesh (``dp_devices``, ``mp_devices`` or ``graph_devices``
above 1 in one process: ``main`` starts a rank a member, and
``multihost.jax_process_count`` is 1) runs the JAX package's
single-process mesh jobs: train steps and validation over the mesh (rows
over ``data``, nodes over ``graph``, the APD head split over ``model``
where it divides), the sampler's rows over ``data`` in the generate, test
and fine-tune jobs, the test job's NLLs and the fine-tune job's replays
over the mesh.  A multi-process job's train step runs over its mesh too;
its other jobs keep the per-process rules above.

Rank 0 alone writes into the job directory; a checkpoint holds the whole
model, laid out as a one-device job's.

Training state is explicit: the model (float32 master weights on the
device) and a ``train.optim.Adam`` (step count and both moments), both
checkpointed.  Training takes the unfused ``models/core`` path under
autograd; every grad-free forward (validation loss, dataset NLLs, sampling)
goes through the fused kernel on a CUDA device.
"""

from __future__ import annotations

import copy
import itertools
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphinvent_tpu_torch.config import GraphInventConfig
from graphinvent_tpu_torch.data import store
from graphinvent_tpu_torch.data.loader import BlockLoader, HDFDataset
from graphinvent_tpu_torch.data.preprocess import preprocess_dataset
from graphinvent_tpu_torch.eval.analyzer import Analyzer
from graphinvent_tpu_torch.eval.properties import load_ts_properties_csv
from graphinvent_tpu_torch.models import build_model
from graphinvent_tpu_torch.parallel import multihost
from graphinvent_tpu_torch.parallel.mesh import (
    Mesh, data_rows, make_mesh, make_sharded_eval_step, make_sharded_nll_step,
    make_sharded_train_step, place_training_state, whole_adam_state,
    whole_model,
)
from graphinvent_tpu_torch.sampling import GraphSampler, SampleResult
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_DROPOUT, STREAM_EVALUATE, STREAM_TEST, _packed_rounds,
    batch_generator, seeded_generator,
)
from graphinvent_tpu_torch.sampling.two_phase import (
    TwoPhaseSampler, window_generator,
)
from graphinvent_tpu_torch.train.device_data import (
    DeviceDataset, epoch_permutation, make_epoch_eval_fn, make_epoch_nll_fn,
    make_epoch_train_fn, nll_row_batches,
)
from graphinvent_tpu_torch.train.optim import Adam, onecycle_for_config
from graphinvent_tpu_torch.train.step import (
    BatchUploader, make_eval_step, make_likelihood_step, make_train_step,
)
from graphinvent_tpu_torch.utils.device import resolve_device
from graphinvent_tpu_torch.utils.logging import JobLogger
from graphinvent_tpu_torch.utils.weights import (
    checkpoint_path, latest_checkpoint, load_checkpoint, restore_checkpoint,
    save_checkpoint,
)

# (which dataset, rows, the whole model) -> NLLs, on the primary rank
NllFn = Callable[[str, int, nn.Module], np.ndarray]


def streamed_random_nlls(ds: HDFDataset,
                         run_nll: Callable[[Dict[str, np.ndarray]],
                                           np.ndarray],
                         max_rows: int, batch_size: int, block_size: int,
                         rng: np.random.Generator) -> np.ndarray:
    """NLLs of a uniform random row sample (without replacement) from a
    streamed dataset: the streamed counterpart of
    ``train/device_data.nll_row_batches``.  Rows are drawn uniformly over
    the whole dataset, then read block by block (sorted indices: no random
    row reads) and batched with zero-padding + ``valid`` masks, in bounded
    memory.

    ``run_nll``: dict of (batch_size, ...) float32 arrays (keys nodes/
    edges/apds/valid) -> per-row NLL np.ndarray."""
    n = len(ds)
    take = min(max_rows, n)
    if take <= 0:
        return np.zeros(0)
    idx = np.sort(rng.choice(n, size=take, replace=False))
    out: List[np.ndarray] = []
    pending: List[Dict[str, np.ndarray]] = []
    pending_rows = 0

    def run(rows: Dict[str, np.ndarray]) -> None:
        m = rows["nodes"].shape[0]
        batch = {k: np.zeros((batch_size,) + v.shape[1:], np.float32)
                 for k, v in rows.items()}
        for k, v in rows.items():
            batch[k][:m] = v
        valid = np.zeros(batch_size, np.float32)
        valid[:m] = 1.0
        batch["valid"] = valid
        out.append(np.asarray(run_nll(batch))[:m])

    def drain(final: bool) -> None:
        nonlocal pending, pending_rows
        while pending_rows >= batch_size or (final and pending_rows > 0):
            rows = {k: np.concatenate([p[k] for p in pending])
                    for k in pending[0]}
            cut = min(batch_size, rows["nodes"].shape[0])
            run({k: v[:cut] for k, v in rows.items()})
            rest = {k: v[cut:] for k, v in rows.items()}
            pending_rows = rest["nodes"].shape[0]
            pending = [rest] if pending_rows else []

    pos = 0
    for bstart in range(0, n, block_size):
        bend = min(bstart + block_size, n)
        hi = pos
        while hi < take and idx[hi] < bend:
            hi += 1
        if hi == pos:
            continue
        block = ds.read_block(bstart, bend)
        local = idx[pos:hi] - bstart
        pending.append({k: v[local] for k, v in block.items()})
        pending_rows += hi - pos
        pos = hi
        drain(final=False)
    drain(final=True)
    return np.concatenate(out) if out else np.zeros(0)


def eval_sample_generator(seed: int, epoch: int, batch_idx: int,
                          device: torch.device) -> torch.Generator:
    """The generator of evaluation sampling batch ``batch_idx`` of epoch
    ``epoch``: no (epoch, batch_idx) pair shares its stream with another
    (a flat ``epoch + batch_idx`` would make (5, 1) and (6, 0) sample the
    same molecules), nor with a batch of the generate job."""
    return seeded_generator([seed, epoch, batch_idx], device,
                            STREAM_EVALUATE)


def upload_ahead(batches: Iterator[Dict[str, np.ndarray]],
                 place: Callable[[Dict[str, np.ndarray]],
                                 Dict[str, torch.Tensor]]
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields ``place(batch)`` for each batch, with the read, the packing
    and the upload of batch k+1 running on a worker thread while the caller
    works on batch k.  An exception on the worker would otherwise end the
    epoch early and quietly: it is kept and raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = object()
    failure: List[BaseException] = []
    abandoned = threading.Event()

    def worker() -> None:
        try:
            for batch in batches:
                if abandoned.is_set():
                    break
                q.put(place(batch))
        except BaseException as exc:   # noqa: BLE001 -- re-raised below
            failure.append(exc)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
    finally:
        # a consumer that stops early must not leave the worker blocked
        abandoned.set()
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
        t.join()
    if failure:
        raise failure[0]


class Workflow:
    def __init__(self, cfg: GraphInventConfig) -> None:
        cfg.validate()
        multihost.check_process_group(cfg)
        # ranks, and the JAX processes they stand for (1 on one process's
        # mesh): the JAX package's branches read the second
        self.n_ranks = multihost.process_count()
        self.n_proc = multihost.jax_process_count()
        self.rank = multihost.process_index()
        # preprocessing is host work on no mesh (as in the JAX package)
        self.mesh = (Mesh(self.n_ranks, self.rank)
                     if cfg.job_type == "preprocess"
                     else make_mesh(cfg, self.n_ranks))
        # one process's mesh: every job below runs over it
        self.on_mesh = self.mesh.size > 1 and self.n_proc == 1
        if cfg.job_type != "preprocess":
            cfg.check_preprocessing_params()
        self.primary = self.rank == 0
        self.cfg = cfg
        # preprocessing is host work and needs no card
        self.device = (torch.device("cpu") if cfg.job_type == "preprocess"
                       else resolve_device(cfg.device))
        self.start_time = time.time()
        # one writer: the other ranks write nothing into the job directory
        self.logger = (JobLogger(cfg.job_dir, cfg.tensorboard_dir)
                       if self.primary else None)
        if self.primary:
            # snapshot of the fully-resolved config this job runs with
            # (reference: util.write_job_parameters, util.py:478-498)
            cfg.write_csv(os.path.join(cfg.job_dir, "params.csv"))
        # (rounds, seconds) of each batch this process sampled, for callers
        # that report throughput
        self.batch_stats: List[Tuple[int, float]] = []
        self.two_phase_stats: List[Dict[str, float]] = []
        self._samplers: Dict[int, GraphSampler] = {}

    def _get_sampler(self, batch_size: int, on_mesh: bool = False
                     ) -> GraphSampler:
        """One GraphSampler per batch size for the whole job; ``on_mesh``:
        the sampler of one process's mesh, rows over ``data`` (every rank
        samples every batch)."""
        on_mesh = on_mesh and self.on_mesh
        if on_mesh and batch_size % self.mesh.data:
            raise ValueError(
                f"a batch of {batch_size} rows must divide by the data axis "
                f"({self.mesh.data}) on a mesh")
        if (batch_size, on_mesh) not in self._samplers:
            self._samplers[(batch_size, on_mesh)] = GraphSampler(
                self.cfg, batch_size, device=self.device,
                mesh=self.mesh if on_mesh else None)
        return self._samplers[(batch_size, on_mesh)]

    def _open_dataset(self, name: str) -> HDFDataset:
        ds = HDFDataset(store.find_dataset(
            os.path.join(self.cfg.dataset_dir, name)))
        print(f"-- Opened {ds.path} ({ds.backend}, {len(ds)} rows)",
              flush=True)
        return ds

    # ------------------------------------------------------------------
    def run(self) -> None:
        job = self.cfg.job_type
        if job == "preprocess":
            self.preprocess_phase()
        elif job == "train":
            self.training_phase()
        elif job == "generate":
            self.generation_phase()
        elif job == "test":
            self.testing_phase()
        elif job == "fine-tune":
            from graphinvent_tpu_torch.rl.workflow_rl import learning_phase
            self.fine_tuner = learning_phase(self)
        else:
            raise ValueError(f"invalid job_type {job!r}")
        elapsed = time.time() - self.start_time
        print(f"-- time elapsed: {elapsed:.5f} s", flush=True)

    # ------------------------------------------------------------------
    def preprocess_phase(self) -> None:
        preprocess_dataset(self.cfg, restart=self.cfg.restart)

    # ------------------------------------------------------------------
    def _load_ts_properties(self) -> Dict:
        csv_path = os.path.join(self.cfg.dataset_dir, "train.csv")
        if os.path.exists(csv_path):
            return load_ts_properties_csv(csv_path)
        return {}

    def _init_or_restore(self) -> Tuple[nn.Module, Adam, int]:
        """-> (model on the device, optimizer, start_epoch).  A restart
        takes the newest checkpoint.  Adam's moments and step come back
        with it from a JAX ``.ckpt`` that holds them, or from a ``.pth``'s
        sidecar; else Adam starts fresh (a reference checkpoint holds
        weights only).  Under several processes rank 0 alone reads the job
        directory, and every rank takes its weights, Adam state and epoch."""
        cfg = self.cfg
        found = (latest_checkpoint(cfg.job_dir)
                 if cfg.restart and self.primary else None)
        start_epoch = 1
        if found:
            path, epoch = found
            print(f"-- Restoring checkpoint {path}", flush=True)
            model, state = restore_checkpoint(cfg, path, epoch)
            model = model.to(self.device)
            adam = Adam(model)
            if state is not None:
                adam.load_state_dict(state)
                print(f"-- Restored Adam's moments at step {adam.step}",
                      flush=True)
            start_epoch = epoch + 1
        else:
            model = build_model(
                cfg, torch.Generator().manual_seed(cfg.seed)).to(self.device)
            adam = Adam(model)
        if self.n_ranks > 1:
            adam.step, start_epoch = multihost.broadcast_object(
                (adam.step, start_epoch))
            multihost.broadcast_tensors_(adam.params + adam.mu + adam.nu)
            print(f"-- Rank {self.rank}: rank 0's weights and Adam state "
                  f"(step {adam.step}), from epoch {start_epoch}", flush=True)
        return model, adam, start_epoch

    # ------------------------------------------------------------------
    def training_phase(self) -> None:
        cfg = self.cfg
        print("* Setting up training job.", flush=True)
        train_ds = self._open_dataset("train")
        valid_ds = self._open_dataset("valid")
        analyzer = None
        if self.primary:
            ts_props = self._load_ts_properties()
            analyzer = Analyzer(cfg, self.logger, ts_props, self.start_time)
            if not cfg.restart:
                self.logger.init_convergence()
                if ts_props:
                    self.logger.properties_to_csv(ts_props, "Training set",
                                                  append=False)

        n_proc = self.n_proc
        if cfg.batch_size % n_proc:
            raise ValueError(f"batch_size={cfg.batch_size} must divide by "
                             f"num_processes={n_proc} (global batch, each "
                             f"rank's share batch_size/num_processes rows)")
        if cfg.batch_size % self.mesh.data:
            raise ValueError(f"batch_size={cfg.batch_size} must divide by "
                             f"the data axis ({self.mesh.data})")
        if n_proc > 1:
            # every rank must take the same number of steps: the fewest
            # any rank's share of the blocks gives
            n_batches = multihost.global_steps_per_epoch(
                len(train_ds), cfg.batch_size // n_proc, cfg.block_size,
                n_proc)
        else:
            n_batches = (len(train_ds) + cfg.batch_size - 1) // cfg.batch_size
        schedule = onecycle_for_config(cfg, n_batches)
        model, adam, start_epoch = self._init_or_restore()
        if self.mesh.size > 1:
            # the head splits over ``model`` where it divides (one
            # process's mesh only); Adam then holds this rank's rows
            model, adam = place_training_state(self.mesh, model, adam)
            print(f"-- Mesh (data, model, graph) = ({self.mesh.data}, "
                  f"{self.mesh.model}, {self.mesh.graph}), rank {self.rank}"
                  f" at ({self.mesh.index}, {self.mesh.model_index}, "
                  f"{self.mesh.graph_index}); APD head "
                  f"{'split' if model.APDReadout.split else 'whole'}",
                  flush=True)
        self.model, self.adam = model, adam

        # the budget bounds the SUM of resident datasets: train and valid
        # sit in device memory together.  Several processes stream their
        # own shares of the blocks instead.
        budget = int(cfg.device_data_gb * (1 << 30))
        use_device = (n_proc == 1
                      and DeviceDataset.nbytes_of(train_ds)
                      + DeviceDataset.nbytes_of(valid_ds) <= budget)
        # which epoch path this job took, for callers that check it
        self.data_path = "resident" if use_device else "streamed"
        if use_device:
            print("-- Dataset fits in device memory: device-resident epoch "
                  "path.", flush=True)
            run_train_epoch, run_valid_epoch, dataset_nlls = \
                self._resident_epochs(train_ds, valid_ds, schedule)
        else:
            why = ("Dataset exceeds device_data_gb" if n_proc == 1 else
                   f"{n_proc} processes, each with its share of the blocks")
            print(f"-- {why}: streamed epoch path "
                  f"(packed={bool(cfg.stream_packed)}, "
                  f"apd_nnz={self._apd_nnz()}, "
                  f"upload_ahead={bool(cfg.stream_upload_ahead)}).",
                  flush=True)
            run_train_epoch, run_valid_epoch, dataset_nlls = \
                self._streamed_epochs(train_ds, valid_ds, schedule, n_batches)

        print("* Beginning training.", flush=True)
        end_epoch = start_epoch + cfg.epochs
        for epoch in range(start_epoch, end_epoch):
            t0 = time.time()
            train_loss = run_train_epoch(epoch)
            valid_loss = run_valid_epoch()
            lr, _ = schedule(adam.step - 1)
            print(f"Epoch {epoch}: train {train_loss:.5f} valid "
                  f"{valid_loss:.5f} ({time.time()-t0:.1f}s)", flush=True)
            evaluate = epoch % cfg.sample_every == 0
            if evaluate:
                # every rank of a split head takes part in the gather
                whole, opt = self._whole_state(model, adam)
            if not self.primary:
                # the other ranks evaluate nothing and write nothing
                continue
            self.logger.write_training_status(epoch, float(lr), train_loss,
                                              valid_loss)
            if evaluate:
                self.evaluate_model(whole, epoch, analyzer, dataset_nlls)
                save_checkpoint(whole, cfg.job_dir, epoch, opt)
        whole, opt = self._whole_state(model, adam)
        if self.primary:
            save_checkpoint(whole, cfg.job_dir, end_epoch - 1, opt)

    def _whole_state(self, model: nn.Module, adam: Adam
                     ) -> Tuple[nn.Module, Dict]:
        """The model and Adam's state with a split head gathered whole
        (the one-device layout), for evaluation and checkpoints."""
        if self.mesh.size == 1:
            return model, adam.state_dict()
        return (whole_model(model, self.mesh),
                whole_adam_state(adam, model, self.mesh))

    def _apd_nnz(self) -> int:
        """The sparse APD wire's slots, or 0 for the dense wire."""
        cfg = self.cfg
        return cfg.stream_apd_nnz if cfg.stream_packed else 0

    def _mesh_rows(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """This rank's rows of a global wire batch on the data axis.  On
        one process's mesh every rank reads the global batch.  Several
        processes each read their share of it: where the data axis is the
        group, that share is the rank's rows; else the shares are gathered
        in rank order (the JAX package's global batch) first."""
        mesh = self.mesh
        if mesh.size == 1 or (self.n_proc > 1 and mesh.data == self.n_ranks):
            return batch
        if self.n_proc > 1:
            batch = {k: multihost.all_gather_bytes(v).reshape(
                (-1,) + v.shape[1:]) for k, v in batch.items()}
        rows = data_rows(len(next(iter(batch.values()))), mesh)
        return {k: v[rows] for k, v in batch.items()}

    def _dropout_generator(self, epoch: int) -> torch.Generator:
        """Dropout masks of ``epoch``'s train steps, drawn in step order."""
        return seeded_generator([self.cfg.seed, epoch], self.device,
                                STREAM_DROPOUT)

    def _resident_epochs(self, train_ds: HDFDataset, valid_ds: HDFDataset,
                         schedule) -> Tuple[Callable, Callable, NllFn]:
        cfg, model, adam = self.cfg, self.model, self.adam
        dtrain = DeviceDataset(train_ds, self.device)
        dvalid = DeviceDataset(valid_ds, self.device)
        mesh = self.mesh if self.on_mesh else None
        train_epoch_fn = make_epoch_train_fn(cfg, schedule, dtrain, model,
                                             adam, mesh)
        valid_epoch_fn = make_epoch_eval_fn(cfg, dvalid, model, mesh)
        datasets = {"valid": dvalid, "train": dtrain}
        sizes = {"valid": len(valid_ds), "train": len(train_ds)}
        rng_np = np.random.default_rng(cfg.seed)
        nll_rng = np.random.default_rng(cfg.seed + 1)

        def run_train_epoch(epoch: int) -> float:
            perm = epoch_permutation(len(train_ds), cfg.batch_size, rng_np)
            return train_epoch_fn(perm, self._dropout_generator(epoch))

        def run_valid_epoch() -> float:
            return valid_epoch_fn(epoch_permutation(
                len(valid_ds), cfg.batch_size, np.random.default_rng(0)))

        def dataset_nlls(which: str, max_rows: int,
                         whole: nn.Module) -> np.ndarray:
            nll_fn = make_epoch_nll_fn(cfg, datasets[which], whole)
            nlls, valid = nll_fn(nll_row_batches(
                sizes[which], max_rows, cfg.batch_size, nll_rng))
            return nlls[valid > 0]

        return run_train_epoch, run_valid_epoch, dataset_nlls

    def _streamed_epochs(self, train_ds: HDFDataset, valid_ds: HDFDataset,
                         schedule, n_batches: int
                         ) -> Tuple[Callable, Callable, NllFn]:
        cfg, model, adam = self.cfg, self.model, self.adam
        # bit-packed wire: 8x smaller uploads than float32; the steps
        # unpack on the device (train/step.batch_arrays)
        packed = bool(cfg.stream_packed)
        # the APD wire (sparse where every row of a dataset fits apd_nnz
        # slots, else dense) is chosen once a dataset from all its rows,
        # so every batch and every rank has one layout
        apd_nnz = self._apd_nnz()
        # each rank reads its own round-robin share of the blocks, in
        # batches of its share of the global batch
        local_bs = cfg.batch_size // self.n_proc
        shard = dict(shard_index=self.rank if self.n_proc > 1 else 0,
                     num_shards=self.n_proc)
        train_loader = BlockLoader(train_ds, local_bs, cfg.block_size,
                                   seed=cfg.seed, packed=packed,
                                   apd_nnz=apd_nnz, **shard)
        valid_loader = BlockLoader(valid_ds, local_bs, cfg.block_size,
                                   shuffle=False, seed=cfg.seed,
                                   packed=packed, apd_nnz=apd_nnz, **shard)
        # which APD wire each dataset took, for callers that check it
        self.apd_wire = {"train": train_loader.apd_wire,
                         "valid": valid_loader.apd_wire}
        if packed:
            print(f"-- APD wire: train {train_loader.apd_wire}, valid "
                  f"{valid_loader.apd_wire} (largest rows "
                  f"{train_ds.max_apd_nnz()} / {valid_ds.max_apd_nnz()} "
                  f"nonzeros, {apd_nnz} sparse slots).", flush=True)
        train_step = (make_train_step(cfg, schedule, model, adam)
                      if self.mesh.size == 1 else
                      make_sharded_train_step(cfg, schedule, model, adam,
                                              self.mesh))
        eval_step = (make_sharded_eval_step(cfg, model, self.mesh)
                     if self.on_mesh else make_eval_step(cfg, model))
        # one uploader serves the worker thread during a train epoch and
        # this thread between epochs; the two never upload at once
        place = BatchUploader(self.device)
        nll_datasets = {"valid": valid_ds, "train": train_ds}
        stream_nll_rng = np.random.default_rng(cfg.seed + 1)

        def placed_batches(epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
            train_loader.set_epoch(epoch)
            # the schedule was planned for n_batches steps an epoch; blocks
            # with remainder batches can yield more
            batches = (self._mesh_rows(b) for b in
                       itertools.islice(train_loader, n_batches))
            if not cfg.stream_upload_ahead:
                return (place(b) for b in batches)
            return upload_ahead(batches, place)

        def run_train_epoch(epoch: int) -> float:
            generator = self._dropout_generator(epoch)
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            steps = 0
            for b in placed_batches(epoch):
                total += train_step(b, generator)
                steps += 1
            return total.item() / max(steps, 1)

        def run_valid_epoch() -> float:
            # each process's own share, as each JAX host's is; on one
            # process's mesh, each rank's rows of every batch
            rows = self._mesh_rows if self.on_mesh else (lambda b: b)
            vlosses = [eval_step(place(rows(b))) for b in valid_loader]
            return torch.stack(vlosses).mean().item()

        def dataset_nlls(which: str, max_rows: int,
                         whole: nn.Module) -> np.ndarray:
            # uniform random rows, like the device-resident path's
            # nll_row_batches
            nll_step = make_likelihood_step(cfg, whole)
            return streamed_random_nlls(
                nll_datasets[which],
                lambda b: nll_step(place(b)).cpu().numpy(),
                max_rows, cfg.batch_size, cfg.block_size, stream_nll_rng)

        return run_train_epoch, run_valid_epoch, dataset_nlls

    # ------------------------------------------------------------------
    def evaluate_model(self, model: nn.Module, epoch: int,
                       analyzer: Analyzer, dataset_nlls: NllFn) -> None:
        """Sample + UC-JSD evaluation (reference: Workflow.py:441-513 +
        Analyzer.evaluate_model).  The analyzer's chemistry runs on this
        thread between the sampled batches."""
        cfg = self.cfg
        n_samples = cfg.n_samples
        sampler = self._get_sampler(min(cfg.batch_size, n_samples))
        all_nlls: List[np.ndarray] = []
        n_done = 0
        batch_idx = 0
        while n_done < n_samples:
            res = sampler.sample(model, eval_sample_generator(
                cfg.seed, epoch, batch_idx, self.device))
            self.batch_stats.append((res.n_rounds, res.elapsed_s))
            analyzer.evaluate_generated_graphs(
                res.graphs, res.properly_terminated,
                res.final_loglikelihoods, epoch_key=f"Epoch {epoch}",
                write=(batch_idx == 0), plot=(batch_idx == 0))
            all_nlls.append(res.action_nlls)
            n_done += len(res.graphs)
            batch_idx += 1
        gen_nlls = np.concatenate(all_nlls)

        max_rows = min(100000, n_samples)
        nll_valid = dataset_nlls("valid", max_rows, model)
        nll_train = dataset_nlls("train", max_rows, model)
        scores = analyzer.model_scores(nll_valid, nll_train, gen_nlls,
                                       n_samples)
        self.logger.write_validation_scores(f"Epoch {epoch}", scores)
        self.logger.append_score(scores["UC-JSD"])
        self.logger.tb_scalar("Evaluation/uc_jsd", scores["UC-JSD"], epoch)

    # ------------------------------------------------------------------
    def _load_model_for_inference(self, epoch: Optional[int] = None
                                  ) -> Tuple[nn.Module, int]:
        """The checkpoint of ``epoch``, or the newest one in the job dir."""
        cfg = self.cfg
        if epoch is not None:
            path = checkpoint_path(cfg.job_dir, epoch)
            if not os.path.exists(path):
                path = path[:-len(".pth")] + ".ckpt"
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no model_restart_{epoch}.pth or .ckpt in {cfg.job_dir}")
        else:
            found = latest_checkpoint(cfg.job_dir)
            if not found:
                raise FileNotFoundError(
                    f"no model_restart_<epoch>.pth or .ckpt in {cfg.job_dir}")
            path, epoch = found
        print(f"* Loading model from {path} (epoch {epoch}).", flush=True)
        model = load_checkpoint(cfg, path).to(self.device).eval()
        return model, epoch

    # ------------------------------------------------------------------
    def generation_phase(self) -> None:
        """Generate cfg.n_samples molecules (reference: Workflow.py:389-439).

        Host chemistry (validity, canonical SMILES, logging) overlaps device
        sampling: batch k is analysed on one worker thread while the device
        rolls out batch k+1.  One worker keeps the per-batch writes in
        order.  Under several processes every rank samples its share of
        the batches and rank 0 alone decodes and writes."""
        from concurrent.futures import ThreadPoolExecutor
        cfg = self.cfg
        if self.n_ranks > 1:
            model, epoch = self._broadcast_inference_model(
                cfg.generation_epoch)
        else:
            model, epoch = self._load_model_for_inference(
                cfg.generation_epoch)
        batch = min(cfg.batch_size, cfg.n_samples)
        n_batches = (cfg.n_samples + batch - 1) // batch
        analyzer = (Analyzer(cfg, self.logger, self._load_ts_properties(),
                             self.start_time) if self.primary else None)
        pending = None
        with ThreadPoolExecutor(max_workers=1) as pool:
            for k, res in self._generated_batches(model, batch, n_batches):
                if not self.primary:
                    continue
                if pending is not None:
                    pending.result()
                pending = pool.submit(
                    analyzer.evaluate_generated_graphs,
                    res.graphs, res.properly_terminated,
                    res.final_loglikelihoods,
                    epoch_key=f"Epoch {epoch} gen{k}",
                    write=True, plot=(k == 0))
            if pending is not None:
                pending.result()

    def _broadcast_inference_model(self, epoch: Optional[int]
                                   ) -> Tuple[nn.Module, int]:
        """Rank 0's checkpoint on every rank: rank 0 alone reads the job
        directory, the others take its weights and epoch."""
        cfg = self.cfg
        if self.primary:
            model, epoch = self._load_model_for_inference(epoch)
        else:
            model = build_model(cfg).to(self.device).eval()
        epoch = multihost.broadcast_object(epoch)
        multihost.broadcast_tensors_(list(model.parameters()))
        return model, epoch

    def _generated_batches(self, model: nn.Module, batch: int,
                           n_batches: int, quiet: bool = False
                           ) -> Iterator[Tuple[int, SampleResult]]:
        """(k, batch k) of the generate job: one sampler batch each, or with
        ``gen_two_phase_rounds`` > 0 the two-phase sampler over windows of
        4 batches, whose stragglers are continued together (the stats of
        each window go to ``self.two_phase_stats``).  ``quiet`` drops the
        per-batch lines.  Each batch this process sampled adds its
        (rounds, seconds) to ``self.batch_stats``.  Under several
        processes :meth:`_sharded_batches`, single-phase."""
        cfg = self.cfg
        if self.n_proc > 1 or self.on_mesh:
            if cfg.gen_two_phase_rounds > 0:
                print("-- gen_two_phase_rounds is off under several "
                      "processes and on a mesh (as in the JAX package)",
                      flush=True)
            batches = (self._sharded_batches if self.n_proc > 1
                       else self._mesh_batches)
            yield from batches(model, batch, n_batches, quiet)
            return
        if cfg.gen_two_phase_rounds <= 0:
            sampler = self._get_sampler(batch)
            for k in range(n_batches):
                res = sampler.sample(
                    model, batch_generator(cfg.seed, k, self.device), quiet)
                self.batch_stats.append((res.n_rounds, res.elapsed_s))
                yield k, res
            return
        sampler = TwoPhaseSampler(cfg, batch, cfg.gen_two_phase_rounds,
                                  device=self.device)
        window = 4
        for start in range(0, n_batches, window):
            n = min(window, n_batches - start)
            results, stats = sampler.sample_many(
                model, window_generator(cfg.seed, start, n, self.device), n,
                quiet)
            self.two_phase_stats.append(stats)
            for j, res in enumerate(results):
                self.batch_stats.append((res.n_rounds, res.elapsed_s))
                yield start + j, res

    def _mesh_batches(self, model: nn.Module, batch: int, n_batches: int,
                      quiet: bool) -> Iterator[Tuple[int, SampleResult]]:
        """The generate job on one process's mesh: every rank samples its
        rows of every batch, and rank 0 alone decodes and yields it."""
        cfg = self.cfg
        sampler = self._get_sampler(batch, on_mesh=True)
        for k in range(n_batches):
            t0 = time.time()
            packed = sampler.sample_packed(
                model, batch_generator(cfg.seed, k, self.device))
            self.batch_stats.append((_packed_rounds(cfg, packed),
                                     time.time() - t0))
            if self.primary:
                yield k, sampler._decode_packed(packed, time.time() - t0,
                                                quiet)

    def _sharded_batches(self, model: nn.Module, batch: int, n_batches: int,
                         quiet: bool) -> Iterator[Tuple[int, SampleResult]]:
        """The generate job over P processes: in round r, rank p samples
        global batch ``r * P + p`` with that batch's own generator (the
        molecules of a one-process job), the fixed-shape packed buffers are
        gathered, and rank 0 alone decodes and yields them; the others
        yield nothing.  Ranks past the last batch sample it again (the
        gather needs every rank's buffer) and their bytes are dropped.
        Each decoded batch is charged an equal share of its round's
        seconds."""
        cfg, P = self.cfg, self.n_proc
        sampler = self._get_sampler(batch)
        for r in range((n_batches + P - 1) // P):
            g = min(r * P + self.rank, n_batches - 1)
            t0 = time.time()
            packed = sampler.sample_packed(
                model, batch_generator(cfg.seed, g, self.device))
            self.batch_stats.append((_packed_rounds(cfg, packed),
                                     time.time() - t0))
            gathered = multihost.all_gather_bytes(packed)
            elapsed = time.time() - t0
            if not self.primary:
                continue
            n_decoded = min(P, n_batches - r * P)
            for p in range(n_decoded):
                yield r * P + p, sampler._decode_packed(
                    gathered[p], elapsed / n_decoded, quiet)

    # ------------------------------------------------------------------
    def testing_phase(self) -> None:
        """Scores the newest checkpoint against the test set: one sampled
        batch, the NLLs of random test and training rows, UC-JSD.  Under
        several processes rank 0 runs the job and the others return."""
        cfg = self.cfg
        if not self.primary and not self.on_mesh:
            return
        test_ds = self._open_dataset("test")
        train_ds = self._open_dataset("train")
        analyzer = (Analyzer(cfg, self.logger, self._load_ts_properties(),
                             self.start_time) if self.primary else None)
        place = BatchUploader(self.device)
        if self.on_mesh:
            # mesh-native: the sampler's rows over ``data``, the NLLs over
            # the mesh with the head split where it divides
            if cfg.batch_size % self.mesh.data:
                raise ValueError(
                    f"batch_size={cfg.batch_size} must divide by the data "
                    f"axis ({self.mesh.data}) for a sharded test job")
            model, epoch = self._broadcast_inference_model(None)
            split, _ = place_training_state(self.mesh, copy.deepcopy(model))
            sharded_nll = make_sharded_nll_step(cfg, split, self.mesh)

            def run_nll(b: Dict[str, np.ndarray]) -> np.ndarray:
                return sharded_nll(place(self._mesh_rows(b))).cpu().numpy()
        else:
            model, epoch = self._load_model_for_inference()
            nll_step = make_likelihood_step(cfg, model)

            def run_nll(b: Dict[str, np.ndarray]) -> np.ndarray:
                return nll_step(place(b)).cpu().numpy()

        sampler = self._get_sampler(min(cfg.batch_size, cfg.n_samples),
                                    on_mesh=True)
        generator = seeded_generator([cfg.seed], self.device, STREAM_TEST)
        t0 = time.time()
        packed = sampler.sample_packed(model, generator)
        res = sampler._decode_packed(packed, time.time() - t0)
        self.batch_stats.append((res.n_rounds, res.elapsed_s))
        if self.primary:
            analyzer.evaluate_generated_graphs(
                res.graphs, res.properly_terminated,
                res.final_loglikelihoods, epoch_key=f"Test epoch {epoch}")
        max_rows = min(100000, cfg.n_samples)
        nll_rng = np.random.default_rng(cfg.seed + 1)

        def loader_nlls(ds: HDFDataset) -> np.ndarray:
            return streamed_random_nlls(ds, run_nll, max_rows,
                                        cfg.batch_size, cfg.block_size,
                                        nll_rng)

        nll_test = loader_nlls(test_ds)
        nll_train = loader_nlls(train_ds)
        if not self.primary:
            return
        scores = analyzer.model_scores(nll_test, nll_train, res.action_nlls,
                                       cfg.n_samples)
        self.logger.write_validation_scores(f"Test {epoch}", scores)
        print("Test scores:", scores, flush=True)
