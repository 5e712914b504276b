"""Job orchestration for the PyTorch port.

Counterpart of ``graphinvent_tpu/workflow.py`` (reference Workflow.py).
The port runs all five job types, ``preprocess``, ``train``, ``generate``,
``test`` and ``fine-tune`` (``rl/workflow_rl.py``), for all six models in
one process on one device; multi-process runs raise
``NotImplementedError`` (ROADMAP.md, queue A).

Training state is explicit: the model (float32 master weights on the
device) and a ``train.optim.Adam`` (step count and both moments), both
checkpointed.  Training takes the unfused ``models/core`` path under
autograd; every grad-free forward (validation loss, dataset NLLs, sampling)
goes through the fused kernel on a CUDA device.
"""

from __future__ import annotations

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
from graphinvent_tpu_torch.sampling import GraphSampler, SampleResult
from graphinvent_tpu_torch.sampling.generator import (
    STREAM_DROPOUT, STREAM_EVALUATE, STREAM_TEST, batch_generator,
    seeded_generator,
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
    checkpoint_path, latest_checkpoint, load_checkpoint,
    load_optimizer_state, save_checkpoint,
)

NllFn = Callable[[str, int], np.ndarray]


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
        if cfg.job_type != "preprocess":
            cfg.check_preprocessing_params()
        if cfg.num_processes > 1:
            raise NotImplementedError(
                "multi-process jobs are not ported to PyTorch yet (see "
                "ROADMAP.md, queue A: parallelism)")
        self.cfg = cfg
        # preprocessing is host work and needs no card
        self.device = (torch.device("cpu") if cfg.job_type == "preprocess"
                       else resolve_device(cfg.device))
        self.start_time = time.time()
        self.logger = JobLogger(cfg.job_dir, cfg.tensorboard_dir)
        # snapshot of the fully-resolved config this job runs with
        # (reference: util.write_job_parameters, util.py:478-498)
        cfg.write_csv(os.path.join(cfg.job_dir, "params.csv"))
        # (rounds, seconds) of each sampled batch, for callers that report
        # throughput
        self.batch_stats: List[Tuple[int, float]] = []
        self.two_phase_stats: List[Dict[str, float]] = []
        self._samplers: Dict[int, GraphSampler] = {}

    def _get_sampler(self, batch_size: int) -> GraphSampler:
        """One GraphSampler per batch size for the whole job."""
        if batch_size not in self._samplers:
            self._samplers[batch_size] = GraphSampler(
                self.cfg, batch_size, device=self.device)
        return self._samplers[batch_size]

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
        takes the newest checkpoint; Adam's moments come back with it when
        its sidecar is there, else Adam starts fresh (a reference
        checkpoint holds weights only)."""
        cfg = self.cfg
        found = latest_checkpoint(cfg.job_dir) if cfg.restart else None
        if found:
            path, epoch = found
            print(f"-- Restoring checkpoint {path}", flush=True)
            model = load_checkpoint(cfg, path).to(self.device)
            adam = Adam(model)
            state = load_optimizer_state(cfg.job_dir, epoch)
            if state is not None:
                adam.load_state_dict(state)
                print(f"-- Restored Adam's moments at step {adam.step}",
                      flush=True)
            return model, adam, epoch + 1
        model = build_model(
            cfg, torch.Generator().manual_seed(cfg.seed)).to(self.device)
        return model, Adam(model), 1

    # ------------------------------------------------------------------
    def training_phase(self) -> None:
        cfg = self.cfg
        print("* Setting up training job.", flush=True)
        train_ds = self._open_dataset("train")
        valid_ds = self._open_dataset("valid")
        ts_props = self._load_ts_properties()
        analyzer = Analyzer(cfg, self.logger, ts_props, self.start_time)
        if not cfg.restart:
            self.logger.init_convergence()
            if ts_props:
                self.logger.properties_to_csv(ts_props, "Training set",
                                              append=False)

        n_batches = (len(train_ds) + cfg.batch_size - 1) // cfg.batch_size
        schedule = onecycle_for_config(cfg, n_batches)
        model, adam, start_epoch = self._init_or_restore()
        self.model, self.adam = model, adam

        # the budget bounds the SUM of resident datasets: train and valid
        # sit in device memory together
        budget = int(cfg.device_data_gb * (1 << 30))
        use_device = (DeviceDataset.nbytes_of(train_ds)
                      + DeviceDataset.nbytes_of(valid_ds) <= budget)
        # which epoch path this job took, for callers that check it
        self.data_path = "resident" if use_device else "streamed"
        if use_device:
            print("-- Dataset fits in device memory: device-resident epoch "
                  "path.", flush=True)
            run_train_epoch, run_valid_epoch, dataset_nlls = \
                self._resident_epochs(train_ds, valid_ds, schedule)
        else:
            print("-- Dataset exceeds device_data_gb: streamed epoch path "
                  f"(packed={bool(cfg.stream_packed)}, "
                  f"apd_nnz={cfg.stream_apd_nnz if cfg.stream_packed else 0}, "
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
            self.logger.write_training_status(epoch, float(lr), train_loss,
                                              valid_loss)
            if epoch % cfg.sample_every == 0:
                self.evaluate_model(model, epoch, analyzer, dataset_nlls)
                save_checkpoint(model, cfg.job_dir, epoch, adam.state_dict())
        save_checkpoint(model, cfg.job_dir, end_epoch - 1, adam.state_dict())

    def _dropout_generator(self, epoch: int) -> torch.Generator:
        """Dropout masks of ``epoch``'s train steps, drawn in step order."""
        return seeded_generator([self.cfg.seed, epoch], self.device,
                                STREAM_DROPOUT)

    def _resident_epochs(self, train_ds: HDFDataset, valid_ds: HDFDataset,
                         schedule) -> Tuple[Callable, Callable, NllFn]:
        cfg, model, adam = self.cfg, self.model, self.adam
        dtrain = DeviceDataset(train_ds, self.device)
        dvalid = DeviceDataset(valid_ds, self.device)
        train_epoch_fn = make_epoch_train_fn(cfg, schedule, dtrain, model,
                                             adam)
        valid_epoch_fn = make_epoch_eval_fn(cfg, dvalid, model)
        nll_fns = {"valid": make_epoch_nll_fn(cfg, dvalid, model),
                   "train": make_epoch_nll_fn(cfg, dtrain, model)}
        sizes = {"valid": len(valid_ds), "train": len(train_ds)}
        rng_np = np.random.default_rng(cfg.seed)
        nll_rng = np.random.default_rng(cfg.seed + 1)

        def run_train_epoch(epoch: int) -> float:
            perm = epoch_permutation(len(train_ds), cfg.batch_size, rng_np)
            return train_epoch_fn(perm, self._dropout_generator(epoch))

        def run_valid_epoch() -> float:
            return valid_epoch_fn(epoch_permutation(
                len(valid_ds), cfg.batch_size, np.random.default_rng(0)))

        def dataset_nlls(which: str, max_rows: int) -> np.ndarray:
            nlls, valid = nll_fns[which](nll_row_batches(
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
        apd_nnz = cfg.stream_apd_nnz if packed else 0
        train_loader = BlockLoader(train_ds, cfg.batch_size, cfg.block_size,
                                   seed=cfg.seed, packed=packed,
                                   apd_nnz=apd_nnz)
        valid_loader = BlockLoader(valid_ds, cfg.batch_size, cfg.block_size,
                                   shuffle=False, seed=cfg.seed,
                                   packed=packed, apd_nnz=apd_nnz)
        train_step = make_train_step(cfg, schedule, model, adam)
        eval_step = make_eval_step(cfg, model)
        nll_step = make_likelihood_step(cfg, model)
        # one uploader serves the worker thread during a train epoch and
        # this thread between epochs; the two never upload at once
        place = BatchUploader(self.device)
        nll_datasets = {"valid": valid_ds, "train": train_ds}
        stream_nll_rng = np.random.default_rng(cfg.seed + 1)

        def placed_batches(epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
            train_loader.set_epoch(epoch)
            # the schedule was planned for n_batches steps an epoch; blocks
            # with remainder batches can yield more
            batches = itertools.islice(train_loader, n_batches)
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
            vlosses = [eval_step(place(b)) for b in valid_loader]
            return torch.stack(vlosses).mean().item()

        def dataset_nlls(which: str, max_rows: int) -> np.ndarray:
            # uniform random rows, like the device-resident path's
            # nll_row_batches
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
        nll_valid = dataset_nlls("valid", max_rows)
        nll_train = dataset_nlls("train", max_rows)
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
                raise FileNotFoundError(
                    f"{path} not found (the port reads "
                    f"model_restart_<epoch>.pth state_dicts; a JAX .ckpt is "
                    f"not read)")
        else:
            found = latest_checkpoint(cfg.job_dir)
            if not found:
                raise FileNotFoundError(
                    f"no model_restart_<epoch>.pth in {cfg.job_dir}")
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
        order."""
        from concurrent.futures import ThreadPoolExecutor
        cfg = self.cfg
        model, epoch = self._load_model_for_inference(cfg.generation_epoch)
        batch = min(cfg.batch_size, cfg.n_samples)
        n_batches = (cfg.n_samples + batch - 1) // batch
        analyzer = Analyzer(cfg, self.logger, self._load_ts_properties(),
                            self.start_time)
        pending = None
        with ThreadPoolExecutor(max_workers=1) as pool:
            for k, res in self._generated_batches(model, batch, n_batches):
                self.batch_stats.append((res.n_rounds, res.elapsed_s))
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

    def _generated_batches(self, model: nn.Module, batch: int,
                           n_batches: int
                           ) -> Iterator[Tuple[int, SampleResult]]:
        """(k, batch k) of the generate job: one sampler batch each, or with
        ``gen_two_phase_rounds`` > 0 the two-phase sampler over windows of
        4 batches, whose stragglers are continued together (the stats of
        each window go to ``self.two_phase_stats``)."""
        cfg = self.cfg
        if cfg.gen_two_phase_rounds <= 0:
            sampler = self._get_sampler(batch)
            for k in range(n_batches):
                yield k, sampler.sample(
                    model, batch_generator(cfg.seed, k, self.device))
            return
        sampler = TwoPhaseSampler(cfg, batch, cfg.gen_two_phase_rounds,
                                  device=self.device)
        window = 4
        for start in range(0, n_batches, window):
            n = min(window, n_batches - start)
            results, stats = sampler.sample_many(
                model, window_generator(cfg.seed, start, n, self.device), n,
                quiet=False)
            self.two_phase_stats.append(stats)
            for j, res in enumerate(results):
                yield start + j, res

    # ------------------------------------------------------------------
    def testing_phase(self) -> None:
        """Scores the newest checkpoint against the test set: one sampled
        batch, the NLLs of random test and training rows, UC-JSD."""
        cfg = self.cfg
        test_ds = self._open_dataset("test")
        train_ds = self._open_dataset("train")
        analyzer = Analyzer(cfg, self.logger, self._load_ts_properties(),
                            self.start_time)
        model, epoch = self._load_model_for_inference()
        nll_step = make_likelihood_step(cfg, model)
        place = BatchUploader(self.device)

        sampler = self._get_sampler(min(cfg.batch_size, cfg.n_samples))
        res = sampler.sample(model, seeded_generator([cfg.seed], self.device,
                                                    STREAM_TEST))
        self.batch_stats.append((res.n_rounds, res.elapsed_s))
        analyzer.evaluate_generated_graphs(
            res.graphs, res.properly_terminated, res.final_loglikelihoods,
            epoch_key=f"Test epoch {epoch}")
        max_rows = min(100000, cfg.n_samples)
        nll_rng = np.random.default_rng(cfg.seed + 1)

        def loader_nlls(ds: HDFDataset) -> np.ndarray:
            return streamed_random_nlls(
                ds, lambda b: nll_step(place(b)).cpu().numpy(),
                max_rows, cfg.batch_size, cfg.block_size, nll_rng)

        nll_test = loader_nlls(test_ds)
        nll_train = loader_nlls(train_ds)
        scores = analyzer.model_scores(nll_test, nll_train, res.action_nlls,
                                       cfg.n_samples)
        self.logger.write_validation_scores(f"Test {epoch}", scores)
        print("Test scores:", scores, flush=True)
