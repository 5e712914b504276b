"""The port's jobs on the CPU, end to end through ``main``: the generate
job against the JAX package's on the same job directory; the full cycle
preprocess -> train -> restart -> generate -> test; a train job's
``convergence.log`` against the JAX package's from the same checkpoint
(rtol 1e-3: two epochs of f32 steps, in another summation order, fed back
through Adam); and the port's device and job-type rules."""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from graphinvent_tpu.config import GraphInventConfig as JaxConfig
from graphinvent_tpu.workflow import Workflow as JaxWorkflow

from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.data import HDFDataset, store
from graphinvent_tpu_torch.main import main as port_main
from graphinvent_tpu_torch.models import build_model
from graphinvent_tpu_torch.utils.device import resolve_device
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles
from graphinvent_tpu_torch.utils.weights import (
    load_optimizer_state, save_checkpoint,
)


def _job_dir(root, **kw):
    job = os.path.join(str(root), "job")
    os.makedirs(job)
    cfg = port_tiny("GGNN", device="cpu", job_type="generate",
                    job_dir=job + "/", dataset_dir=job + "/", n_samples=16,
                    batch_size=8, generation_epoch=1, tensorboard_dir="", **kw)
    cfg.write_csv(os.path.join(job, "input.csv"))
    save_checkpoint(build_model(cfg, torch.Generator().manual_seed(0)),
                    job, 1)
    return job, cfg


def _files(job):
    return sorted(os.path.relpath(os.path.join(d, f), job)
                  for d, _, fs in os.walk(job) for f in fs)


def _log_keys(job):
    with open(os.path.join(job, "generation.log")) as fh:
        return [row[0] for row in csv.reader(fh, delimiter=";")]


def _params(job):
    with open(os.path.join(job, "params.csv")) as fh:
        return {l.split(";")[0]: l for l in fh
                if not l.startswith(("job_dir;", "dataset_dir;"))}


def test_generate_job_writes_what_the_jax_job_writes(tmp_path):
    port_job, _ = _job_dir(tmp_path / "port")
    jax_job = str(tmp_path / "jax")
    os.makedirs(jax_job)
    for name in ("input.csv", "model_restart_1.pth"):
        shutil.copy(os.path.join(port_job, name), jax_job)

    workflow = port_main(["--job-dir", port_job])
    JaxWorkflow(JaxConfig.from_job_dir(jax_job)).run()

    assert _files(port_job) == _files(jax_job)
    assert _log_keys(port_job) == _log_keys(jax_job)
    assert _params(port_job) == _params(jax_job)
    assert [r for r, _ in workflow.batch_stats] and len(
        workflow.batch_stats) == 2
    for k in range(2):
        base = os.path.join(port_job, "generation", f"epoch_1_gen{k}")
        jbase = os.path.join(jax_job, "generation", f"epoch_1_gen{k}")
        smiles = open(base + ".smi").read().splitlines()
        assert smiles[0] == open(jbase + ".smi").read().splitlines()[0]
        valid = np.loadtxt(base + ".valid", dtype=int)
        ll = np.loadtxt(base + ".likelihood")
        assert len(smiles) - 1 == len(valid) == len(ll) == 8
        assert np.isfinite(ll).all() and (ll <= 0).all()
        assert all((s != "[Xx]") == bool(v)
                   for s, v in zip(smiles[1:], valid))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    job, _ = _job_dir(tmp_path)
    with open(os.path.join(job, "input.csv"), "a") as fh:
        fh.write("device;'cuda'\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--job-dir", job])


@pytest.mark.parametrize("device", ["tpu", "gpu", "cuda:1"])
def test_unknown_devices_are_refused(device):
    with pytest.raises(ValueError, match="device"):
        port_tiny("GGNN", device=device)
    with pytest.raises(ValueError):
        resolve_device(device)


def test_cpu_device_is_the_cpu():
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("job_type", ["preprocess", "train", "test",
                                      "fine-tune"])
def test_other_job_types_are_not_ported_yet(tmp_path, job_type):
    """Every job type is dispatched: here each gets as far as its missing
    input (the dataset; for ``fine-tune`` the pre-trained model)."""
    # a score valid at max_n_nodes=13, which a fine-tune config requires
    job, _ = _job_dir(tmp_path, score_components=("target_size=10",),
                      score_thresholds=(0.0,),
                      pretrained_model_dir=str(tmp_path / "none") + "/")
    argv = ["--job-dir", job, "--job-type", job_type]
    if job_type == "fine-tune":
        with pytest.raises(FileNotFoundError, match="pre-trained"):
            port_main(argv)
    elif job_type == "preprocess":
        port_main(argv)         # no .smi files: only the params snapshot
        assert os.path.exists(os.path.join(job, "preprocessing_params.csv"))
    else:
        with pytest.raises(FileNotFoundError, match="preprocess job first"):
            port_main(argv)


def test_multi_process_jobs_are_refused(tmp_path):
    job, _ = _job_dir(tmp_path, num_processes=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_main(["--job-dir", job])


# --------------------------------------------------------------------------
# preprocess, train, test
# --------------------------------------------------------------------------

def _dataset_dir(root, n=(60, 12, 12)):
    data = os.path.join(str(root), "data")
    os.makedirs(data)
    smiles = synthesize_smiles(sum(n), 3, 9, seed=5)
    lo = 0
    for name, k in zip(("train", "valid", "test"), n):
        with open(os.path.join(data, name + ".smi"), "w") as fh:
            fh.write("SMILES\n" + "\n".join(smiles[lo:lo + k]) + "\n")
        lo += k
    return data + "/"


def _run(job, data, job_type, **kw):
    os.makedirs(job, exist_ok=True)
    cfg = port_tiny("GGNN", device="cpu", job_type=job_type,
                    job_dir=job + "/", dataset_dir=data, tensorboard_dir="",
                    batch_size=32, block_size=96, n_samples=40, **kw)
    cfg.write_csv(os.path.join(job, "input.csv"))
    return port_main(["--job-dir", job])


def _train_rows(data):
    ds = HDFDataset(store.find_dataset(data + "train"))
    n = len(ds)
    ds.close()
    return n


def _convergence(job):
    with open(os.path.join(job, "convergence.log")) as fh:
        rows = fh.read().splitlines()[1:]
    return [[x.strip() for x in r.split(",")] for r in rows]


def _validation_keys(job):
    with open(os.path.join(job, "validation.log")) as fh:
        return [r.split(",")[0] for r in fh.read().splitlines()[1:]]


def test_full_cycle_preprocess_train_restart_generate_test(tmp_path, capsys):
    data = _dataset_dir(tmp_path)
    job = str(tmp_path / "job")
    _run(job, data, "preprocess")
    for name in ("train.h5", "valid.h5", "test.h5", "train.csv",
                 "preprocessing_params.csv"):
        assert os.path.exists(data + name), name
    assert "Python route path" in capsys.readouterr().out

    w = _run(job, data, "train", epochs=2)
    out = capsys.readouterr().out
    assert "device-resident epoch path" in out and "(hdf5," in out
    assert w.data_path == "resident"
    steps = w.adam.step
    assert steps == 2 * -(-_train_rows(data) // 32)
    rows = _convergence(job)
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(x)) for r in rows for x in r)
    assert _validation_keys(job) == ["Epoch 1", "Epoch 2"]
    for epoch in (1, 2):
        assert os.path.exists(os.path.join(
            job, f"model_restart_{epoch}.pth"))
        assert load_optimizer_state(job, epoch)["step"] == steps * epoch // 2
    assert os.path.exists(os.path.join(job, "generation",
                                       "epoch_2.smi"))

    # restart: epoch 3, Adam's moments and step count carried on, this time
    # on the streamed path (packed + sparse wire, upload-ahead)
    w = _run(job, data, "train", epochs=1, restart=True, device_data_gb=0.0,
             schedule_epochs=3)
    out = capsys.readouterr().out
    assert "Restored Adam's moments at step %d" % steps in out
    assert "streamed epoch path" in out and w.data_path == "streamed"
    assert w.adam.step > steps
    rows = _convergence(job)
    assert [r[0] for r in rows] == ["1", "2", "3"]
    assert np.isfinite([float(x) for x in rows[2]]).all()
    assert _validation_keys(job)[-1] == "Epoch 3"
    assert load_optimizer_state(job, 3)["step"] == w.adam.step

    # a restart from weights alone starts Adam fresh
    os.remove(os.path.join(job, "optimizer_restart_3.pth"))
    w = _run(job, data, "train", epochs=1, restart=True, sample_every=10,
             stream_upload_ahead=False, device_data_gb=0.0)
    assert "Restored Adam" not in capsys.readouterr().out
    assert 0 < w.adam.step < steps
    assert os.path.exists(os.path.join(job, "model_restart_4.pth"))
    assert _validation_keys(job)[-1] == "Epoch 3"      # no evaluation at 4

    w = _run(job, data, "generate", generation_epoch=4)
    assert len(w.batch_stats) == 2
    assert os.path.exists(os.path.join(job, "generation",
                                       "epoch_4_gen1.smi"))
    _run(job, data, "test")
    out = capsys.readouterr().out
    assert "model_restart_4.pth" in out and "Test scores:" in out
    assert _validation_keys(job)[-1] == "Test 4"
    with open(os.path.join(job, "validation.log")) as fh:
        last = [float(x) for x in fh.read().splitlines()[-1].split(",")[1:]]
    assert np.isfinite(last).all()


def test_train_job_convergence_log_matches_the_jax_job(tmp_path):
    """Both packages restart from the same ``model_restart_0.pth`` (f32,
    dropout 0, Adam fresh) on the same dataset, device-resident path: same
    batches from the same ``epoch_permutation`` stream."""
    data = _dataset_dir(tmp_path)
    port_job, jax_job = str(tmp_path / "port"), str(tmp_path / "jax")
    _run(port_job, data, "preprocess")
    kw = dict(epochs=2, restart=True, sample_every=10)
    cfg = port_tiny("GGNN", device="cpu")
    os.makedirs(jax_job)
    for job in (port_job, jax_job):
        save_checkpoint(build_model(cfg, torch.Generator().manual_seed(3)),
                        job, 0)
    w = _run(port_job, data, "train", **kw)
    shutil.copy(os.path.join(port_job, "input.csv"), jax_job)
    jcfg = JaxConfig.from_job_dir(jax_job).replace(job_dir=jax_job + "/")
    JaxWorkflow(jcfg).run()
    got, want = _convergence(port_job), _convergence(jax_job)
    assert [r[0] for r in got] == [r[0] for r in want] == ["1", "2"]
    assert [r[4] for r in got] == [r[4] for r in want] == ["NA", "NA"]
    for g, wnt in zip(got, want):
        np.testing.assert_allclose([float(x) for x in g[1:4]],
                                   [float(x) for x in wnt[1:4]], rtol=1e-3)
    assert float(got[1][2]) < float(got[0][2])          # it learns
    assert w.adam.step == 2 * -(-_train_rows(data) // 32)
    # the JAX package reads the checkpoint the port's train job wrote
    assert os.path.exists(os.path.join(port_job, "model_restart_2.pth"))
    assert os.path.exists(os.path.join(jax_job, "model_restart_2.ckpt"))
