"""The port's job tools (graphinvent_tpu_torch/tools/) on the CPU: the
ChEMBL-proxy campaign in process, its datasets held to the JAX campaign's
on the same arguments; submit's pipeline and SLURM file; the logistic
QSAR trainer against scikit-learn and its pickle through the scorer."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import _torch_port_util  # noqa: F401  (caps torch's threads)
from graphinvent_tpu_torch.chem import mol_from_smiles
from graphinvent_tpu_torch.chem.fingerprint import bulk_fingerprints
from graphinvent_tpu_torch.tools import campaign_chembl, submit, train_qsar
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the size of tests/test_campaign.py's miniature campaign
CAMPAIGN = ["--n", "60", "--min-atoms", "6", "--max-atoms", "12",
            "--shards", "2", "--epochs", "1", "--batch-size", "8",
            "--n-generate", "8"]
QSAR_PROB_TOL = 1e-4


def h5_arrays(path):
    import h5py
    with h5py.File(path, "r") as fh:
        return {k: np.asarray(fh[k]) for k in ("nodes", "edges", "APDs")}


def test_in_process_campaign_datasets_equal_the_jax_campaigns(
        tmp_path, monkeypatch):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for stage in ("data", "preprocess"):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "campaign_chembl.py"),
                        "--root", jax_root, *CAMPAIGN, "--stage", stage],
                       env=env, cwd=str(tmp_path), check=True,
                       capture_output=True)
    monkeypatch.chdir(tmp_path)
    argv = ["--root", port_root, *CAMPAIGN, "--in-process", "--device",
            "cpu", "--set", "tensorboard_dir="]
    out = campaign_chembl.main(argv)

    jd, pd = os.path.join(jax_root, "data"), os.path.join(port_root, "data")
    for name in ("train.smi", "valid.smi", "test.smi", "train.csv",
                 "preprocessing_params.csv"):
        assert open(os.path.join(pd, name)).read() == \
            open(os.path.join(jd, name)).read(), name
    assert open(os.path.join(port_root, "raw.smi")).read() == \
        open(os.path.join(jax_root, "raw.smi")).read()
    for split in ("train", "valid", "test"):
        for suffix in ("", ".shard0", ".shard1"):
            got = h5_arrays(os.path.join(pd, f"{split}.h5{suffix}"))
            want = h5_arrays(os.path.join(jd, f"{split}.h5{suffix}"))
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (split, suffix, k)

    jobs = os.path.join(port_root, "jobs", "train-ggnn")
    assert os.path.exists(os.path.join(jobs, "model_restart_1.pth"))
    assert os.path.exists(os.path.join(jobs, "convergence.log"))
    assert any(f.endswith(".smi")
               for f in os.listdir(os.path.join(jobs, "generation")))
    assert "Test" in open(os.path.join(jobs, "validation.log")).read()
    metrics = json.load(open(os.path.join(jobs, "moses_metrics.json")))
    assert metrics == out["metrics"]
    for key in ("validity", "novelty", "int_div_1", "scaffold_novelty"):
        assert 0.0 <= metrics[key] <= 1.0, key
    assert set(out["seconds"]) == set(campaign_chembl.STAGES)

    # resume: data, preprocess, train and generate skip; test and score
    # run again and score the same molecules (all but the suite's seconds)
    again = campaign_chembl.main(argv)
    assert again["metrics"].pop("wall_s") >= 0
    assert again["metrics"] == {k: v for k, v in metrics.items()
                                if k != "wall_s"}
    assert again["seconds"]["train"] < 0.5 * out["seconds"]["train"]


def test_dataset_exists_finds_either_back_end(tmp_path):
    assert not campaign_chembl.dataset_exists(str(tmp_path))
    (tmp_path / "train.npd").mkdir()
    assert campaign_chembl.dataset_exists(str(tmp_path))


TINY = ["--set", "epochs=1", "--set", "batch_size=8", "--set", "block_size=64",
        "--set", "n_samples=8", "--set", "sample_every=99",
        "--set", "generation_epoch=1", "--set", "mlp1_depth=2",
        "--set", "mlp1_hidden_dim=24", "--set", "mlp2_depth=2",
        "--set", "mlp2_hidden_dim=24", "--set", "enn_depth=2",
        "--set", "enn_hidden_dim=12", "--set", "hidden_node_features=16",
        "--set", "message_size=16", "--set", "message_passes=2",
        "--set", "gather_width=10", "--set", "gather_att_depth=2",
        "--set", "gather_att_hidden_dim=12", "--set", "gather_emb_depth=2",
        "--set", "gather_emb_hidden_dim=12", "--set", "compute_dtype=float32",
        "--set", "tensorboard_dir="]


def small_dataset(data_dir):
    os.makedirs(data_dir)
    smiles = ["CC", "CCC", "CCO", "CC(C)C", "C1CC1", "OC1CC1", "NCCN", "CC#N"]
    for split in ("train", "valid", "test"):
        with open(os.path.join(data_dir, f"{split}.smi"), "w") as fh:
            fh.write("SMILES\n" + "\n".join(smiles) + "\n")


def test_submit_pipeline_runs_stages_in_one_process(tmp_path, capsys):
    data_dir = str(tmp_path / "data") + "/"
    small_dataset(data_dir)
    job_dir = str(tmp_path / "job") + "/"
    out = submit.main(["--job-dir", job_dir,
                       "--pipeline", "preprocess,train,generate",
                       "--dataset-dir", data_dir, "--model", "GGNN",
                       "--device", "cpu", *TINY])
    assert out["stages"] == ["preprocess", "train", "generate"]
    assert set(out["seconds"]) == set(out["stages"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    from graphinvent_tpu_torch.data import store
    for split in ("train", "valid", "test"):
        store.find_dataset(os.path.join(data_dir, split))
    assert os.path.exists(os.path.join(job_dir, "model_restart_1.pth"))
    assert any(f.endswith(".smi")
               for f in os.listdir(os.path.join(job_dir, "generation")))
    with pytest.raises(SystemExit, match="deploy"):
        submit.main(["--job-dir", job_dir, "--pipeline", "train,deploy",
                     "--dataset-dir", data_dir])


def test_submit_writes_a_slurm_file_that_reruns_the_tool(tmp_path):
    slurm = str(tmp_path / "job.sh")
    job_dir = str(tmp_path / "job")
    submit.main(["--job-dir", job_dir, "--job-type", "generate",
                 "--dataset-dir", str(tmp_path), "--slurm", slurm,
                 "--time", "01:00:00", "--set", 'atom_types=["C","N"]'])
    text = open(slurm).read()
    assert "#SBATCH --time=01:00:00" in text
    assert "#SBATCH --gres=gpu:1" in text
    cmd = text.strip().splitlines()[-1]
    assert "-m graphinvent_tpu_torch.tools.submit" in cmd
    assert "--slurm" not in cmd and "--time" not in cmd
    assert "'atom_types=[\"C\",\"N\"]'" in cmd
    assert os.path.exists(os.path.join(job_dir, "input.csv"))


def ring_split(tmp_path, n=240):
    """Stand-in labels (no labelled actives are in the repo): seeded
    SMILES, "active" when the molecule has a ring."""
    smiles = synthesize_smiles(n, 5, 12, seed=21)
    rings = [bool(mol_from_smiles(s).rings()) for s in smiles]
    paths = {}
    for name, keep in (("actives", True), ("inactives", False)):
        paths[name] = str(tmp_path / f"{name}.smi")
        with open(paths[name], "w") as fh:
            fh.write("SMILES\n" + "\n".join(
                s for s, r in zip(smiles, rings) if r == keep) + "\n")
    return paths, smiles


def test_train_qsar_logistic_equals_sklearn_and_scores(tmp_path):
    from sklearn.linear_model import LogisticRegression
    paths, smiles = ring_split(tmp_path)
    out_path = str(tmp_path / "qsar.pickle")
    out = train_qsar.main([paths["actives"], paths["inactives"], out_path,
                           "--device", "cpu"])
    assert out["classifier"] == "logistic" and 0 < out["n_active"] < out["n"]
    with open(out_path, "rb") as fh:
        model = pickle.load(fh)["classifier_sv"]
    X_act = train_qsar.fingerprints(paths["actives"])
    X_inact = train_qsar.fingerprints(paths["inactives"])
    X = np.concatenate([X_act, X_inact])
    y = np.concatenate([np.ones(len(X_act)), np.zeros(len(X_inact))])
    # scikit-learn's objective at C=1.0, solved to its optimum: at the
    # default tol=1e-4 lbfgs stops ~5e-3 away in probability
    sk = LogisticRegression(C=1.0, tol=1e-10, max_iter=10000).fit(X, y)
    probe = bulk_fingerprints([mol_from_smiles(s) for s in
                               synthesize_smiles(60, 5, 14, seed=22)])
    for data in (X, probe):
        err = np.abs(model.predict_proba(data) - sk.predict_proba(data)).max()
        assert err <= QSAR_PROB_TOL, err

    # the pickle through the scorer: an "*_activity" component
    from graphinvent_tpu_torch.chem.molgraph import MolGraph, mol_to_graph
    from graphinvent_tpu_torch.config import test_config
    from graphinvent_tpu_torch.eval.scoring import ScoringFunction
    cfg = test_config(job_type="fine-tune", max_n_nodes=14,
                      score_components=("ring_activity",),
                      score_thresholds=(0.0,), score_type="continuous",
                      qsar_models={"ring_activity": out_path})
    mols = [mol_from_smiles(s) for s in smiles[:20]]
    graphs = []
    for m in mols:
        nodes, edges = mol_to_graph(m, cfg, pad=True)
        graphs.append(MolGraph(cfg, nodes, edges, m.n_atoms, molecule=m))
    ones = np.ones(len(graphs))
    scores = ScoringFunction(cfg).compute_score(graphs, ones, ones, ones)
    assert np.array_equal(scores, model.predict_proba(
        bulk_fingerprints(mols))[:, 1])


def test_train_qsar_svc_is_not_ported(tmp_path):
    paths, _ = ring_split(tmp_path, n=20)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A 5"):
        train_qsar.main([paths["actives"], paths["inactives"],
                         str(tmp_path / "q.pickle"), "--classifier", "svc",
                         "--device", "cpu"])
