"""The port's QED, Morgan fingerprints and RL scoring function against the
JAX package's on the same molecules and graphs, on the CPU.

* descriptors: QED and its eight components for ~200 synthesized
  molecules and a fixed list (aromatic rings, charges, amides), equal to
  1e-12 (the port's module is a copy with its imports rewritten);
* fingerprints: Morgan bits equal, one molecule at a time and in bulk;
* ``ScoringFunction.compute_score``: equal to the JAX package's (1e-12)
  for ``target_size``, ``QED`` (continuous and binary), an ``*_activity``
  component through a pickled stand-in model, their combinations, and the
  invalid / duplicate / unterminated masks; and its four raises.
"""

import pickle

import numpy as np
import pytest

from graphinvent_tpu.chem import descriptors as jdesc
from graphinvent_tpu.chem import fingerprint as jfp
from graphinvent_tpu.chem.molgraph import MolGraph as JaxMolGraph
from graphinvent_tpu.chem.smiles import mol_from_smiles as jax_smiles
from graphinvent_tpu.config import test_config as jax_tiny
from graphinvent_tpu.eval.scoring import ScoringFunction as JaxScoring

from graphinvent_tpu_torch.chem import descriptors as pdesc
from graphinvent_tpu_torch.chem import fingerprint as pfp
from graphinvent_tpu_torch.chem.molgraph import MolGraph
from graphinvent_tpu_torch.chem.smiles import mol_from_smiles
from graphinvent_tpu_torch.config import test_config as port_tiny
from graphinvent_tpu_torch.eval.scoring import ScoringFunction
from graphinvent_tpu_torch.utils.synthetic import (
    synthesize_smiles, synthetic_graphs,
)

FIXED = ["c1ccccc1", "Cc1ccncc1", "c1ccsc1", "Oc1ccccc1C", "c1ccc2ccccc2c1",
         "CC(=O)Nc1ccc(O)cc1", "CC(=O)N(C)C", "NC(=O)c1ccccc1",
         "C[N+](C)(C)C", "[O-][N+](=O)c1ccccc1", "CC(=O)[O-]", "[NH4+]",
         "O=C1CCCN1", "CN1CCC(CC1)c1ccccc1", "OC(=O)C(N)Cc1ccccc1",
         "N#Cc1ccccc1", "CSc1ccccc1", "C=CC=O", "ClC(=O)c1ccccc1",
         "c1ccc2[nH]ccc2c1", "O=S(=O)(N)c1ccccc1", "C"]


def _molecules():
    return FIXED + synthesize_smiles(200, 4, 13, seed=5)


def test_qed_and_components_equal_jax():
    smiles = _molecules()
    n_ring = 0
    for s in smiles:
        pm, jm = mol_from_smiles(s), jax_smiles(s)
        got, want = pdesc.qed_properties(pm), jdesc.qed_properties(jm)
        assert sorted(got) == sorted(want) and len(got) == 8
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                       err_msg=f"{s} {k}")
        np.testing.assert_allclose(pdesc.qed(pm), jdesc.qed(jm), rtol=0,
                                   atol=1e-12, err_msg=s)
        n_ring += want["AROM"] > 0
    assert n_ring >= 10
    assert pdesc.qed(None) == jdesc.qed(None) == 0.0


def test_morgan_fingerprints_equal_jax():
    smiles = _molecules()
    pmols = [mol_from_smiles(s) for s in smiles]
    jmols = [jax_smiles(s) for s in smiles]
    for s, pm, jm in zip(smiles, pmols, jmols):
        got = pfp.morgan_fingerprint(pm)
        np.testing.assert_array_equal(got, jfp.morgan_fingerprint(jm),
                                      err_msg=s)
        assert got.sum() > 0
    bulk = pfp.bulk_fingerprints(pmols + [None])
    np.testing.assert_array_equal(bulk, jfp.bulk_fingerprints(jmols + [None]))
    assert bulk[-1].sum() == 0
    # kekulized and aromatic parses of one molecule hash alike
    np.testing.assert_array_equal(
        pfp.morgan_fingerprint(mol_from_smiles("Cc1ccncc1")),
        pfp.morgan_fingerprint(mol_from_smiles("Cc1ccncc1",
                                               kekulize_mol=False)))


class StandInQSAR:
    """A QSAR model's ``predict_proba`` over 2048-bit fingerprints: a
    logistic function of a seeded projection (defined at module level, so
    that pickle finds it)."""

    def __init__(self, seed=0):
        self.w = np.random.default_rng(seed).normal(size=2048) * 0.3

    def predict_proba(self, X):
        p = 1.0 / (1.0 + np.exp(-(np.asarray(X) @ self.w)))
        return np.stack([1.0 - p, p], axis=1)


class BrokenQSAR:
    def predict_proba(self, X):
        raise ValueError("X has 1024 features, expected 2048")


def _graphs(B=48, seed=3):
    """The same B graphs for both packages: seeded random graphs (some not
    molecules) and the fixed list's molecules."""
    from graphinvent_tpu.chem.molgraph import ordered_graph as jax_ordered
    from graphinvent_tpu_torch.chem.molgraph import ordered_graph
    jcfg, pcfg = jax_tiny("GGNN"), port_tiny("GGNN", device="cpu")
    nodes, edges = synthetic_graphs(pcfg, B, seed)
    n_nodes = (nodes.sum(-1) > 0).sum(-1)
    port = [MolGraph(pcfg, nodes[i], edges[i], n_nodes[i]) for i in range(B)]
    jax = [JaxMolGraph(jcfg, nodes[i], edges[i], n_nodes[i])
           for i in range(B)]
    for s in FIXED:
        try:        # the tiny config's atom types and charges take a few
            p = ordered_graph(mol_from_smiles(s), pcfg)
            j = jax_ordered(jax_smiles(s), jcfg)
        except Exception:
            continue
        port.append(MolGraph(pcfg, *p))
        jax.append(JaxMolGraph(jcfg, *j))
    return port, jax


def _masks(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random(n) < p).astype(np.int8) for p in (0.8, 0.7, 0.9)]


def _qsar_path(tmp_path, model):
    path = tmp_path / "qsar.pkl"
    with open(path, "wb") as fh:
        pickle.dump(model, fh)
    return str(path)


SCORES = {
    "target_size": (("target_size=5",), (0.0,), "binary"),
    "target_size-continuous": (("target_size=9",), (0.0,), "continuous"),
    "QED-continuous": (("QED",), (0.5,), "continuous"),
    "QED-binary": (("QED", "target_size=7"), (0.3, 0.5), "binary"),
    "QED-size-continuous": (("QED", "target_size=7"), (0.0, 0.0),
                            "continuous"),
    "activity": (("drd2_activity",), (0.5,), "continuous"),
    "all-binary": (("QED", "drd2_activity", "target_size=8"),
                   (0.2, 0.5, 0.4), "binary"),
    "all-continuous": (("QED", "drd2_activity", "target_size=8"),
                       (0.0, 0.0, 0.0), "continuous"),
}


@pytest.mark.parametrize("case", sorted(SCORES))
def test_compute_score_equals_jax(tmp_path, case):
    comps, thresholds, kind = SCORES[case]
    kw = dict(score_components=comps, score_thresholds=thresholds,
              score_type=kind,
              qsar_models={"drd2_activity": _qsar_path(tmp_path,
                                                       StandInQSAR())})
    port = ScoringFunction(port_tiny("GGNN", device="cpu", **kw))
    jax = JaxScoring(jax_tiny("GGNN", **kw))
    pgraphs, jgraphs = _graphs()
    n = len(pgraphs)
    ones = np.ones(n, np.int8)
    for term, valid, unique in [(ones, ones, ones), _masks(n)]:
        got = port.compute_score(pgraphs, term, valid, unique)
        want = jax.compute_score(jgraphs, term, valid, unique)
        assert got.dtype == np.float64 and got.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    masked = port.compute_score(pgraphs, *_masks(n))
    term, valid, unique = _masks(n)
    assert (masked[(term * valid * unique) == 0] == 0).all()
    assert len(np.unique(got)) > 1


def test_scoring_raises_like_jax(tmp_path):
    kw = dict(score_components=("drd2_activity",), score_thresholds=(0.5,),
              score_type="binary")
    # no model file, and no qsar_models entry at all
    for qsar in ({"drd2_activity": str(tmp_path / "missing.pkl")}, {}):
        with pytest.raises(FileNotFoundError):
            ScoringFunction(port_tiny("GGNN", device="cpu", qsar_models=qsar,
                                      **kw))
    # a degenerate target size (the config accepts it outside fine-tune)
    sf = ScoringFunction(port_tiny(
        "GGNN", device="cpu", score_components=("target_size=13",),
        score_thresholds=(0.0,), qsar_models={}))
    pgraphs, _ = _graphs(4)
    ones = np.ones(4)
    with pytest.raises(ValueError, match="target_size"):
        sf.compute_score(pgraphs, ones, ones, ones)
    # a model that fails in predict_proba
    sf = ScoringFunction(port_tiny(
        "GGNN", device="cpu",
        qsar_models={"drd2_activity": _qsar_path(tmp_path, BrokenQSAR())},
        **kw))
    with pytest.raises(RuntimeError, match="drd2_activity"):
        sf.compute_score(pgraphs, ones, ones, ones)
    # an unknown component
    sf = ScoringFunction(port_tiny(
        "GGNN", device="cpu", score_components=("logP",),
        score_thresholds=(0.0,), qsar_models={}))
    with pytest.raises(NotImplementedError, match="logP"):
        sf.compute_score(pgraphs, ones, ones, ones)
