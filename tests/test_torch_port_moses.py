"""The port's MOSES-style metrics (graphinvent_tpu_torch/eval/moses.py)
against the JAX package's eval/moses.py on the same seeded inputs: the
whole metric dict, IntDiv's blocked Gram matrix, Bemis-Murcko scaffolds
(including a cumulated chain, where the re-attach pass depends on atom
order) and the worker pools after torch has run."""

import math

import numpy as np
import pytest
import torch

import _torch_port_util  # noqa: F401  (caps torch's threads)
from graphinvent_tpu.chem.smiles import mol_from_smiles as jax_mol
from graphinvent_tpu.eval import moses as jax_moses
from graphinvent_tpu_torch.chem.smiles import mol_from_smiles as port_mol
from graphinvent_tpu_torch.eval import moses
from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles

COUNT_KEYS = ("n_generated", "validity", "unique@1000", "unique@10000",
              "uniqueness", "novelty", "scaffold_uniqueness",
              "scaffold_novelty", "pass_filters")
W1_KEYS = ("w1_mw", "w1_alogp", "w1_qed", "w1_tpsa")
INTDIV_TOL = 1e-6
W1_TOL = 1e-12


def smiles_sets(n_gen=240, seed=3):
    """Seeded generated / train / test sets: aromatic molecules of 6-14
    atoms, duplicates, molecules shared with the training set, an invalid
    row ([Xx]) and a string that does not parse."""
    pool = synthesize_smiles(n_gen + 160, 6, 14, seed=seed, aromatic=True)
    gen = pool[:n_gen] + pool[:20] + pool[n_gen:n_gen + 30] + [
        "[Xx]", "not_a_smiles", "C1CC"]
    train = pool[n_gen:n_gen + 120] + ["CCO", "c1ccccc1"]
    test = pool[n_gen + 120:]
    return gen, train, test


def check_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in COUNT_KEYS:
        assert got[k] == want[k], k
    for k in W1_KEYS:
        assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=W1_TOL), k
    for k in ("int_div_1", "int_div_2"):
        assert abs(got[k] - want[k]) <= INTDIV_TOL, k


@pytest.mark.parametrize("with_test", [True, False])
def test_compute_metrics_equals_jax(with_test):
    gen, train, test = smiles_sets()
    test = test if with_test else None
    kw = dict(n_intdiv=150, n_props=100, seed=5)
    got = moses.compute_metrics(gen, train, test, device="cpu", **kw)
    want = jax_moses.compute_metrics(gen, train, test, **kw)
    check_metrics_equal(got, want)
    assert 0 < got["validity"] < 1 and 0 < got["novelty"] < 1
    assert 0 < got["int_div_1"] < 1


@pytest.mark.parametrize("block", [1, 7, 64, 2048])
def test_internal_diversity_equals_jax_at_every_block(block):
    rng = np.random.default_rng(block)
    fps = (rng.random((150, 2048)) < 0.03).astype(np.float32)
    fps[3] = 0                          # an empty fingerprint: union 0
    fps[7] = fps[8]                     # a duplicate pair
    got = moses.internal_diversity_both(fps, block=block, device="cpu")
    want = jax_moses.internal_diversity_both(fps, block=block)
    assert np.allclose(got, want, rtol=0, atol=INTDIV_TOL)
    assert moses.internal_diversity(fps, p=2, block=block, device="cpu") \
        == got[1]


def test_intersection_counts_are_exact_integers():
    rng = np.random.default_rng(0)
    fps = (rng.random((40, 2048)) < 0.6).astype(np.float32)
    f = torch.from_numpy(fps)
    counts = moses.intersection_counts(f, 5, 25)
    want = fps[5:25].astype(np.int64) @ fps.T.astype(np.int64)
    assert counts.dtype == torch.float32
    assert np.array_equal(counts.numpy().astype(np.int64), want)
    assert want.max() > 256          # beyond bf16's exact integers


def test_internal_diversity_of_nothing_and_bad_power():
    assert moses.internal_diversity_both(np.zeros((0, 8)), device="cpu") \
        == (0.0, 0.0)
    with pytest.raises(ValueError, match="p in"):
        moses.internal_diversity(np.ones((2, 4)), p=3, device="cpu")


# the molecules of tests/test_moses.py, two acyclic and ring-free ones, and
# one cumulated chain off a ring written both ways round: its scaffold
# depends on atom order (the JAX package's and the port's keep the chain
# when its atoms come after the ring atom, RDKit keeps one atom either way)
SCAFFOLD_SMILES = [
    "Cc1ccccc1", "CC(=O)c1ccccc1", "O=C1CCCCC1", "c1ccccc1CCc1ccccc1",
    "CCO", "Cc1cc[nH]c1", "CC(C)(C)c1ccc(O)cc1", "N#Cc1ccccc1",
    "C1CCC(=C=C=C)CC1", "C=C=C=C1CCCCC1",
]


@pytest.mark.parametrize("smiles", SCAFFOLD_SMILES)
def test_scaffold_equals_jax(smiles):
    got = moses.murcko_scaffold(port_mol(smiles))
    assert got == jax_moses.murcko_scaffold(jax_mol(smiles))


def test_cumulated_chain_scaffold_depends_on_atom_order():
    """ADVICE.md's low finding, kept equal to the JAX package: one
    molecule, two atom orders, two scaffolds (ROADMAP C)."""
    chain_last = moses.murcko_scaffold(port_mol("C1CCC(=C=C=C)CC1"))
    chain_first = moses.murcko_scaffold(port_mol("C=C=C=C1CCCCC1"))
    assert chain_last == moses.canonicalize("C=C=C=C1CCCCC1")
    assert chain_first == moses.canonicalize("C=C1CCCCC1")


def test_pool_after_a_torch_op_twice_equals_the_serial_path():
    """Worker pools started after torch has run its CPU thread pool (the
    card's case: after CUDA init) return, twice in one process, the serial
    path's results.  1,100 SMILES is more than 4 x the chunk of 256, so
    the canonicalization and scaffold passes run in the pool."""
    x = torch.randn(256, 256)
    torch.mm(x, x).sum().item()
    smiles = synthesize_smiles(1100, 4, 8, seed=11)
    gen, train = smiles + ["[Xx]"], smiles[::3]
    kw = dict(n_intdiv=200, n_props=200, device="cpu")
    serial = moses.compute_metrics(gen, train, n_jobs=0, **kw)
    for _ in range(2):
        assert moses.compute_metrics(gen, train, n_jobs=2, **kw) == serial


def test_worker_pool_maps_in_order_and_closes():
    items = list(range(1200))
    with moses.WorkerPool(2, chunksize=100) as pool:
        out = pool.map(moses._canon_worker, ["C" * (1 + i % 5)
                                             for i in items])
        assert pool._pool is not None
    assert pool._pool is None
    assert out == [moses.canonicalize("C" * (1 + i % 5)) for i in items]
