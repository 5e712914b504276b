"""MOSES-style distribution-learning metrics, computed locally.

Counterpart of ``graphinvent_tpu/eval/moses.py``: the same metric dict from
:func:`compute_metrics`, on the port's own copies of ``chem/smiles``,
``chem/descriptors`` and ``chem/fingerprint``.  The reference's acceptance
flow is "train on MOSES, generate 30k, score with the MOSES metric suite"
(reference: tutorials/5_benchmarking_with_moses.md:1-6); the external
``molsets/moses`` package needs RDKit and a ChemNet download (FCD), so the
computable subset is re-implemented on the in-repo chemistry:

* **validity**: fraction of generated SMILES that parse and sanitize; the
  ``[Xx]`` rows written for invalid graphs count as invalid;
* **uniqueness@k**: unique fraction among the first k valid molecules, and
  uniqueness over the whole valid set;
* **novelty**: fraction of unique valid molecules whose canonical SMILES is
  not in the training set (both sides canonicalized by one writer);
* **IntDiv_p**: 1 - (mean pairwise Tanimoto^p)^(1/p) over Morgan
  fingerprints, diagonal included, as ``moses.metrics.internal_diversity``
  computes it.  The Gram matrix of intersection counts is a torch product
  in row blocks on ``device`` (the card unless the caller asks for the
  CPU), taken in float32 with a float32 output: on 0/1 inputs every count
  (up to the 2,048 bits) is then an exact integer, TF32 or not;
* **scaffold uniqueness / novelty**: Bemis-Murcko frameworks by graph
  pruning (RDKit ``GetScaffoldForMol`` convention);
* **pass_filters**: fraction of valid molecules with zero structural
  alerts (the QED alert list);
* **property W1**: Wasserstein-1 between generated and reference (test
  split) marginals of MW / ALogP / QED / TPSA on matched quantile grids.

Everything is deterministic given ``seed``.  The host passes run in worker
processes when ``n_jobs`` > 1.  The JAX package forks them; a fork after
CUDA or a library's threads exist can deadlock the children, so the port's
pools start from a ``forkserver``: a fresh single-threaded server process,
with this module preloaded, forks every worker.  ``pool.map`` keeps the
input order, so the results are those of the serial path.  As with
``spawn``, each worker imports the caller's main module, so a script that
calls :func:`compute_metrics` with ``n_jobs`` > 1 keeps its work under
``if __name__ == "__main__":``.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from graphinvent_tpu_torch.chem.molecule import Atom, Molecule
from graphinvent_tpu_torch.chem.smiles import mol_from_smiles, mol_to_smiles


# ==========================================================================
# SMILES IO + canonicalization
# ==========================================================================

def read_smi(path: str) -> List[str]:
    """Reads a .smi file (optional ``SMILES`` header line) with the
    preprocessing layer's reader."""
    from graphinvent_tpu_torch.data.preprocess import read_smiles_file
    return read_smiles_file(path)


def canonicalize(smiles: str) -> Optional[str]:
    """Parse + canonical rewrite; None when the string is not a valid
    molecule."""
    if not smiles or smiles == "[Xx]":
        return None
    try:
        mol = mol_from_smiles(smiles)
    except Exception:
        return None
    return mol_to_smiles(mol)


def _canon_worker(smiles: str) -> Optional[str]:
    return canonicalize(smiles)


class WorkerPool:
    """A process pool opened at its first map of more than ``4 *
    chunksize`` items and kept for the rest of a :func:`compute_metrics`
    call (one start-up per call, not one per pass); smaller inputs, and
    ``n_jobs`` <= 1, run serially.  Workers come from a ``forkserver``,
    which is safe after CUDA or other threads exist in this process."""

    def __init__(self, n_jobs: int, chunksize: int = 256) -> None:
        self.n_jobs = n_jobs
        self.chunksize = chunksize
        self._pool = None

    def map(self, worker, items: Sequence) -> list:
        if not (self.n_jobs and self.n_jobs > 1
                and len(items) > 4 * self.chunksize):
            return [worker(s) for s in items]
        if self._pool is None:
            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            self._pool = ctx.Pool(self.n_jobs)
        return self._pool.map(worker, items, chunksize=self.chunksize)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ==========================================================================
# Bemis-Murcko scaffolds
# ==========================================================================

def murcko_scaffold(mol: Molecule) -> str:
    """Bemis-Murcko framework: ring atoms + linker atoms, plus atoms
    double/triple-bonded directly to that framework (RDKit
    ``MurckoScaffold.GetScaffoldForMol`` convention).  Returns the
    scaffold's canonical SMILES, or "" for acyclic molecules.

    The re-attach pass tests ``j in keep`` while ``keep`` grows, as the JAX
    package's does, so on a cumulated chain off the framework (C=C=C) the
    result depends on atom order; RDKit keeps only the first atom.  Kept
    equal to the JAX package on purpose (ROADMAP C)."""
    rings = mol.rings()
    if not rings:
        return ""
    ring_atoms = set().union(*map(set, rings))
    adj = {i: set(mol.neighbors(i)) for i in range(mol.n_atoms)}
    keep = set(range(mol.n_atoms))
    # prune terminal non-ring atoms to a fixed point: what survives is
    # exactly rings + ring-ring linker paths
    changed = True
    while changed:
        changed = False
        for i in list(keep):
            if i not in ring_atoms and len(adj[i] & keep) <= 1:
                keep.discard(i)
                changed = True
    # re-attach atoms multiple-bonded directly to the framework (=O on a
    # ring carbonyl, exocyclic =N-, etc.): bond types 1 (double), 2
    # (triple) in config.BOND_TYPES order
    for i in range(mol.n_atoms):
        if i in keep:
            continue
        for j in adj[i]:
            if j in keep and mol.bond_type(i, j) in (1, 2):
                keep.add(i)
                break
    sub = Molecule()
    remap: Dict[int, int] = {}
    for i in sorted(keep):
        a = mol.atoms[i]
        # an atom that lost substituents re-derives its implicit-H count
        # from the valence model; untouched atoms keep any explicit
        # override (pyrrole [nH] etc.)
        full_degree = len(adj[i]) == len(adj[i] & keep)
        remap[i] = sub.add_atom(Atom(a.element, a.charge,
                                     a.n_implicit_h if full_degree else None,
                                     "None", a.aromatic, a.isotope))
    for (a, b), t in mol.bonds.items():
        if a in keep and b in keep:
            sub.add_bond(remap[a], remap[b], t)
    return mol_to_smiles(sub) or ""


def _scaffold_worker(smiles: Optional[str]) -> Optional[str]:
    if smiles is None:
        return None
    try:
        return murcko_scaffold(mol_from_smiles(smiles))
    except Exception:
        return None


# ==========================================================================
# Internal diversity (Morgan-Tanimoto Gram matrix, row blocks in torch)
# ==========================================================================

def intersection_counts(f, start: int, stop: int):
    """|fp_i & fp_j| for rows ``start:stop`` of ``f`` (a float32 0/1
    tensor) against every row: a float32 product with a float32 output,
    so every count is an exact integer (the sums stay far below 2^24)."""
    return f[start:stop] @ f.T


def internal_diversity_both(fps: np.ndarray, block: int = 2048,
                            device: str = "cuda") -> Tuple[float, float]:
    """(IntDiv_1, IntDiv_2) in one pass over the Tanimoto Gram matrix,
    diagonal included (the MOSES average); ``fps`` is (n, bits) of {0,1}.
    Rows go in blocks of ``block`` (a block holds block x n float32
    counts: at n = 30,000 and 2,048 rows, 246 MB), each block's Tanimoto
    sums accumulate in float64."""
    import torch
    from graphinvent_tpu_torch.utils.device import resolve_device

    n = int(fps.shape[0])
    if n == 0:
        return 0.0, 0.0
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(fps, np.float32), device=dev)
    counts = f.sum(dim=1)
    tot1 = torch.zeros((), dtype=torch.float64, device=dev)
    tot2 = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, n, block):
        inter = intersection_counts(f, s, s + block)
        union = counts[s:s + block, None] + counts[None, :] - inter
        t = torch.where(union > 0, inter / union, torch.zeros_like(inter))
        tot1 += t.sum(dtype=torch.float64)
        tot2 += (t * t).sum(dtype=torch.float64)
    tot1, tot2 = float(tot1), float(tot2)
    return (float(1.0 - tot1 / (n * n)),
            float(1.0 - (tot2 / (n * n)) ** 0.5))


def internal_diversity(fps: np.ndarray, p: int = 1, block: int = 2048,
                       device: str = "cuda") -> float:
    """Single-p wrapper over :func:`internal_diversity_both` (MOSES
    reports p=1 and p=2; other powers are not supported)."""
    if p not in (1, 2):
        raise ValueError(f"internal_diversity supports p in (1, 2), got {p}")
    return internal_diversity_both(fps, block, device)[p - 1]


# ==========================================================================
# Property marginals
# ==========================================================================

def wasserstein1(a: np.ndarray, b: np.ndarray, n_q: int = 1001) -> float:
    """W1 between two empirical 1-D distributions via matched quantiles."""
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    qs = np.linspace(0.0, 1.0, n_q)
    return float(np.mean(np.abs(np.quantile(a, qs) - np.quantile(b, qs))))


def _props_worker(smiles: str):
    """One parse -> (passes_filters, MW, ALogP, QED, TPSA); None on a
    failed parse."""
    from graphinvent_tpu_torch.chem.descriptors import (
        alogp, mol_weight, qed, structural_alerts, tpsa,
    )
    try:
        mol = mol_from_smiles(smiles)
        return (int(structural_alerts(mol) == 0), mol_weight(mol),
                alogp(mol), qed(mol), tpsa(mol))
    except Exception:
        return None


def _fp_worker(smiles: str):
    """One parse -> bit-packed 2048-bit Morgan fingerprint (256 bytes to
    ship back from a worker); None on a failed parse."""
    from graphinvent_tpu_torch.chem.fingerprint import morgan_fingerprint
    try:
        fp = morgan_fingerprint(mol_from_smiles(smiles))
        return np.packbits(fp.astype(np.uint8)).tobytes()
    except Exception:
        return None


# ==========================================================================
# The full suite
# ==========================================================================

def compute_metrics(gen_smiles: Sequence[str],
                    train_smiles: Sequence[str],
                    test_smiles: Optional[Sequence[str]] = None,
                    n_jobs: int = 0,
                    n_intdiv: int = 10000,
                    n_props: int = 10000,
                    seed: int = 0,
                    device: str = "cuda") -> Dict[str, float]:
    """MOSES-style metric dict for a generated set against its training
    (and optionally held-out test) set.  IntDiv and the property marginals
    run on seeded samples of at most ``n_intdiv`` / ``n_props`` molecules
    (set them >= len(gen) to disable the cap); IntDiv's product runs on
    ``device``."""
    rng = np.random.default_rng(seed)
    with WorkerPool(n_jobs) as pool:
        gen_canon = pool.map(_canon_worker, gen_smiles)
        valid = [c for c in gen_canon if c is not None]
        n_gen = len(gen_canon)
        out: Dict[str, float] = {
            "n_generated": float(n_gen),
            "validity": len(valid) / n_gen if n_gen else 0.0,
        }
        for k in (1000, 10000):
            head = valid[:k]
            out[f"unique@{k}"] = (len(set(head)) / len(head)) if head else 0.0
        uniq = sorted(set(valid))
        out["uniqueness"] = len(uniq) / len(valid) if valid else 0.0

        train_canon = pool.map(_canon_worker, train_smiles)
        train_set = {c for c in train_canon if c is not None}
        out["novelty"] = (sum(1 for c in uniq if c not in train_set)
                          / len(uniq) if uniq else 0.0)
        ref_canon = sorted(train_set)
        if test_smiles is not None:
            test_canon = pool.map(_canon_worker, test_smiles)
            ref_canon = sorted({c for c in test_canon if c is not None})
        if len(ref_canon) > n_props:
            ref_canon = [ref_canon[i] for i in
                         rng.choice(len(ref_canon), n_props, replace=False)]

        # scaffolds: generated-unique scaffold pool vs the training pool
        gen_scafs = [s for s in pool.map(_scaffold_worker, uniq)
                     if s is not None]
        train_scaf_set = {s for s in pool.map(_scaffold_worker,
                                              sorted(train_set))
                          if s is not None}
        scaf_uniq = set(gen_scafs)
        out["scaffold_uniqueness"] = (len(scaf_uniq) / len(gen_scafs)
                                      if gen_scafs else 0.0)
        out["scaffold_novelty"] = (sum(1 for s in scaf_uniq
                                       if s not in train_scaf_set)
                                   / len(scaf_uniq) if scaf_uniq else 0.0)

        # seeded samples; each SMILES is parsed exactly once
        props_sample = list(valid)
        if len(props_sample) > n_props:
            props_sample = [props_sample[i] for i in
                            rng.choice(len(props_sample), n_props,
                                       replace=False)]
        int_sample = list(valid)
        if len(int_sample) > n_intdiv:
            int_sample = [int_sample[i] for i in
                          rng.choice(len(int_sample), n_intdiv,
                                     replace=False)]

        gen_rows = np.array([r for r in pool.map(_props_worker, props_sample)
                             if r is not None])
        ref_rows = np.array([r for r in pool.map(_props_worker, ref_canon)
                             if r is not None])
        fp_bytes = [b for b in pool.map(_fp_worker, int_sample)
                    if b is not None]

    # filters: zero QED structural alerts (column 0 of the property rows)
    out["pass_filters"] = (float(gen_rows[:, 0].mean())
                           if len(gen_rows) else 0.0)

    # property marginals vs the held-out split (train as fallback)
    for col, name in enumerate(("mw", "alogp", "qed", "tpsa"), start=1):
        out[f"w1_{name}"] = wasserstein1(
            gen_rows[:, col] if len(gen_rows) else np.empty(0),
            ref_rows[:, col] if len(ref_rows) else np.empty(0))

    # IntDiv last: one Gram-matrix pass for both power means
    if fp_bytes:
        fps = np.unpackbits(
            np.frombuffer(b"".join(fp_bytes), np.uint8).reshape(
                len(fp_bytes), -1), axis=1).astype(np.float32)
        out["int_div_1"], out["int_div_2"] = internal_diversity_both(
            fps, device=device)
    else:
        out["int_div_1"] = out["int_div_2"] = 0.0
    return out
