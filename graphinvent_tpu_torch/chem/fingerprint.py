"""Morgan (ECFP-style) circular fingerprints.

A copy of ``graphinvent_tpu/chem/fingerprint.py`` with the imports
rewritten: bit for bit the same vectors.

Stand-in for ``AllChem.GetMorganFingerprintAsBitVect(mol, 2, nBits=2048)``
used by the RL scoring function (reference: ScoringFunction.py:183-188).
Same construction (circular neighborhood hashing, radius iterations, folding
into a fixed-width bit vector); the hash function differs from RDKit's, so
bit positions are not RDKit-compatible -- QSAR models must be (re)trained on
these fingerprints (the JAX package's ``tools/train_qsar.py`` does so).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Set, Tuple

import numpy as np

from graphinvent_tpu_torch.chem.molecule import ATOMIC_NUM, Molecule


def _hash_tuple(t: Tuple) -> int:
    h = hashlib.blake2b(repr(t).encode(), digest_size=8).digest()
    return struct.unpack("<Q", h)[0]


def morgan_fingerprint(mol: Molecule, radius: int = 2,
                       n_bits: int = 2048) -> np.ndarray:
    """Returns a float {0,1} vector of length ``n_bits``.

    The molecule is normalized to its aromatic-perceived form first, so a
    kekulized parse and an aromatic-mode generated graph of the SAME
    molecule hash identically.  Without this, a QSAR model trained on
    kekulized SMILES scored aromatic-mode generated molecules near 0
    (a representation mismatch: actives 0.998, generated 0.015, where
    scoring the same molecules' SMILES gave 0.475)."""
    from graphinvent_tpu_torch.chem.descriptors import _ensure_aromatic
    mol = _ensure_aromatic(mol)
    n = mol.n_atoms
    in_ring = [False] * n
    for ring in mol.rings():
        for i in ring:
            in_ring[i] = True

    # initial invariants (Daylight-style)
    inv = []
    for i, atom in enumerate(mol.atoms):
        inv.append(_hash_tuple((
            ATOMIC_NUM.get(atom.element, 0),
            mol.degree(i),
            mol.implicit_h(i),
            atom.charge,
            int(in_ring[i]),
            int(atom.aromatic),
        )))

    nbrs = [[(mol.bond_type(i, j), j) for j in mol.neighbors(i)]
            for i in range(n)]
    bits: Set[int] = set(inv)
    current = list(inv)
    for _ in range(radius):
        nxt = []
        for i in range(n):
            neigh = sorted((bt, current[j]) for bt, j in nbrs[i])
            nxt.append(_hash_tuple((current[i], tuple(neigh))))
        bits.update(nxt)
        current = nxt

    fp = np.zeros(n_bits, dtype=np.float64)
    for b in bits:
        fp[b % n_bits] = 1.0
    return fp


def bulk_fingerprints(mols: List[Molecule], radius: int = 2,
                      n_bits: int = 2048) -> np.ndarray:
    out = np.zeros((len(mols), n_bits))
    for k, m in enumerate(mols):
        if m is not None and m.n_atoms:
            out[k] = morgan_fingerprint(m, radius, n_bits)
    return out


def tanimoto(a: np.ndarray, b: np.ndarray) -> float:
    inter = float(np.minimum(a, b).sum())
    union = float(np.maximum(a, b).sum())
    return inter / union if union else 0.0
