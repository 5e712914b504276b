"""Seeded synthetic inputs: random graphs for checks and timings, and
random SMILES for datasets made with nothing downloaded.

:func:`synthetic_graphs`: a chain backbone plus ring closures, degree
capped at 4 (organic valence), formal charge 0, over the config's
dimensions -- the shape of the JAX package's
``tools/roofline.py:synthetic_batch``.

:func:`synthesize_smiles` (counterpart of the JAX package's
``tools/synthesize_smiles.py``): random atom-typed trees over C, N, O, S
and Cl grown under the valence model (chem/molecule.py), plus random ring
closures and, optionally, fused kekule benzene/pyridine rings, sanitized
and canonicalized with the port's own chemistry.  Up to 13 heavy atoms
fits the GDB-13 configuration.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from graphinvent_tpu_torch.chem import (
    Atom, Molecule, mol_from_smiles, mol_to_smiles,
)
from graphinvent_tpu_torch.chem.molecule import allowed_valences


def synthetic_graphs(cfg, batch_size: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """-> nodes (B, N, Fn) and edges (B, N, N, E), float32 0/1."""
    rng = np.random.default_rng(seed)
    N, Fn = cfg.dim_nodes
    E = cfg.n_edge_features
    nodes = np.zeros((batch_size, N, Fn), np.float32)
    edges = np.zeros((batch_size, N, N, E), np.float32)
    n_atoms = rng.integers(max(2, N // 2), N + 1, size=batch_size)
    for b in range(batch_size):
        n = int(n_atoms[b])
        nodes[b, np.arange(n), rng.integers(0, cfg.n_atom_types, size=n)] = 1
        nodes[b, :n, cfg.n_atom_types + 1] = 1          # formal charge 0
        t = rng.integers(0, E, size=n - 1)
        idx = np.arange(n - 1)
        edges[b, idx, idx + 1, t] = 1
        edges[b, idx + 1, idx, t] = 1
        deg = np.zeros(n, np.int64)
        deg[:-1] += 1
        deg[1:] += 1
        for _ in range(int(rng.integers(0, max(2, n // 4)))):
            i, j = sorted(rng.choice(n, 2, replace=False).tolist())
            if j > i + 1 and deg[i] < 4 and deg[j] < 4 \
                    and edges[b, i, j].sum() == 0:
                edges[b, i, j, 0] = edges[b, j, i, 0] = 1
                deg[i] += 1
                deg[j] += 1
    return nodes, edges


# --------------------------------------------------------------------------
# SMILES
# --------------------------------------------------------------------------

# element draw weights: roughly organic/drug-like composition
ELEMENTS = ["C", "N", "O", "S", "Cl"]
WEIGHTS = [0.72, 0.11, 0.11, 0.04, 0.02]
BOND_ORDERS = [1, 2, 3]
BOND_WEIGHTS = [0.86, 0.12, 0.02]


def _free_valence(mol: Molecule, i: int) -> float:
    a = mol.atoms[i]
    vals = allowed_valences(a.element, a.charge)
    if not vals:
        return 0.0
    return max(vals) - mol.explicit_valence(i)


def _graph_distance(mol: Molecule, a: int, b: int, cap: int = 6) -> int:
    """BFS distance up to ``cap`` (ring-closure filter)."""
    if a == b:
        return 0
    frontier, dist, seen = [a], 0, {a}
    while frontier and dist < cap:
        dist += 1
        nxt = []
        for u in frontier:
            for v in mol.neighbors(u):
                if v == b:
                    return dist
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return cap


def _attach_benzene(mol: Molecule, rng: np.random.Generator,
                    anchor: int) -> None:
    """Fuses a kekulé 6-ring (benzene, or pyridine 20% of the time) to
    ``anchor`` via a single bond; aromaticity is perceived at write time."""
    ring = []
    for k in range(6):
        el = "N" if (k == 1 and rng.random() < 0.2) else "C"
        ring.append(mol.add_atom(Atom(el)))
    # kekulé: alternate double (type 1) / single (type 0) around the cycle
    for k in range(6):
        mol.add_bond(ring[k], ring[(k + 1) % 6], 1 if k % 2 == 0 else 0)
    mol.add_bond(anchor, ring[0], 0)


def random_molecule(rng: np.random.Generator, n_target: int,
                    aromatic: bool = False) -> Molecule:
    mol = Molecule()
    first = rng.choice(len(ELEMENTS), p=WEIGHTS)
    mol.add_atom(Atom(ELEMENTS[int(first)]))
    while mol.n_atoms < n_target:
        # fused aromatic ring (costs 6 atoms) ~15% of growth steps
        if aromatic and mol.n_atoms + 6 <= n_target and rng.random() < 0.15:
            anchors = [i for i in range(mol.n_atoms)
                       if _free_valence(mol, i) >= 1
                       and not mol.atoms[i].aromatic]
            if anchors:
                _attach_benzene(mol, rng,
                                int(anchors[rng.integers(len(anchors))]))
                continue
        anchors = [i for i in range(mol.n_atoms) if _free_valence(mol, i) >= 1]
        if not anchors:
            break
        anchor = int(anchors[rng.integers(len(anchors))])
        el = ELEMENTS[int(rng.choice(len(ELEMENTS), p=WEIGHTS))]
        charge = 0
        if rng.random() < 0.015 and el in ("N", "O"):
            charge = 1 if el == "N" else -1
        order = int(rng.choice(BOND_ORDERS, p=BOND_WEIGHTS))
        max_new = max(allowed_valences(el, charge) or (1,))
        order = min(order, int(_free_valence(mol, anchor)), max_new)
        if el == "Cl":
            order = 1
        if order < 1:
            continue
        j = mol.add_atom(Atom(el, charge=charge))
        mol.add_bond(anchor, j, order - 1)     # bond type index = order - 1
    # random ring closures between distant atoms with spare valence
    for _ in range(int(rng.integers(0, max(2, mol.n_atoms // 10)))):
        cands = [i for i in range(mol.n_atoms) if _free_valence(mol, i) >= 1]
        if len(cands) < 2:
            break
        a, b = rng.choice(len(cands), 2, replace=False)
        a, b = int(cands[a]), int(cands[b])
        if mol.bond_type(a, b) is None and _graph_distance(mol, a, b) >= 3:
            mol.add_bond(a, b, 0)
    return mol


def synthesize_smiles(n: int, min_atoms: int, max_atoms: int, seed: int = 0,
                      aromatic: bool = False) -> List[str]:
    """``n`` unique canonical SMILES of ``min_atoms``..``max_atoms`` heavy
    atoms, the same from the same seed; fewer if 50 attempts a molecule do
    not find them."""
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    attempts = 0
    while len(out) < n and attempts < 50 * n:
        attempts += 1
        n_target = int(rng.integers(min_atoms, max_atoms + 1))
        mol = random_molecule(rng, n_target, aromatic=aromatic)
        if not (min_atoms <= mol.n_atoms <= max_atoms):
            continue
        try:
            mol.sanitize()
        except Exception:
            continue
        smi = mol_to_smiles(mol)
        if smi is None or smi in seen:
            continue
        # round-trip guarantee: the emitted SMILES must parse + sanitize in
        # BOTH preprocessing modes (kekulized and aromatic-bond)
        try:
            mol_from_smiles(smi, kekulize_mol=True)
            mol_from_smiles(smi, kekulize_mol=False)
        except Exception:
            continue
        seen.add(smi)
        out.append(smi)
    return out
