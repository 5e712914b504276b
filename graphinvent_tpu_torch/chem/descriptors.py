"""Molecular descriptors + QED drug-likeness score.

A copy of ``graphinvent_tpu/chem/descriptors.py`` with the imports
rewritten: the same floats.

Stand-in for ``rdkit.Chem.QED`` used by the RL scoring function
(reference: ScoringFunction.py:131-143).  The QED formula and its published
asymmetric-double-sigmoid (ADS) desirability parameters are from Bickerton
et al., Nat. Chem. 2012 (same source RDKit implements).  Descriptors:

  MW    exact (monoisotopic-ish average masses)
  ALOGP simplified Wildman-Crippen-style atomic contributions (approximate:
        contributions keyed on element/aromaticity/heteroatom neighborhood
        rather than the full SMARTS type system)
  HBA   N + O count, excluding amide N and pyrrole-type NH
  HBD   sum of H on N/O
  PSA   Ertl TPSA contributions for N/O (main published table entries)
  ROTB  non-ring single bonds between heavy atoms of degree >= 2,
        excluding amide C-N
  AROM  number of aromatic rings
  ALERT structural alerts: a reduced set of the Brenk alerts implemented as
        graph patterns (nitro, azide, aldehyde, thiol, acyl halide, ...)

Values track RDKit's QED closely enough for RL reward shaping; exact RDKit
parity is impossible without the full SMARTS stack and is documented as a
deviation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from graphinvent_tpu_torch.chem.molecule import ATOMIC_MASS, Molecule
from graphinvent_tpu_torch.chem.smiles import perceive_aromaticity

# QED ADS parameters (Bickerton et al. 2012, Table S5; order:
# a, b, c, d, e, f, dmax) for MW, ALOGP, HBA, HBD, PSA, ROTB, AROM, ALERTS
_ADS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001,
            0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000000, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001,
             1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000000, 1199.094025, -0.09002593, 0.000000001,
               0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {  # "mean" weights (QED.default == weights_mean)
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61, "PSA": 0.06,
    "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p: Tuple[float, ...]) -> float:
    a, b, c, d, e, f, dmax = p
    val = a + b / (1 + math.exp(-(x - c + d / 2) / e)) \
        * (1 - 1 / (1 + math.exp(-(x - c - d / 2) / f)))
    return val / dmax


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------

def _ensure_aromatic(mol: Molecule) -> Molecule:
    if any(a.aromatic for a in mol.atoms):
        return mol
    work = mol.copy()
    try:
        perceive_aromaticity(work)
    except Exception:
        pass
    return work


def mol_weight(mol: Molecule) -> float:
    return mol.molecular_weight()


def _is_amide_n(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].element != "N":
        return False
    for j in mol.neighbors(i):
        if mol.atoms[j].element == "C":
            for k in mol.neighbors(j):
                if k != i and mol.atoms[k].element == "O" \
                        and mol.bond_type(j, k) == 1:
                    return True
    return False


def hba(mol: Molecule) -> int:
    count = 0
    for i, atom in enumerate(mol.atoms):
        if atom.element == "O":
            count += 1
        elif atom.element == "N":
            if atom.aromatic and mol.implicit_h(i) > 0:
                continue      # pyrrole-type NH: donor, not acceptor
            if _is_amide_n(mol, i):
                continue
            count += 1
    return count


def hbd(mol: Molecule) -> int:
    return sum(mol.implicit_h(i) for i, a in enumerate(mol.atoms)
               if a.element in ("N", "O"))


def rotatable_bonds(mol: Molecule) -> int:
    ring_bonds = set()
    for ring in mol.rings():
        for k in range(len(ring)):
            a, b = ring[k], ring[(k + 1) % len(ring)]
            ring_bonds.add((a, b) if a < b else (b, a))
    count = 0
    for (a, b), t in mol.bonds.items():
        if t != 0 or (a, b) in ring_bonds:
            continue
        if mol.degree(a) < 2 or mol.degree(b) < 2:
            continue
        # exclude amide C-N
        def _amide(c, n):
            return (mol.atoms[c].element == "C" and mol.atoms[n].element == "N"
                    and any(mol.atoms[k].element == "O"
                            and mol.bond_type(c, k) == 1
                            for k in mol.neighbors(c)))
        if _amide(a, b) or _amide(b, a):
            continue
        count += 1
    return count


def aromatic_rings(mol: Molecule) -> int:
    mol = _ensure_aromatic(mol)
    n = 0
    for ring in mol.rings():
        if all(mol.atoms[i].aromatic for i in ring):
            n += 1
    return n


def tpsa(mol: Molecule) -> float:
    """Ertl topological PSA, core N/O contribution table."""
    mol = _ensure_aromatic(mol)
    total = 0.0
    for i, atom in enumerate(mol.atoms):
        el, q = atom.element, atom.charge
        if el not in ("N", "O", "S", "P"):
            continue
        n_h = mol.implicit_h(i)
        deg = mol.degree(i)
        arom = atom.aromatic
        bonds = sorted(mol.bond_type(i, j) for j in mol.neighbors(i))
        n_single = sum(1 for b in bonds if b in (0, 3))
        n_double = sum(1 for b in bonds if b == 1)
        n_triple = sum(1 for b in bonds if b == 2)
        if el == "N" and q == 0:
            if arom:
                if n_h == 0 and deg == 2:
                    total += 12.89
                elif n_h == 1:
                    total += 15.79
                elif deg == 3:
                    total += 4.93    # [n](:*)(:*)-*
                else:
                    total += 12.89
            elif n_triple == 1 and deg == 1:
                total += 23.79       # N#
            elif n_double == 1 and deg == 2 and n_h == 0:
                total += 12.36       # =N-
            elif n_double == 1 and n_h == 0:
                total += 11.68
            elif n_h == 0 and deg == 3:
                total += 3.24        # N(-*)(-*)-*
            elif n_h == 1 and deg == 2:
                total += 12.03       # NH(-*)-*
            elif n_h == 2 and deg == 1:
                total += 26.02       # NH2-*
            elif n_h == 1 and n_double == 1:
                total += 23.85
            else:
                total += 12.03
        elif el == "N" and q == 1:
            if n_h == 0:
                total += 0.0 if deg == 4 else 3.01
            elif n_h == 1:
                total += 4.44
            elif n_h == 2:
                total += 16.61
            elif n_h == 3:
                total += 27.64
        elif el == "O" and q == 0:
            if arom:
                total += 13.14
            elif n_double == 1 and deg == 1:
                total += 17.07       # O=
            elif n_h == 1:
                total += 20.23       # OH-*
            elif deg == 2:
                total += 9.23        # O(-*)-*
            else:
                total += 9.23
        elif el == "O" and q == -1:
            total += 23.06
        elif el == "S" and q == 0:
            if arom:
                total += 28.24 if deg == 2 else 21.70
            elif n_double == 1 and deg == 1:
                total += 32.09
            elif n_h == 1:
                total += 38.80
            else:
                total += 25.30 if deg == 2 else 19.21
        # P contributions omitted (rare in the target chemistries)
    return total


# simplified Wildman-Crippen-flavoured logP atomic contributions
_LOGP_C = {"aromatic": 0.294, "aliphatic": 0.142}


def alogp(mol: Molecule) -> float:
    mol = _ensure_aromatic(mol)
    total = 0.0
    for i, atom in enumerate(mol.atoms):
        el = atom.element
        n_h = mol.implicit_h(i)
        hetero_nbr = any(mol.atoms[j].element not in ("C", "H")
                        for j in mol.neighbors(i))
        if el == "C":
            if atom.aromatic:
                total += 0.294 if not hetero_nbr else 0.137
            else:
                total += 0.142 if not hetero_nbr else -0.027
            total += 0.123 * n_h
        elif el == "N":
            total += -0.60 if not atom.aromatic else -0.49
            total += -0.25 * n_h
        elif el == "O":
            total += -0.45 if not atom.aromatic else -0.04
            total += -0.32 * n_h
        elif el == "S":
            total += 0.65
        elif el == "F":
            total += 0.43
        elif el == "Cl":
            total += 0.76
        elif el == "Br":
            total += 0.89
        elif el == "I":
            total += 1.05
        elif el == "P":
            total += 0.27
    return total


# --------------------------------------------------------------------------
# structural alerts (reduced Brenk-style set as graph patterns)
# --------------------------------------------------------------------------

def structural_alerts(mol: Molecule) -> int:
    alerts = 0
    for i, atom in enumerate(mol.atoms):
        el = atom.element
        nbrs = mol.neighbors(i)
        # nitro: N(+) with =O and -O(-) / or N with two O neighbors via double
        if el == "N":
            n_o = sum(1 for j in nbrs if mol.atoms[j].element == "O")
            if n_o >= 2 and any(mol.bond_type(i, j) == 1 for j in nbrs
                                if mol.atoms[j].element == "O"):
                alerts += 1
        # aldehyde: C(=O)H with exactly one heavy neighbor besides O
        if el == "C" and mol.implicit_h(i) >= 1:
            if any(mol.atoms[j].element == "O" and mol.bond_type(i, j) == 1
                   for j in nbrs):
                alerts += 1
        # thiol: S-H
        if el == "S" and mol.implicit_h(i) >= 1:
            alerts += 1
        # acyl halide: C(=O)-X
        if el == "C":
            has_dbl_o = any(mol.atoms[j].element == "O"
                            and mol.bond_type(i, j) == 1 for j in nbrs)
            has_hal = any(mol.atoms[j].element in ("F", "Cl", "Br", "I")
                          for j in nbrs)
            if has_dbl_o and has_hal:
                alerts += 1
        # azide / diazo: N=N
        if el == "N" and any(mol.atoms[j].element == "N"
                             and mol.bond_type(i, j) in (1, 2) for j in nbrs):
            alerts += 1
    # long aliphatic chains (>= 7 consecutive non-ring carbons)
    ring_atoms = {a for ring in mol.rings() for a in ring}
    chain = 0
    for i, atom in enumerate(mol.atoms):
        if atom.element == "C" and i not in ring_atoms:
            chain = max(chain, _longest_chain(mol, i, ring_atoms))
    if chain >= 7:
        alerts += 1
    return alerts


def _longest_chain(mol: Molecule, start: int, ring_atoms: set,
                   _depth: int = 0) -> int:
    if _depth > 12:
        return 0
    best = 1
    for j in mol.neighbors(start):
        if j not in ring_atoms and mol.atoms[j].element == "C" and j > start:
            best = max(best, 1 + _longest_chain(mol, j, ring_atoms, _depth + 1))
    return best


# --------------------------------------------------------------------------
# QED
# --------------------------------------------------------------------------

def qed_properties(mol: Molecule) -> Dict[str, float]:
    return {
        "MW": mol_weight(mol),
        "ALOGP": alogp(mol),
        "HBA": hba(mol),
        "HBD": hbd(mol),
        "PSA": tpsa(mol),
        "ROTB": rotatable_bonds(mol),
        "AROM": aromatic_rings(mol),
        "ALERTS": structural_alerts(mol),
    }


def qed(mol: Optional[Molecule]) -> float:
    """Weighted QED (Bickerton eq. 2, 'mean' weights)."""
    if mol is None or mol.n_atoms == 0:
        return 0.0
    try:
        props = qed_properties(mol)
        t, wsum = 0.0, 0.0
        for name, w in _QED_WEIGHTS.items():
            d = max(_ads(props[name], _ADS[name]), 1e-10)
            t += w * math.log(d)
            wsum += w
        return math.exp(t / wsum)
    except Exception:
        return 0.0
