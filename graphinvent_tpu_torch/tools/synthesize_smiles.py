"""Synthesizes random drug-like SMILES: a ChEMBL / MOSES proxy made with
nothing downloaded.

Counterpart of the JAX package's ``tools/synthesize_smiles.py``, a CLI
over ``utils/synthetic.synthesize_smiles`` (the same molecules from the
same seed): random atom-typed trees over C, N, O, S and Cl grown under the
valence model, random ring closures and, with ``--aromatic``, fused
kekule benzene / pyridine rings.  The reference builds its large datasets
by downloading ChEMBL / MOSES / ZINC (tools/tdc-create-dataset.py:34-60).

    python -m graphinvent_tpu_torch.tools.synthesize_smiles out.smi \\
        --n 5000 --min-atoms 25 --max-atoms 40 [--aromatic] [--seed 0]

The last line printed is one JSON object: the file and its molecules.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from graphinvent_tpu_torch.utils.synthetic import synthesize_smiles


def write_smi(path: str, smiles: Sequence[str]) -> None:
    """A ``.smi`` file with the ``SMILES`` header line."""
    with open(path, "w") as fh:
        fh.write("SMILES\n")
        for s in smiles:
            fh.write(s + "\n")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--min-atoms", type=int, default=25)
    ap.add_argument("--max-atoms", type=int, default=40)
    ap.add_argument("--aromatic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smiles = synthesize_smiles(args.n, args.min_atoms, args.max_atoms,
                               seed=args.seed, aromatic=args.aromatic)
    write_smi(args.output, smiles)
    print(f"wrote {len(smiles)} unique molecules to {args.output}")
    result = {"output": args.output, "n": len(smiles)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
