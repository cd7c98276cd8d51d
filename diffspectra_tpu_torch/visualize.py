"""Molecule files of the train snapshot (port of the xyz half of
``diffspectra_tpu/visualize.py``): ``mol_<i>.xyz`` for each of the first
``max_mols`` molecules that has positions. The grid image needs RDKit,
which the port does not use, and is left out."""

from __future__ import annotations

import os
from typing import Sequence

from .evaluation.molgraph import MolGraph


def write_xyz(path: str, syms, positions) -> None:
    """An xyz file: the atom count, an empty comment line, then one
    ``<symbol> x y z`` line an atom, six decimals."""
    with open(path, "w") as f:
        f.write(f"{len(syms)}\n\n")
        for s, p in zip(syms, positions):
            f.write(f"{s} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def visualize_mols(mols: Sequence, save_dir: str, max_mols: int = 16) -> int:
    """Write ``<save_dir>/mol_<i>.xyz`` for the first ``max_mols``
    molecules that are not None (``i`` their rank among those), each a
    ``MolGraph`` with positions; returns the number of files written."""
    os.makedirs(save_dir, exist_ok=True)
    written = 0
    for i, mol in enumerate([m for m in mols if m is not None][:max_mols]):
        if isinstance(mol, MolGraph) and mol.positions is not None:
            write_xyz(os.path.join(save_dir, f"mol_{i}.xyz"), mol.atom_syms, mol.positions)
            written += 1
    return written
