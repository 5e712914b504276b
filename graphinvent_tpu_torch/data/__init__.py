"""Datasets on disk: the storage back ends, the block loader and the
SMILES preprocessing pass.  numpy only; no tensor is made here."""

from graphinvent_tpu_torch.data.loader import BlockLoader, HDFDataset

__all__ = ["HDFDataset", "BlockLoader"]
