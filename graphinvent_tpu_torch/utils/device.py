"""Where the port runs (``cfg.device``) and in which type it computes
(``cfg.compute_dtype``)."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (raises when there is none);
    ``"cpu"`` -> the CPU; anything else raises.  Nothing falls back."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but PyTorch sees no CUDA "
                               "device; set device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")


def compute_dtype(cfg) -> torch.dtype:
    """The activations' type: bf16 (weights stay f32 and are cast at use)
    or f32."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
