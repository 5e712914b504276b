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


# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit:
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores, HBM3
# bytes/s.  chip_smoke.py and tools/roofline.py take their bounds from here.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` prints
    them (a card set below 700 W runs slower than the peaks above)."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]
