"""Device selection for the port's entry points.

The port runs on `cuda` by default; the CPU is used only when the caller
asks for it (`device="cpu"`, CLI `--device cpu`), which is what the CPU
tests do. Without CUDA and without that request the entry points raise
instead of silently running somewhere else.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch.device to run on; raises when CUDA is asked for (the
    default) but not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]
