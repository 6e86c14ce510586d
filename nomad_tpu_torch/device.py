"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back to
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False (pass device='cpu' to run "
            "the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"nomad_tpu_torch: unsupported device {dev}")
    return dev


def default_dtype_name(device: DeviceLike = None,
                       dtype_name: Optional[str] = None) -> str:
    """The reference's dtype rule (solver/service.py TpuPlacementService):
    float64 on the CPU, float32 on the accelerator, unless named."""
    if dtype_name is not None:
        if dtype_name not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype_name {dtype_name!r}")
        return dtype_name
    return "float64" if resolve_device(device).type == "cpu" else "float32"
