"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` where no card is visible raises (nothing falls back to the
CPU).  On a CUDA device the reference and plain paths keep full f32
products: TF32 and reduced-precision bf16 reductions are switched off,
so a "bf16 pass" accumulates in f32 as the kernels do.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev
