"""Device and dtype selection for the port.

Full float32 everywhere on the card: TF32 is switched off for matmuls and
convolutions at import, because pixel-coordinate products and damped-then-
inverted Gram blocks need the full mantissa (the reference learned this on
the TPU's bf16 default, CLAUDE.md "numeric traps").  The working dtype is
float32 on the card; the CPU parity tests pass float64 explicitly.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def default_device() -> torch.device:
    """``cuda`` when a card is present, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA where there is
    none raises: the port never falls back to the CPU silently."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False")
    return device


def resolve_dtype(dtype=None) -> torch.dtype:
    """torch dtype from None (float32), a torch dtype, a numpy dtype or a
    config string."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return _DTYPES[dtype]
    import numpy as np

    return _DTYPES[np.dtype(dtype).name]
