"""Where the port's entry points build their tensors.

No counterpart in ``pyfocusr_tpu`` (JAX places arrays on its default
backend).  The port runs on the CUDA card unless the caller asks for the
CPU; nothing chooses between the two silently.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_f32", "resolve_device", "to_numpy"]


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the CUDA card when ``device`` is
    None (raising when there is none), else exactly the device asked for.
    The CPU is taken only when the caller names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present: pyfocusr_tpu_torch builds on the card "
            "by default; pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")


def as_f32(values, device) -> torch.Tensor:
    """Numpy or a tensor (on any device) as an f32 tensor on ``device``."""
    if torch.is_tensor(values):
        return values.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


def to_numpy(values, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=dtype)
