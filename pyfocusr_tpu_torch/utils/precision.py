"""Full-f32 matmul precision for the port.

Counterpart of ``pyfocusr_tpu/utils/precision.py:20`` (``f32_matmuls``).
The JAX package traces every entry point at ``Precision.HIGHEST`` because
reduced-precision matmuls broke the distance identities and the eigensolver
(``pyfocusr_tpu/ops/knn.py:34-39``, ``pyfocusr_tpu/ops/eigen.py:16-19``).
On the H100 the equivalent hazard is TF32, which keeps ~3 decimal digits:
this module turns it off explicitly for matmuls and cuDNN and asks for
"highest" float32 matmul precision, for the duration of a decorated call.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["f32_matmuls", "full_f32"]


@contextlib.contextmanager
def full_f32():
    """Run the block with TF32 off and float32 matmul precision "highest";
    restores the caller's settings afterwards."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def f32_matmuls(fn):
    """Decorator: run ``fn`` under :func:`full_f32`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapper
