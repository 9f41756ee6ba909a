"""The check that a run loaded nothing of JAX or of the JAX package.

Module names are compared by their top-level name (the part before the
first dot), whole: ``pyfocusr_tpu_torch`` is not ``pyfocusr_tpu``."""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "pyfocusr_tpu", "pyfocusr")


def forbidden_loaded(module_names) -> list:
    """The forbidden top-level names among ``module_names``, sorted."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops.intersection(FORBIDDEN))
