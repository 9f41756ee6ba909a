"""The top-level-name check of the modules a run loaded."""

import pytest

from harness.imports import forbidden_loaded


@pytest.mark.parametrize("name", ["pyfocusr_tpu_torch", "pyfocusr_tpu_torch.ops.knn",
                                  "pyfocusr_torch", "jaxtyping", "numpy", "torch.jit"])
def test_allowed(name):
    assert forbidden_loaded([name]) == []


@pytest.mark.parametrize("name,top", [("pyfocusr_tpu", "pyfocusr_tpu"),
                                      ("pyfocusr_tpu.ops.knn", "pyfocusr_tpu"),
                                      ("pyfocusr", "pyfocusr"),
                                      ("pyfocusr.graph", "pyfocusr"),
                                      ("jax", "jax"), ("jax.numpy", "jax"),
                                      ("jaxlib.xla_client", "jaxlib"), ("flax.linen", "flax")])
def test_forbidden(name, top):
    assert forbidden_loaded(["numpy", name, "torch"]) == [top]
