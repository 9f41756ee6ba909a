"""The roofline counts against hand-worked shapes."""

import pytest

from roofline import knn, peaks

P = peaks()


def test_peaks_are_the_h100_sxm_data_sheet():
    assert P["hbm_bytes_per_s"] == 3.35e12
    assert P["f32_flops_per_s"] == 67e12
    assert P["f32_lane_instructions_per_s"] == pytest.approx(132 * 128 * 1.98e9)


def test_knn_bound_at_10242_squared_is_operation_bound():
    # 10242^2 pairs x 9 instructions / 3.3454e13 a second = 28.22 us
    assert knn.bound_s(10242, 10242, 3, 1) == pytest.approx(10242 * 10242 * 9 / 3.345408e13)
    assert knn.bound_s(10242, 10242, 3, 1) == pytest.approx(28.22e-6, rel=1e-3)


def test_knn_bound_at_icp_shape():
    # 2000 x 10242 x 9 / 3.3454e13 = 5.51 us (PERF.md's 0.0055 ms)
    assert knn.bound_s(2000, 10242, 3, 1) == pytest.approx(5.511e-6, rel=1e-3)


def test_knn_bound_tiny_query_is_byte_bound():
    # 1 query against 4 refs: 9 x 4 instructions < (5 x 12 + 8) bytes read and written
    ops = 1 * 4 * 9 / P["f32_lane_instructions_per_s"]
    byts = (5 * 3 * 4 + 1 * 1 * 8) / P["hbm_bytes_per_s"]
    assert byts > ops
    assert knn.bound_s(1, 4, 3, 1) == pytest.approx(byts)
