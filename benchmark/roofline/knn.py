"""The k-NN kernel's least time for one query (a frozen copy of
``chip_smoke.knn_bound``): 3 d unfused lane instructions a pair (d
subtractions, d multiplies, d - 1 adds and one compare) over the card's lane
rate, or the inputs read and the outputs written once over the memory
bandwidth, whichever is longer."""

from . import peaks


def bound_s(nq: int, nr: int, d: int, k: int, p: dict = None) -> float:
    p = peaks() if p is None else p
    ops_s = nq * nr * 3 * d / p["f32_lane_instructions_per_s"]
    bytes_s = ((nq + nr) * d * 4 + nq * k * 8) / p["hbm_bytes_per_s"]
    return max(ops_s, bytes_s)
