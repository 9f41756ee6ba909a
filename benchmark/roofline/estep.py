"""The least time of CPD's E-step, from its definition (not from any
kernel's design), so that every implementation is read against the same
work.  One E-step of M moving points TY and N fixed points X in D
dimensions computes, for every pair (m, n),

    p_mn = exp(-|x_n - ty_m|^2 / 2 sigma2),   den_n = sum_m p_mn,
    P1_m = sum_n p_mn / den_n,                PX_m = sum_n (p_mn / den_n) x_n,

and per point Pt1, Np and L, which are O(M + N) and left out.  Three
floors, the largest of which is the bound:

* exponentials: two a pair, over the special-function units' rate, 16 a
  clock an SM x 132 SMs x 1.98 GHz = 4.18176e12 a second (``SFU_EXP_PER_S``;
  the card's boost clock, as ``peaks.json``'s lane rate).  Two is the least
  at these sizes: the den_n must all be known before any p_mn / den_n, so a
  pass that takes one exponential a pair writes P and reads it back, 8 M N
  bytes over the memory bandwidth.  At 10242^2: two exponentials 50.17 us,
  one exponential 25.08 us + P written and read 250.5 us = 275.6 us.
* lane instructions: the formula's unfused f32 instructions a pair, counted
  as ``roofline/knn.py`` counts them, each once: the distance 3 D - 1 (D
  subtractions, D multiplies, D - 1 adds), the scale of the exponent 1,
  the column sum 1, the normalisation 1 (a multiply by 1 / den_n), P1 1,
  PX 2 D (D multiplies, D adds): 5 D + 3 a pair, over
  ``f32_lane_instructions_per_s`` (132 x 128 x 1.98 GHz).  At D = 3: 18 a
  pair, 10242^2 x 18 / 3.345408e13 = 56.44 us, the bound there.
* bytes: X and TY read once, Pt1, P1 and PX written once, f32, over
  ``hbm_bytes_per_s``: at 10242^2 D = 3, 450 648 bytes, 0.13 us.

``bound_s`` is the largest of the three per E-step, times the EM
iterations that did work.
"""

from . import peaks

# Exponentials a second: 16 a clock an SM (the SFUs' ex2 rate on sm_90),
# 132 SMs, 1.98 GHz.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
EXP_PER_PAIR = 2


def instructions_per_pair(d: int) -> int:
    """The E-step formula's unfused f32 lane instructions a pair."""
    return (3 * d - 1) + 1 + 1 + 1 + 1 + 2 * d


def floors_s(m: int, n: int, d: int, p: dict = None) -> dict:
    """The three floors of one E-step, in seconds."""
    p = peaks() if p is None else p
    pairs = m * n
    return {"exp": pairs * EXP_PER_PAIR / SFU_EXP_PER_S,
            "instructions": pairs * instructions_per_pair(d)
            / p["f32_lane_instructions_per_s"],
            "bytes": ((n + m) * d + n + m + m * d) * 4 / p["hbm_bytes_per_s"]}


def bound_s(m: int, n: int, d: int, iterations: int, p: dict = None) -> float:
    """The least time of ``iterations`` E-steps of M x N pairs in D
    dimensions: the largest floor of one, times ``iterations``."""
    return iterations * max(floors_s(m, n, d, p).values())
