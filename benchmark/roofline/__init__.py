"""The yardstick of the kernels' roofline shares: the card's published
peaks (``peaks.json``) and each kernel's least time from its shapes."""

import json
import os


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        return json.load(f)
