"""The share of the traced window in which no device operation ran:
1 - busy / window, busy the union of the device events' intervals."""


def read(trace):
    if not trace["window_s"] or not trace["busy_s"]:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
