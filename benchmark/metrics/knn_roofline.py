"""The k-NN kernel's (``knn_kernel``, ``csrc/knn.cu``) share of its
roofline, in %: the least time of every launch that did work
(``roofline/knn.py``), over the summed device time of its events in the
device trace.  A traced call's launches that work: ICP's real iterations
(``icp.ICP_STATS``) at its landmarks x the target, the spectra's warm start
(source x target), the eigsort's sample x sample, 'kd' correspondences
(source x target) and the final k = 3 query (source x target), in 3-D; the
masked replays after ICP's stop do no work and count as none."""

from harness.trace import kernel_events
from roofline import knn


def read(trace):
    ev = kernel_events(trace, "knn_kernel", exclude="topk")
    busy_s = sum(e["dur"] for e in ev) / 1e6
    if not busy_s:
        return None
    bound = 0.0
    for c in trace["calls"]:
        ns, nt = c["n_source"], c["n_target"]
        bound += c["icp_iterations"] * knn.bound_s(c["icp_rows"], nt, 3, 1)
        bound += knn.bound_s(ns, nt, 3, 1)
        bound += knn.bound_s(c["eigsort_rows"], c["eigsort_rows"], 3, 1)
        if c["initial"] == "kd":
            bound += knn.bound_s(ns, nt, 3, 1)
        bound += knn.bound_s(ns, nt, 3, 3)
    return 100.0 * bound / busy_s
