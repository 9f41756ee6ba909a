"""Whether a registration is correct: each stage of it against the plain
reference (``reference/stages.py``), from the stage's own inputs.

A registration is chaotic as a whole (eigenvector signs, ICP's last bits
and CPD's stop in float32 noise move correspondences), so the reference
follows it stage by stage: each stage is recomputed in float64 from what the
candidate's earlier stages handed it, and the candidate's output of the
stage is compared with that.  The numbers (each a gap, 0 for the
reference itself):

icp      the smaller of the landmarks' mean distance to the reference ICP's
         and their mean motion in one float64 ICP iteration from the moved
         source, over ICP's stop threshold: the result is the reference's,
         or, where near-tied neighbours led float32 to another fixed point
         than float64's, a fixed point to within the threshold
eig_val  max relative gap of the 2 x 6 eigenvalues to ARPACK's
eig_vec  max 1 - cos of the angle between an eigenvector (undone from its
         min-max normalisation, in the symmetric form) and ARPACK's, a
         cluster of eigenvalues within 1e-3 of each other taken as a span
sort     max of the relative gap of the eigsort's matched costs Q and the
         largest gap of its sorted eigenvectors, against the reference
         eigsort of the same vectors
cpd      max |moved target spectral coordinates - the reference CPD's|, at
         the reference's iteration nearest them among those where float32
         may stop (|delta sigma2| within 8 times the tolerance, or the last)
corr     'kd': max over source rows of the distance to the chosen target
         row less the distance to the nearest; 'hungarian': the relative
         gap of the assignment's total distance to the optimum's
smooth   max |smoothed target - reference|, |projected source - reference|,
         / the diagonal
final    max of the final correspondences' nearest-neighbour gap and the
         k = 3 locations' gap (rows whose third and fourth neighbours tie
         left out), / the diagonal

The control (:func:`control_outputs`) recomputes each stage in the
reference's lower-precision arithmetic from the same inputs the candidate's
stage had, and is read by the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from reference import stages

NUMBERS = ("icp", "eig_val", "eig_vec", "sort", "cpd", "corr", "smooth", "final")

# The configuration the reference covers; other values raise.
COVERED = {
    "icp_register_first": True, "icp_registration_mode": "rigid",
    "icp_reg_target_to_source": False, "target_eigenmap_as_reference": True,
    "get_weighted_spectral_coords": False, "use_features_as_coords": False,
    "include_points_as_features": False, "use_features_in_graph": False,
    "include_features_in_adj_matrix": False, "rigid_before_non_rigid_reg": False,
    "non_rigid_outlier_w": 0.0, "smooth_correspondences": True,
    "final_correspondence_type": "kd", "compute_mutual_consistency": False,
}
# Third and fourth neighbours closer than this share of the third's
# distance make a row's k = 3 set ambiguous.
TIE_SHARE = 1e-6
# Eigenvalues closer than this share are one cluster: their vectors are
# compared as a span.
CLUSTER_GAP = 1e-3
# CPD stops once |delta sigma2| <= its tolerance; float32 reads sigma2 with
# noise of a few 1e-9 at these sizes, so the program may stop where the
# float64 trajectory's |delta sigma2| is a few times the tolerance.
STOP_SLACK = 8.0


def check_covered(cfg: dict):
    bad = {k: cfg[k] for k, v in COVERED.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the reference does not cover these settings: {bad}")


class Mesh:
    """One input mesh, with its float64 operators and (lazily) ARPACK's
    spectrum."""

    def __init__(self, points, triangles, k: int):
        self.points = np.asarray(points, np.float32)
        self.triangles = np.asarray(triangles)
        self.ops = stages.MeshOps(self.points, self.triangles)
        self.k = k
        self._spec = None

    @property
    def spectrum(self):
        if self._spec is None:
            self._spec = stages.spectrum(self.ops, self.k)
        return self._spec


def program_view(res: dict) -> dict:
    """The candidate arrays (numpy) from a ``register_pair`` result: every
    output the numbers read, and the moved source, which the result holds
    as 2 average_points - weighted_points."""
    out = {k: v.detach().cpu().numpy() for k, v in res.items() if torch.is_tensor(v)}
    out["moved_source"] = (2.0 * out["average_points"].astype(np.float64)
                           - out["weighted_points"].astype(np.float64))
    return out


def _sym_vectors(mops, vecs_norm):
    """Symmetric-form vectors a (v = s a) of min-max normalised generalized
    eigenvectors: the constant the normalisation added is removed by the
    D-weighted mean (eigenvectors of nonzero eigenvalues are D-orthogonal
    to the constants)."""
    v = np.asarray(vecs_norm, np.float64)
    v = v - (mops.d @ v) / mops.d.sum()
    return v / mops.s[:, None]


def eig_numbers(mesh: Mesh, lams, vecs_norm):
    """(eig_val, eig_vec) of eigenvalues ``lams`` [k] and normalised
    eigenvectors [N, k] in the same (ascending) order: the largest relative
    gap of an eigenvalue to ARPACK's, and the largest 1 - cos of the angle
    between a vector (in the symmetric form, unit length) and ARPACK's of
    the same mode; modes whose eigenvalues lie within ``CLUSTER_GAP`` of
    each other are taken together, as the smallest cosine of the principal
    angles between the two spans."""
    ref_lams, ref_vecs = mesh.spectrum
    lams = np.asarray(lams, np.float64)
    val = float(np.max(np.abs(lams - ref_lams) / ref_lams))
    a = _sym_vectors(mesh.ops, vecs_norm)
    a = a / np.linalg.norm(a, axis=0, keepdims=True)
    cos = ref_vecs.T @ a
    worst, start = 0.0, 0
    for j in range(1, len(ref_lams) + 1):
        if j < len(ref_lams) and ref_lams[j] - ref_lams[j - 1] < CLUSTER_GAP * ref_lams[j]:
            continue
        block = cos[start:j, start:j]
        worst = max(worst, 1.0 - float(np.linalg.svd(block, compute_uv=False).min()))
        start = j
    return val, worst


def source_in_mode_order(mesh: Mesh, lams_s, sorted_norm):
    """The sorted source eigenvectors put back in ascending eigenvalue
    order: each column labelled with the eigenvalue its Rayleigh quotient in
    the float64 Laplacian lies nearest (one column each)."""
    a = _sym_vectors(mesh.ops, sorted_norm)
    rq = np.einsum("nk,nk->k", a, mesh.ops.A @ a) / np.einsum("nk,nk->k", a, a)
    lams_s = np.asarray(lams_s, np.float64)
    cost = np.abs(rq[:, None] - lams_s[None, :]) / np.abs(lams_s)[None, :]
    cols, modes = linear_sum_assignment(cost)
    out = np.empty_like(np.asarray(sorted_norm))
    out[:, modes] = np.asarray(sorted_norm)[:, cols]
    return out


def diagonal(points) -> float:
    p = np.asarray(points, np.float64)
    return float(np.linalg.norm(p.max(axis=0) - p.min(axis=0)))


class Pair:
    """One registered pair's inputs: the meshes, the draws (numpy) and the
    configuration; the reference's own results, computed once."""

    def __init__(self, target: Mesh, source: Mesh, draws: dict, cfg: dict, device):
        check_covered(cfg)
        stages.set_full_f32()
        self.t, self.s, self.cfg = target, source, cfg
        self.draws = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                      for k, v in draws.items()}
        self.ref = stages.Arith("ref", device)
        self.diag = diagonal(target.points)
        self._icp = None
        self.info = {}

    def icp_gap(self, moved):
        lm = self.draws["icp_landmarks"]
        if self._icp is None:
            self._icp = stages.icp(self.ref, self.s.points, self.t.points, lm,
                                   self.cfg["icp_iterations"]).cpu().numpy()
        threshold = 1e-5 * (np.abs(self.t.points).max() + 1.0)
        gap = np.linalg.norm(moved[lm] - self._icp[lm], axis=1).mean() / threshold
        step = stages.icp_step(self.ref, self.s.points, self.t.points, lm, moved)
        self.info["icp"] = (float(gap), step)
        return float(min(gap, step))

    # -- stage inputs, taken from a candidate's earlier stages -------------

    def sort_inputs(self, cand):
        k = self.cfg["n_spectral_features"] + self.cfg["n_extra_spectral"]
        it, is_ = self.draws["eigsort_target"], self.draws["eigsort_source"]
        vs = source_in_mode_order(self.s, cand["eig_vals_source"],
                                  cand["eig_vecs_source_sorted"][:, :k])
        vt = cand["eig_vecs_target"][:, :k]
        return (cand["eig_vals_target"], cand["eig_vals_source"], vt[it], vs[is_],
                stages.unit_box(self.t.points[it]),
                stages.unit_box(cand["moved_source"][is_]), vs)

    def cpd_inputs(self, cand):
        kf = self.cfg["n_spectral_features"]
        src = cand["spectral_coords_source"][:, :kf]
        tgt = cand["eig_vecs_target"][:, :kf]
        return src[self.draws["cpd_source"]], tgt[self.draws["cpd_target"]], tgt

    def cpd_ref(self, X, Y, tgt, ar):
        c = self.cfg
        return stages.cpd(ar, X, Y, tgt, c["non_rigid_alpha"], c["non_rigid_beta"],
                          min(c["non_rigid_n_eigens"], X.shape[0]),
                          c["non_rigid_max_iterations"], c["non_rigid_tolerance"])

    def cpd_gap(self, moved, X, Y, tgt):
        """The smallest max |moved - reference warp| over the iterations at
        which the reference's EM may stop in float32: where its own |delta
        sigma2| is within ``STOP_SLACK`` times the tolerance, or the last.
        Also sets ``self.info["cpd_stop"]``: (that iteration, its |delta
        sigma2| over the tolerance)."""
        c, ref = self.cfg, self.ref
        tol, last = c["non_rigid_tolerance"], c["non_rigid_max_iterations"]
        Qm, sl, zs, dsig, _ = stages.cpd_em(
            ref, X, Y, c["non_rigid_alpha"], c["non_rigid_beta"],
            min(c["non_rigid_n_eigens"], X.shape[0]), last, tol, run_out=True)
        basis = stages.cpd_basis(ref, tgt, Y, Qm, c["non_rigid_beta"])
        moved = ref.t(moved)
        best = (float("inf"), None)
        for n, d in enumerate(dsig, start=1):
            if d <= STOP_SLACK * tol or n == last:
                gap = float((moved - stages.cpd_warp(ref, tgt, basis, sl, zs[n - 1])).abs().max())
                best = min(best, (gap, n))
        self.info["cpd_stop"] = (best[1], dsig[best[1] - 1] / tol)
        return best[0]

    # -- the numbers ---------------------------------------------------------

    def numbers(self, cand: dict, inputs_from: dict = None) -> dict:
        """Every number of candidate ``cand`` (a :func:`program_view` or a
        :func:`control_outputs` dict).  ``inputs_from``: where each stage's
        inputs come from (the program's view when ``cand`` is the control's;
        ``cand`` itself when None)."""
        src = cand if inputs_from is None else inputs_from
        ref, c, diag = self.ref, self.cfg, self.diag
        out = {}
        out["icp"] = self.icp_gap(cand["moved_source"])

        k = c["n_spectral_features"] + c["n_extra_spectral"]
        vt_val, vt_vec = eig_numbers(self.t, cand["eig_vals_target"],
                                     cand["eig_vecs_target"][:, :k])
        vs_ordered = cand.get("eig_vecs_source_ordered")
        if vs_ordered is None:
            vs_ordered = source_in_mode_order(self.s, cand["eig_vals_source"],
                                              cand["eig_vecs_source_sorted"][:, :k])
        vs_val, vs_vec = eig_numbers(self.s, cand["eig_vals_source"], vs_ordered)
        out["eig_val"] = max(vt_val, vs_val)
        out["eig_vec"] = max(vt_vec, vs_vec)

        sorted_ref, q_ref = stages.eigsort(ref, *self.sort_inputs(src))
        q = np.asarray(cand["Q"], np.float64)
        out["sort"] = max(float(np.max(np.abs(q - q_ref) / np.abs(q_ref))),
                          float(np.max(np.abs(cand["eig_vecs_source_sorted"][:, :k]
                                              - sorted_ref))))

        X, Y, tgt = self.cpd_inputs(src)
        kf = c["n_spectral_features"]
        out["cpd"] = self.cpd_gap(cand["spectral_coords_target"][:, :kf], X, Y, tgt)

        s_coords = ref.t(src["spectral_coords_source"][:, :kf])
        t_moved = ref.t(src["spectral_coords_target"][:, :kf])
        corr = np.asarray(cand["initial_correspondences"], np.int64)
        if c["initial_correspondence_type"] == "kd":
            d_min = torch.sqrt(ref.knn(t_moved, s_coords, 1)[0][:, 0])
            d_c = torch.linalg.norm(s_coords - t_moved[torch.as_tensor(corr, device=ref.device)],
                                    dim=1)
            out["corr"] = float((d_c - d_min).max())
        else:
            out["corr"] = self._assignment_gap(s_coords, t_moved, corr)

        sm_ref = stages.mean_filter(ref, self.t.ops, self.t.points,
                                    c["graph_smoothing_iterations"]).cpu().numpy()
        init = np.asarray(src["initial_correspondences"], np.int64)
        proj_ref = stages.mean_filter(ref, self.s.ops, src["smoothed_target_coords"][init],
                                      c["projection_smooth_iterations"]).cpu().numpy()
        out["smooth"] = max(
            float(np.max(np.abs(cand["smoothed_target_coords"] - sm_ref))),
            float(np.max(np.abs(cand["source_projected_on_target"] - proj_ref)))) / diag

        out["final"] = self._final_gap(src["smoothed_target_coords"],
                                       src["source_projected_on_target"],
                                       cand["correspondences"], cand["weighted_points"]) / diag
        return out

    def _assignment_gap(self, s_coords, t_moved, corr):
        n = s_coords.shape[0]
        if np.unique(corr).shape[0] != n or corr.min() < 0 or corr.max() >= n:
            return float("inf")
        cost = torch.sqrt(self.ref.sqdist(s_coords, t_moved)).cpu().numpy()
        rows, cols = linear_sum_assignment(cost)
        best = cost[rows, cols].sum()
        return float((cost[np.arange(n), corr].sum() - best) / best)

    def _final_gap(self, smoothed, projected, corr, weighted):
        ref = self.ref
        sm, pr = ref.t(smoothed), ref.t(projected)
        d2, idx = ref.knn(sm, pr, 4)
        d = torch.sqrt(d2)
        corr = torch.as_tensor(np.asarray(corr, np.int64), device=ref.device)
        nn_gap = (torch.linalg.norm(pr - sm[corr], dim=1) - d[:, 0]).max()
        _, idw = stages.knn3_idw(ref, sm, self.t.points, pr)
        clear = (d[:, 3] - d[:, 2]) > TIE_SHARE * d[:, 2]
        gap = torch.linalg.norm(ref.t(weighted) - idw, dim=1)
        idw_gap = torch.where(clear, gap, torch.zeros_like(gap)).max()
        return float(torch.maximum(nn_gap, idw_gap))


def control_outputs(pair: Pair, prog: dict, device) -> dict:
    """The control's output of every stage, each stage computed in the
    control's arithmetic from the inputs the program's stage had."""
    ctl = stages.Arith("ctl", device)
    c = pair.cfg
    k = c["n_spectral_features"] + c["n_extra_spectral"]
    kf = c["n_spectral_features"]
    out = {"moved_source": stages.icp(ctl, pair.s.points, pair.t.points,
                                      pair.draws["icp_landmarks"],
                                      c["icp_iterations"]).cpu().numpy()}
    lt, vt = stages.ritz(ctl, pair.t.ops, pair.t.spectrum[1])
    ls, vs = stages.ritz(ctl, pair.s.ops, pair.s.spectrum[1])
    out["eig_vals_target"] = lt.cpu().numpy()
    out["eig_vecs_target"] = vt.cpu().numpy()
    out["eig_vals_source"] = ls.cpu().numpy()
    out["eig_vecs_source_ordered"] = vs.cpu().numpy()
    sorted_ctl, q_ctl = stages.eigsort(ctl, *pair.sort_inputs(prog))
    out["eig_vecs_source_sorted"] = sorted_ctl
    out["Q"] = q_ctl
    X, Y, tgt = pair.cpd_inputs(prog)
    out["spectral_coords_target"] = pair.cpd_ref(X, Y, tgt, ctl).cpu().numpy()
    s_coords = prog["spectral_coords_source"][:, :kf]
    t_moved = prog["spectral_coords_target"][:, :kf]
    if c["initial_correspondence_type"] == "kd":
        out["initial_correspondences"] = stages.nearest(ctl, t_moved, s_coords).cpu().numpy()
    else:
        out["initial_correspondences"] = stages.assignment(ctl, t_moved, s_coords)
    init = np.asarray(prog["initial_correspondences"], np.int64)
    out["smoothed_target_coords"] = stages.mean_filter(
        ctl, pair.t.ops, pair.t.points, c["graph_smoothing_iterations"]).cpu().numpy()
    out["source_projected_on_target"] = stages.mean_filter(
        ctl, pair.s.ops, prog["smoothed_target_coords"][init],
        c["projection_smooth_iterations"]).cpu().numpy()
    corr, weighted = stages.knn3_idw(ctl, prog["smoothed_target_coords"], pair.t.points,
                                     prog["source_projected_on_target"])
    out["correspondences"] = corr.cpu().numpy()
    out["weighted_points"] = weighted.cpu().numpy()
    return out
