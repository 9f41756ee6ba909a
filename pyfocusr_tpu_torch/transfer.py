"""Point-data transfer across computed correspondences.

Counterpart of ``pyfocusr_tpu/transfer.py`` (:37-214):
``transfer_point_data``, ``mesh_with_transferred_data`` and
``cohort_point_data_matrix``, the same arguments and results.  The
reference never ships the transfer step (users gather
``corresponding_target_idx_for_each_source_pt`` by hand); these make it a
tested operation in both directions:

* pair-level: pull named target point_data onto source vertices through a
  ``register_pair`` result (or the equivalent ``Focusr`` attributes);
* cohort-level: a [B, N_template] matrix of a named scalar in template
  vertex order across a registered cohort.

Results may hold numpy arrays or tensors.  The k=3 inverse-distance pull
(``ops/knn.idw_pull_k3``) runs on ``device``: by default the device of the
result's tensors, else the CUDA card (``utils.device.resolve_device``);
the transferred arrays come back as numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .mesh import TriMesh
from .ops.knn import idw_pull_k3
from .utils.device import as_f32, resolve_device, to_numpy

__all__ = [
    "transfer_point_data",
    "mesh_with_transferred_data",
    "cohort_point_data_matrix",
]


def transfer_point_data(
    target_mesh: TriMesh,
    result: dict,
    names: Optional[Iterable[str]] = None,
    method: str = "idw",
    n_source: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Pull named ``target_mesh.point_data`` arrays onto source vertices
    through a registration result (``pipeline.register_pair`` output or the
    equivalent ``Focusr`` attributes).

    method 'nearest'
        value at the final corresponding target vertex
        (``result['correspondences']``) — exact vertex lookup, no blending.
    method 'idw' (default)
        k=3 inverse-distance interpolation at the source's projected
        location on the (smoothed) target — the SAME neighbors and weights
        the pipeline uses for ``weighted_points`` (reference
        ``focusr.py:401-426``), so a transferred coordinate function
        reproduces ``weighted_points`` exactly.

    Returns ``{name: [Ns] (or [Ns, C]) np.ndarray}`` with ``Ns`` the REAL
    source vertex count when ``n_source`` is given, else the result's row
    count.  Pass ``n_source`` whenever the result came from PADDED graphs
    (``pad_n_points`` / ``pad_cohort``): padding is trailing, and without
    the slice the tail rows would interpolate at the padded origin points.
    Unknown names raise KeyError (a typo must not silently drop a
    measurement).  ``device``: where the pull runs (see the module
    docstring).
    """
    if method not in ("idw", "nearest"):
        raise ValueError(f"method must be 'idw' or 'nearest', got {method!r}")
    if names is None:
        names = list(target_mesh.point_data.keys())
    else:
        # Materialize: a generator would be consumed by the validation
        # loop and the later zip would silently yield nothing.
        names = list(names)
    out: Dict[str, np.ndarray] = {}
    corr = to_numpy(result["correspondences"])
    if n_source is not None:
        if not 0 < n_source <= corr.shape[0]:
            # Catch the wrong-mesh mistake loudly (the analogous
            # n_template check in cohort_point_data_matrix).
            raise ValueError(
                f"n_source={n_source} out of range for a result with "
                f"{corr.shape[0]} source rows"
            )
        corr = corr[:n_source]
    n_t = target_mesh.points.shape[0]
    all_vals = []
    for name in names:
        if name not in target_mesh.point_data:
            raise KeyError(
                f"target mesh has no point_data {name!r}; available: "
                f"{sorted(target_mesh.point_data)}"
            )
        vals = to_numpy(target_mesh.point_data[name])
        if vals.shape[0] != n_t:
            raise ValueError(
                f"point_data {name!r} has {vals.shape[0]} rows for a "
                f"{n_t}-vertex target"
            )
        all_vals.append(vals)
    if method == "nearest":
        return {name: vals[corr] for name, vals in zip(names, all_vals)}
    if not names:
        return out
    # IDW at the pipeline's own query/reference geometry, ONE KNN for all
    # arrays (the neighbors/weights do not depend on the values): stack
    # every value column into one matrix, pull, then split back.  The
    # result arrays are padded to the GraphArrays shapes; slice references
    # to the real target rows and queries to the real source rows
    # (``corr`` already carries the n_source slice).
    ref_coords = result["smoothed_target_coords"]
    if device is None and torch.is_tensor(ref_coords):
        dev = ref_coords.device
    else:
        dev = resolve_device(device)
    ref = as_f32(ref_coords, dev)[:n_t]
    queries = as_f32(result["source_projected_on_target"], dev)[: corr.shape[0]]
    stacked = np.concatenate(
        [v.reshape(n_t, -1).astype(np.float32) for v in all_vals], axis=1
    )
    pulled = to_numpy(
        idw_pull_k3(
            ref,
            torch.ones((n_t,), dtype=torch.float32, device=dev),
            torch.as_tensor(stacked, device=dev),
            queries,
        )
    )
    col = 0
    for name, vals in zip(names, all_vals):
        width = vals.reshape(n_t, -1).shape[1]
        block = pulled[:, col : col + width]
        out[name] = block[:, 0] if vals.ndim == 1 else block
        col += width
    return out


def mesh_with_transferred_data(
    source_mesh: TriMesh,
    target_mesh: TriMesh,
    result: dict,
    names: Optional[Iterable[str]] = None,
    method: str = "idw",
    suffix: str = "",
    device=None,
) -> TriMesh:
    """``transfer_point_data`` attached to a copy of ``source_mesh``
    (``suffix`` appended to each name, e.g. ``'_from_target'``)."""
    transferred = transfer_point_data(target_mesh, result, names, method,
                                      device=device)
    n_s = source_mesh.points.shape[0]
    mesh = source_mesh
    for name, vals in transferred.items():
        if vals.shape[0] < n_s:
            raise ValueError(
                f"transferred {name!r} has {vals.shape[0]} rows but "
                f"source_mesh has {n_s} vertices — result and source_mesh "
                "come from different registrations"
            )
        mesh = mesh.with_point_data(name + suffix, vals[:n_s])
    return mesh


def cohort_point_data_matrix(
    subject_meshes,
    results: dict,
    name: str,
    n_template: Optional[int] = None,
) -> np.ndarray:
    """Assemble a named per-vertex scalar across a registered cohort, in
    template vertex order: row b is subject b's measurement at each
    template vertex (via ``results['correspondences'][b]``, the
    ``parallel.cohort.register_cohort`` direction where the template is
    the source).  NaN where a subject lacks the scalar is NOT tolerated —
    missing names raise, mismatched sizes raise.

    Returns ``[B, N_template]`` (or ``[B, N_template, C]`` for vector
    data) — ready for group statistics or as SSM regressors.

    ``n_template``: the template's REAL vertex count.  Required knowledge
    for padded cohorts (``pad_cohort``): result rows beyond it are padding
    (their correspondences are masked to 0), so without slicing, the tail
    columns would all repeat each subject's vertex-0 value and poison any
    group statistic.  Defaults to the full row count (correct for unpadded
    cohorts).
    """
    corr = to_numpy(results["correspondences"])
    if n_template is not None:
        if not 0 < n_template <= corr.shape[1]:
            raise ValueError(
                f"n_template={n_template} out of range for correspondence "
                f"rows of length {corr.shape[1]}"
            )
        corr = corr[:, :n_template]
    rows = []
    for b, mesh in enumerate(subject_meshes):
        if name not in mesh.point_data:
            raise KeyError(
                f"subject {b} has no point_data {name!r}; available: "
                f"{sorted(mesh.point_data)}"
            )
        vals = to_numpy(mesh.point_data[name])
        n_b = mesh.points.shape[0]
        if vals.shape[0] != n_b:
            raise ValueError(
                f"subject {b} point_data {name!r} has {vals.shape[0]} rows "
                f"for a {n_b}-vertex mesh"
            )
        # Padded template rows gather index 0 (the pipeline masks them to
        # 0), which is always in range; any index >= n_b means the subject
        # order or registration direction does not match the results —
        # raise rather than silently clamp to the last vertex.
        idx = corr[b]
        if idx.size and int(idx.max()) >= n_b:
            raise ValueError(
                f"correspondence indices for subject {b} reach "
                f"{int(idx.max())} but the mesh has {n_b} vertices — "
                "subject_meshes order must match the registered cohort"
            )
        rows.append(vals[idx])
    return np.stack(rows)
