"""Registration-quality metrics.

Counterpart of ``pyfocusr_tpu/metrics.py``: ``surface_distance`` (:42) and
``registration_quality`` (:57).  The nearest-neighbour queries run on the
device of the result tensors (the k-NN kernel on CUDA); the readout is
python floats:

* ``unique_fraction``: fraction of source vertices claiming distinct target
  vertices (many-to-one collapse is the failure mode of a bad alignment);
* ``mean_displacement_mm``: mean distance each source vertex moved;
* ``symmetric_surface_dist_mm``: mean nearest-neighbour distance from the
  moved source to the target and back, averaged;
* ``hausdorff_mm``: the maximum of those distances, both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.knn import nn_query

__all__ = ["registration_quality", "surface_distance"]


def _points_of(obj, device):
    pts = getattr(obj, "points", obj)
    if torch.is_tensor(pts):
        return pts.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(pts, np.float32), device=device)


def surface_distance(points_a, points_b, device=None):
    """Symmetric nearest-neighbour surface distance between two point sets
    (or meshes): ``(mean_mm, hausdorff_mm)``.  Runs on ``device``, default
    the device of ``points_a`` when it is a tensor, else the CPU."""
    if device is None:
        pa = getattr(points_a, "points", points_a)
        device = pa.device if torch.is_tensor(pa) else torch.device("cpu")
    a = _points_of(points_a, device)
    b = _points_of(points_b, device)
    d_ab, _ = nn_query(b, a)  # for each a-point: nearest b-point
    d_ba, _ = nn_query(a, b)
    d_ab = d_ab.double().cpu().numpy()
    d_ba = d_ba.double().cpu().numpy()
    mean = float((d_ab.mean() + d_ba.mean()) / 2.0)
    haus = float(max(d_ab.max(), d_ba.max()))
    return mean, haus


def registration_quality(target, source, result):
    """Quality readout of one ``register_pair`` result.  ``target`` /
    ``source``: the original meshes (TriMesh, arrays or tensors; ``source``
    as the result's displacement is measured from).  ``result``: dict with
    ``correspondences`` and ``weighted_points``.  Returns python floats."""
    moved_t = result["weighted_points"]
    device = moved_t.device
    corr = result["correspondences"].cpu().numpy()
    moved = moved_t.double().cpu().numpy()
    src = _points_of(source, "cpu").double().numpy()
    if moved.shape != src.shape:
        raise ValueError(
            f"weighted_points {moved.shape} does not match source points "
            f"{src.shape}; pass the same (unpadded) source the result was "
            "computed from"
        )
    mean, haus = surface_distance(moved_t, target, device=device)
    n_unique = int(len(np.unique(corr)))
    return {
        "n_source_points": int(corr.shape[0]),
        "n_unique_correspondences": n_unique,
        "unique_fraction": round(n_unique / corr.shape[0], 4),
        "mean_displacement_mm": round(
            float(np.linalg.norm(moved - src, axis=1).mean()), 4
        ),
        "symmetric_surface_dist_mm": round(mean, 4),
        "hausdorff_mm": round(haus, 4),
    }
