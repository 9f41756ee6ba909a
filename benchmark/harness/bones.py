"""Synthetic bone meshes, the benchmark's inputs.

A frozen copy of the repository's synthetic bone (``tests/conftest.py``'s
formula as ``chip_smoke.synthetic_bone`` builds it): an icosahedron
subdivided ``levels`` times by edge midpoints (f32 after each level, as the
port's ``multires.subdivide`` rounds), pushed onto the unit sphere, then a
radius field of four seeded harmonics and an elongation to 16 x 13 x 38 mm.
Level 5 has 10242 vertices, level 6 40962.  Pure numpy: the benchmark makes
its inputs itself and hands the same arrays to the program and to the
reference.
"""

from __future__ import annotations

import numpy as np

_T = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_VERTS = np.array(
    [
        (-1, _T, 0), (1, _T, 0), (-1, -_T, 0), (1, -_T, 0),
        (0, -1, _T), (0, 1, _T), (0, -1, -_T), (0, 1, -_T),
        (_T, 0, -1), (_T, 0, 1), (-_T, 0, -1), (-_T, 0, 1),
    ],
    np.float64,
)
_ICO_FACES = np.array(
    [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ],
    np.int64,
)


def _subdivide(pts: np.ndarray, tris: np.ndarray):
    """Midpoint (1-to-4) subdivision; new vertices in order of their sorted
    edge keys, points rounded to f32."""
    n = pts.shape[0]
    e = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    uniq, inv = np.unique(e[:, 0] * n + e[:, 1], return_inverse=True)
    eu = np.stack([uniq // n, uniq % n], axis=1)
    pts64 = pts.astype(np.float64)
    new_pts = np.concatenate([pts64, 0.5 * (pts64[eu[:, 0]] + pts64[eu[:, 1]])])
    m = inv.reshape(3, -1).T + n
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    mab, mbc, mca = m[:, 0], m[:, 1], m[:, 2]
    new_tris = np.concatenate([
        np.stack([a, mab, mca], 1), np.stack([mab, b, mbc], 1),
        np.stack([mca, mbc, c], 1), np.stack([mab, mbc, mca], 1),
    ])
    return new_pts.astype(np.float32), new_tris


def sphere(levels: int):
    """The subdivided icosahedron: (points f32 [N, 3], triangles int64 [F, 3])."""
    pts, tris = _ICO_VERTS.astype(np.float32), _ICO_FACES
    for _ in range(levels):
        pts, tris = _subdivide(pts, tris)
    return pts, tris


def bone(seed: int, levels: int, base=None):
    """The synthetic bone of ``seed``: (points f32 [N, 3] in mm, triangles
    int32 [F, 3]).  ``base``: ``sphere(levels)``, when the caller builds
    several bones of one level."""
    pts, tris = sphere(levels) if base is None else base
    u = pts.astype(np.float64)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 4)
    amp = rng.uniform(0.04, 0.10, 4)
    r = 1.0 + amp[0] * np.sin(2.0 * u[:, 0] + ph[0]) * np.cos(1.5 * u[:, 1] + ph[1])
    r = r + amp[1] * np.sin(3.0 * u[:, 2] + ph[2])
    r = r + amp[2] * np.cos(2.5 * u[:, 1] + ph[3]) * u[:, 2]
    r = r + amp[3] * u[:, 0] * u[:, 1]
    out = u * r[:, None] * np.array([[16.0, 13.0, 38.0]])
    return out.astype(np.float32), tris.astype(np.int32)
