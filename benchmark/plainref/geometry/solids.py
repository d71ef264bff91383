"""Solid-body integrals and plane helpers (host-side, NumPy).

Volume / CenterOfMass / Inertia over closed triangle meshes, matching
third_party/geometric.h:372-428, and PolyPlane (geometric.h:247-260) used to
derive the per-triangle plane sets for point-cloud correspondence
(physmodel.h:44-53).
"""
from __future__ import annotations

import numpy as np


def _dets(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    return np.einsum("ij,ij->i", a, np.cross(b, c))


def center_of_mass(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    d = _dets(verts, tris)
    s = verts[tris[:, 0]] + verts[tris[:, 1]] + verts[tris[:, 2]]
    return (d[:, None] * s).sum(0) / (d.sum() * 4.0)


def inertia(verts: np.ndarray, tris: np.ndarray, com: np.ndarray) -> np.ndarray:
    """geometric.h:398-428; unit mass, about `com`. Returns 3x3."""
    vol = 0.0
    diag = np.zeros(3)
    offd = np.zeros(3)
    for t in tris:
        A = np.stack([verts[t[0]] - com, verts[t[1]] - com, verts[t[2]] - com])
        d = np.linalg.det(A)
        vol += d
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            diag[j] += (A[0, j] * A[1, j] + A[1, j] * A[2, j] + A[2, j] * A[0, j]
                        + A[0, j] ** 2 + A[1, j] ** 2 + A[2, j] ** 2) * d
            offd[j] += (A[0, j1] * A[1, j2] + A[1, j1] * A[2, j2] + A[2, j1] * A[0, j2]
                        + A[0, j1] * A[2, j2] + A[1, j1] * A[0, j2] + A[2, j1] * A[1, j2]
                        + A[0, j1] * A[0, j2] * 2 + A[1, j1] * A[1, j2] * 2
                        + A[2, j1] * A[2, j2] * 2) * d
    diag /= vol * (60.0 / 6.0)
    offd /= vol * (120.0 / 6.0)
    return np.array([
        [diag[1] + diag[2], -offd[2], -offd[1]],
        [-offd[2], diag[0] + diag[2], -offd[0]],
        [-offd[1], -offd[0], diag[0] + diag[1]],
    ])


def poly_plane(verts: np.ndarray) -> np.ndarray:
    """geometric.h:247 PolyPlane: area-weighted normal about the centroid."""
    c = verts.mean(0)
    n = np.zeros(3)
    k = len(verts)
    for i in range(k):
        n += np.cross(verts[i] - c, verts[(i + 1) % k] - c)
    if not np.any(n):
        return np.zeros(4)
    n = n / np.linalg.norm(n)
    return np.concatenate([n, [-np.dot(c, n)]])


def tri_planes(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """physmodel.h:44 Planes(): one plane per non-degenerate triangle."""
    out = []
    for t in tris:
        p = poly_plane(verts[t])
        if np.any(p):
            out.append(p)
    return np.asarray(out)
