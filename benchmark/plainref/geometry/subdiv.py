"""Catmull-Clark subdivision (host-side, NumPy).

Matches the reference WingMeshSubDiv (third_party/wingmesh.h:730-788) which is
used exactly twice per control cage at model-load time.  Note the reference's
vertex-update rule uses the *Catmull-Clark edge points* (not raw edge
midpoints) in the vertex smoothing term, because the half-edge structure is
split before original vertices are repositioned:

    face_point f  = mean(face verts)
    edge_point e  = (v0 + v1 + f_left + f_right) / 4
    v' = v*(k-2)/k + sum(edge_points at v)/k^2 + sum(face_points at v)/k^2

This runs offline on tiny meshes (18 verts, 16 quads) so plain Python/NumPy
is the right tool; the resulting geometry is baked into arrays for the device.
"""
from __future__ import annotations

import numpy as np


def catmull_clark(verts: np.ndarray, faces: list[list[int]]):
    """One Catmull-Clark pass. Returns (new_verts, new_faces).

    verts: (V, 3) float array.  faces: list of index lists (closed manifold).
    """
    verts = np.asarray(verts, dtype=np.float64)
    nv = len(verts)
    nf = len(faces)

    face_points = np.stack([verts[list(f)].mean(axis=0) for f in faces])

    # undirected edge -> (faces containing it)
    edge_faces: dict[tuple[int, int], list[int]] = {}
    for fi, f in enumerate(faces):
        n = len(f)
        for i in range(n):
            a, b = f[i], f[(i + 1) % n]
            edge_faces.setdefault((min(a, b), max(a, b)), []).append(fi)

    edge_index: dict[tuple[int, int], int] = {}
    edge_points = []
    for e, fs in edge_faces.items():
        assert len(fs) == 2, f"non-manifold edge {e}"
        a, b = e
        ep = (verts[a] + verts[b] + face_points[fs[0]] + face_points[fs[1]]) / 4.0
        edge_index[e] = nv + len(edge_points)
        edge_points.append(ep)
    edge_points = np.stack(edge_points)

    # per-vertex incident edges & faces
    vert_edges: list[list[tuple[int, int]]] = [[] for _ in range(nv)]
    vert_faces: list[list[int]] = [[] for _ in range(nv)]
    for fi, f in enumerate(faces):
        n = len(f)
        for i in range(n):
            a, b = f[i], f[(i + 1) % n]
            vert_faces[a].append(fi)
            vert_edges[a].append((min(a, b), max(a, b)))

    new_orig = np.empty_like(verts)
    for v in range(nv):
        k = len(vert_edges[v])
        ecom = sum(edge_points[edge_index[e] - nv] for e in vert_edges[v])
        fcom = sum(face_points[fi] for fi in vert_faces[v])
        new_orig[v] = verts[v] * ((k - 2.0) / k) + ecom / (k * k) + fcom / (k * k)

    face_point_index = {fi: nv + len(edge_points) + fi for fi in range(nf)}
    new_verts = np.concatenate([new_orig, edge_points, face_points])

    new_faces: list[list[int]] = []
    for fi, f in enumerate(faces):
        n = len(f)
        c = face_point_index[fi]
        for i in range(n):
            a = f[i]
            e_prev = edge_index[(min(f[i - 1], a), max(f[i - 1], a))]
            e_next = edge_index[(min(a, f[(i + 1) % n]), max(a, f[(i + 1) % n]))]
            new_faces.append([a, e_next, c, e_prev])

    return new_verts, new_faces


