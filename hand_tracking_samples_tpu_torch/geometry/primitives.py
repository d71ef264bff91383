"""Procedural convex polygon meshes: box / cylinder / cone / crop / dual.

The remaining WingMesh surface (third_party/wingmesh.h:838-1052) in the
polygon-list representation used by geometry/subdiv.py (the reference's
half-edge structure exists to support interactive editing; these builders
run host-side at model/tool time).  Vertex positions and face planes match
the reference builders; face ordering: side faces first, then bottom, top
(WingMeshCylinder/Cone), cap face appended by crop (the reference overwrites
face 0 instead, wingmesh.h:725).
"""
from __future__ import annotations

import numpy as np


def mesh_box(bmin, bmax):
    """WingMeshBox (wingmesh.h:874-893): 8 verts, 6 outward quads."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    verts = np.array([[x0, y0, z0], [x0, y0, z1], [x0, y1, z0], [x0, y1, z1],
                      [x1, y0, z0], [x1, y0, z1], [x1, y1, z0], [x1, y1, z1]])
    # faces in the reference's plane order (-x,+x,-y,+y,-z,+z), CCW outward
    faces = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6],
             [0, 2, 6, 4], [1, 5, 7, 3]]
    return verts, faces


def mesh_cube(r: float):
    return mesh_box([-r, -r, -r], [r, r, r])


def mesh_cylinder(sides: int, radius: float, height: float):
    """WingMeshCylinder (wingmesh.h:995-1023)."""
    a = np.arange(sides) * (6.2831853 / sides)
    verts = np.zeros((2 * sides, 3))
    verts[0::2, 0] = np.cos(a) * radius
    verts[0::2, 1] = np.sin(a) * radius
    verts[1::2] = verts[0::2]
    verts[1::2, 2] = height
    faces = [[i * 2, ((i + 1) % sides) * 2, ((i + 1) % sides) * 2 + 1,
              i * 2 + 1] for i in range(sides)]
    faces.append([(sides - i - 1) * 2 for i in range(sides)])   # bottom
    faces.append([i * 2 + 1 for i in range(sides)])             # top
    return verts, faces


def mesh_cone(sides: int, radius: float, height: float):
    """WingMeshCone (wingmesh.h:1025-1051)."""
    a = np.arange(sides) * (6.2831853 / sides)
    verts = np.zeros((sides + 1, 3))
    verts[:sides, 0] = np.cos(a) * radius
    verts[:sides, 1] = np.sin(a) * radius
    verts[sides, 2] = height
    faces = [[i, (i + 1) % sides, sides] for i in range(sides)]
    faces.append([sides - i - 1 for i in range(sides)])         # bottom
    return verts, faces


def face_planes(verts, faces):
    """Outward plane (n, w) per face with dot(n, v) + w = 0 on the face
    (PolyPlane semantics, Newell normal)."""
    verts = np.asarray(verts, np.float64)
    planes = []
    for f in faces:
        p = verts[list(f)]
        n = np.zeros(3)
        for i in range(len(f)):
            a, b = p[i], p[(i + 1) % len(f)]
            n += np.cross(a, b)
        n /= max(np.linalg.norm(n), 1e-30)
        planes.append(np.concatenate([n, [-np.dot(n, p.mean(axis=0))]]))
    return np.asarray(planes)


def mesh_crop(verts, faces, plane, epsilon: float = 1e-6):
    """WingMeshCrop (wingmesh.h:710-727) for convex polygon meshes: keep the
    part under `plane` (dot(n,v)+w <= 0), cap with the slice polygon.
    Returns (verts, faces) with the cap face appended; ([], []) if the mesh
    is entirely over the plane; the input if entirely under."""
    verts = np.asarray(verts, np.float64)
    plane = np.asarray(plane, np.float64)
    d = verts @ plane[:3] + plane[3]
    if (d >= -epsilon).all():
        return np.zeros((0, 3)), []
    if (d <= epsilon).all():
        return verts, [list(f) for f in faces]

    new_verts: list = []
    vid: dict = {}

    def key_of(p):
        return tuple(np.round(p / max(epsilon, 1e-9)).astype(np.int64))

    def add(p):
        k = key_of(p)
        if k not in vid:
            vid[k] = len(new_verts)
            new_verts.append(np.asarray(p, np.float64))
        return vid[k]

    out_faces = []
    cap_edges = []
    for f in faces:
        poly = [verts[i] for i in f]
        dv = [d[i] for i in f]
        clipped = []
        cap_pts = []
        n = len(poly)
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            da, db = dv[i], dv[(i + 1) % n]
            if da <= epsilon:
                clipped.append(a)
            if (da < -epsilon) != (db < -epsilon) and abs(da - db) > 1e-30:
                t = da / (da - db)
                x = a + (b - a) * t
                if da <= epsilon and db > epsilon:
                    clipped.append(x)
                    cap_pts.append(x)
                elif da > epsilon:
                    clipped.append(x)
                    cap_pts.append(x)
        if len(clipped) >= 3:
            ids = [add(p) for p in clipped]
            ids = [ids[i] for i in range(len(ids))
                   if ids[i] != ids[(i + 1) % len(ids)]]
            if len(ids) >= 3:
                out_faces.append(ids)
        if len(cap_pts) == 2:
            cap_edges.append((add(cap_pts[0]), add(cap_pts[1])))

    # cap polygon: order the boundary verts around the plane normal
    cap_ids = sorted({i for e in cap_edges for i in e})
    if len(cap_ids) >= 3:
        pts = np.asarray([new_verts[i] for i in cap_ids])
        c = pts.mean(axis=0)
        nrm = plane[:3]
        u = pts[0] - c
        u -= nrm * np.dot(u, nrm)
        u /= max(np.linalg.norm(u), 1e-30)
        w = np.cross(nrm, u)
        ang = np.arctan2((pts - c) @ w, (pts - c) @ u)
        order = [cap_ids[i] for i in np.argsort(ang)]
        out_faces.append(order)
    return np.asarray(new_verts), out_faces


def mesh_dual(verts, faces, r: float = 1.0):
    """WingMeshDual (wingmesh.h:838-869): polar dual of a convex mesh
    containing the origin.  Dual verts = face planes scaled to radius r;
    dual faces = the face cycle around each original vertex."""
    verts = np.asarray(verts, np.float64)
    planes = face_planes(verts, faces)
    dverts = planes[:, :3] * (-r * r / planes[:, 3])[:, None]

    # ordered face cycle per vertex: follow shared edges
    edge2face = {}
    for fi, f in enumerate(faces):
        for i in range(len(f)):
            edge2face[(f[i], f[(i + 1) % len(f)])] = fi
    dfaces = []
    for v in range(len(verts)):
        incident = [fi for fi, f in enumerate(faces) if v in f]
        if not incident:
            continue
        cycle = [incident[0]]
        while len(cycle) < len(incident):
            f = faces[cycle[-1]]
            i = f.index(v)
            prev_v = f[(i - 1) % len(f)]
            nxt = edge2face[(v, prev_v)]
            if nxt in cycle:
                break
            cycle.append(nxt)
        dfaces.append(cycle)
    return dverts, dfaces
