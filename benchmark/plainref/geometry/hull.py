"""Greedy incremental convex hull with vertex limit (host-side, NumPy).

Faithful re-implementation of the reference calchull
(third_party/hull.h:311-434): start from a max-extent tetrahedron, repeatedly
extrude the triangle with the largest "rise" toward its furthest outside
vertex, until the vertex limit (48 for hand bones, physmodel.h:454) is reached
or no vertex rises above epsilon.  Runs once per bone at model-load time.
"""
from __future__ import annotations

import numpy as np


def _maxdir(verts: np.ndarray, d: np.ndarray) -> int:
    return int(np.argmax(verts @ d))


def _tri_normal(a, b, c):
    cp = np.cross(b - a, c - b)
    m = np.linalg.norm(cp)
    if m == 0:
        return np.zeros(3)
    return cp / m


class _Tri:
    __slots__ = ("v", "n", "id", "vmax", "rise")

    def __init__(self, a, b, c, tid, n=(-1, -1, -1)):
        self.v = [a, b, c]
        self.n = list(n)
        self.id = tid
        self.vmax = -1
        self.rise = 0.0

    def dead(self):
        return self.n[0] == -1

    def neib_idx(self, va, vb):
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            if self.v[i] == va and self.v[i1] == vb:
                return i2
            if self.v[i] == vb and self.v[i1] == va:
                return i2
        raise AssertionError("bad neib")


def _b2bfix(tris, s, t):
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        va, vb = tris[s].v[i1], tris[s].v[i2]
        sa = tris[s].n[tris[s].neib_idx(va, vb)]
        ta = tris[t].n[tris[t].neib_idx(vb, va)]
        tris[sa].n[tris[sa].neib_idx(vb, va)] = ta
        tris[ta].n[tris[ta].neib_idx(va, vb)] = sa
    tris[s].n = [-1, -1, -1]
    tris[t].n = [-1, -1, -1]


def _extrude(tris, t0, v):
    t = list(tris[t0].v)
    b = len(tris)
    n = list(tris[t0].n)
    tris.append(_Tri(v, t[1], t[2], b + 0, (n[0], b + 1, b + 2)))
    tris[n[0]].n[tris[n[0]].neib_idx(t[1], t[2])] = b + 0
    tris.append(_Tri(v, t[2], t[0], b + 1, (n[1], b + 2, b + 0)))
    tris[n[1]].n[tris[n[1]].neib_idx(t[2], t[0])] = b + 1
    tris.append(_Tri(v, t[0], t[1], b + 2, (n[2], b + 0, b + 1)))
    tris[n[2]].n[tris[n[2]].neib_idx(t[0], t[1])] = b + 2
    tris[t0].n = [-1, -1, -1]
    for k in range(3):
        if v in tris[n[k]].v:
            _b2bfix(tris, b + k, n[k])


def _nnfix(tris, k):
    if tris[k].id == -1:
        return
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        if tris[k].n[i] != -1:
            nb = tris[tris[k].n[i]]
            nb.n[nb.neib_idx(tris[k].v[i2], tris[k].v[i1])] = k


def _compress(tris):
    j = len(tris)
    while j > 0:
        j -= 1
        if not tris[j].dead():
            continue
        last = len(tris) - 1
        tris[j], tris[last] = tris[last], tris[j]
        tris[j].id, tris[last].id = tris[last].id, tris[j].id
        _nnfix(tris, j)
        _nnfix(tris, last)
        tris.pop()
        j = min(j, len(tris))


def _find_simplex(verts):
    b0 = np.array([0.01, 0.02, 1.0])
    p0 = _maxdir(verts, b0)
    p1 = _maxdir(verts, -b0)
    b0 = verts[p0] - verts[p1]
    if p0 == p1 or not np.any(b0):
        return None
    b1 = np.cross([1.0, 0, 0], b0)
    b2 = np.cross([0.0, 1, 0], b0)
    b1 = b1 if np.linalg.norm(b1) > np.linalg.norm(b2) else b2
    b1 = b1 / np.linalg.norm(b1)
    p2 = _maxdir(verts, b1)
    if p2 in (p0, p1):
        p2 = _maxdir(verts, -b1)
    if p2 in (p0, p1):
        return None
    b1 = verts[p2] - verts[p0]
    b2 = np.cross(b1, b0)
    p3 = _maxdir(verts, b2)
    if p3 in (p0, p1, p2):
        p3 = _maxdir(verts, -b2)
    if p3 in (p0, p1, p2):
        return None
    if np.dot(verts[p3] - verts[p0],
              np.cross(verts[p1] - verts[p0], verts[p2] - verts[p0])) < 0:
        p2, p3 = p3, p2
    return p0, p1, p2, p3


def _above(verts, t, p, eps):
    n = _tri_normal(verts[t[0]], verts[t[1]], verts[t[2]])
    return np.dot(n, p - verts[t[0]]) > eps


def calchull(verts: np.ndarray, vlimit: int = 0):
    """Returns (reordered_verts, tris) with used hull verts swapped to the
    front exactly like the reference (hull.h:415-420); tris index into the
    reordered array.  The full reordered vertex set is returned because the
    reference keeps all verts in Shape.verts (physmodel.h:453-456)."""
    # float32 matches the reference arithmetic; greedy vertex selection can
    # tie-break differently in higher precision.
    verts = np.array(verts, dtype=np.float32, copy=True)
    count = len(verts)
    if count < 4:
        return verts, np.zeros((0, 3), np.int32)
    if vlimit == 0:
        vlimit = 1_000_000_000
    bmin, bmax = verts.min(0), verts.max(0)
    epsilon = float(np.linalg.norm(bmax - bmin)) * 0.001

    sim = _find_simplex(verts)
    if sim is None:
        return verts, np.zeros((0, 3), np.int32)
    p = list(sim)
    center = verts[p].mean(0)
    isextreme = np.zeros(count, bool)
    isextreme[p] = True

    tris = [
        _Tri(p[2], p[3], p[1], 0, (2, 3, 1)),
        _Tri(p[3], p[2], p[0], 1, (3, 2, 0)),
        _Tri(p[0], p[1], p[3], 2, (0, 1, 3)),
        _Tri(p[1], p[0], p[2], 3, (1, 0, 2)),
    ]
    for t in tris:
        n = _tri_normal(verts[t.v[0]], verts[t.v[1]], verts[t.v[2]])
        t.vmax = _maxdir(verts, n)
        t.rise = float(np.dot(n, verts[t.vmax] - verts[t.v[0]]))

    vlimit -= 4
    while vlimit > 0:
        # extrudable: max rise
        te = max(range(len(tris)), key=lambda i: tris[i].rise)
        if tris[te].rise <= epsilon:
            break
        v = tris[te].vmax
        assert not isextreme[v]
        isextreme[v] = True
        j = len(tris)
        while j > 0:
            j -= 1
            if tris[j].dead():
                continue
            if _above(verts, tris[j].v, verts[v], 0.01 * epsilon):
                _extrude(tris, j, v)
        # fix degenerate flipped/skinny tris
        j = len(tris)
        while j > 0:
            j -= 1
            if tris[j].dead():
                continue
            if v not in tris[j].v:
                break
            nt = tris[j].v
            skinny = np.linalg.norm(
                np.cross(verts[nt[1]] - verts[nt[0]], verts[nt[2]] - verts[nt[1]])
            ) < epsilon * epsilon * 0.1
            if _above(verts, nt, center, 0.01 * epsilon) or skinny:
                nb = tris[j].n[0]
                _extrude(tris, nb, v)
                j = len(tris)
        # recompute vmax for new tris
        j = len(tris)
        while j > 0:
            j -= 1
            t = tris[j]
            if t.dead():
                continue
            if t.vmax >= 0:
                break
            n = _tri_normal(verts[t.v[0]], verts[t.v[1]], verts[t.v[2]])
            t.vmax = _maxdir(verts, n)
            if isextreme[t.vmax]:
                t.vmax = -1
            else:
                t.rise = float(np.dot(n, verts[t.vmax] - verts[t.v[0]]))
        _compress(tris)
        vlimit -= 1

    ts = np.asarray([t.v for t in tris if not t.dead()], dtype=np.int32)
    # swap used verts to the front, remap tris (hull.h:415-420)
    used = np.zeros(count, np.int64)
    for t in ts.reshape(-1):
        used[t] += 1
    vmap = np.full(count, -1, np.int64)
    n = 0
    for i in range(count):
        if used[i]:
            vmap[i] = n
            verts[[vmap[i], i]] = verts[[i, vmap[i]]]
            n += 1
    ts = vmap[ts].astype(np.int32)
    return verts, ts
