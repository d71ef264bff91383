"""Display meshes: subdivided bone geometry and vanity-bone rendering data
(the port's counterpart of hand_tracking_samples_tpu.model.meshes, the
reference's render-mesh path: third_party/mesh.h, PhysModel's
meshes/sdmeshes, handtrack.h:592-616 vanity bones), for the offline
visualization story: posed meshes exported as OBJ instead of drawn into a
GL window.

Host-side NumPy on tiny meshes.  The rotations compute what the JAX
module's eager quaternion ops compute on the CPU: each cross product
contracted as XLA's CPU build runs jnp.cross (a*b - c*d as one fused
multiply-add, fma(a, b, -(c*d))), the rest one rounding an operation, so
the posed vertices and the OBJ text are the JAX module's bytes.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..geometry.subdiv import catmull_clark, fan_triangulate


def load_display_meshes(json_path: str, subdiv: int = 2):
    """Load control cages (model_hand.json or vanity_bones.json) and apply
    Catmull-Clark like dosubdiv / load_bone_meshes (physmodel.h:255-259,
    handtrack.h:599-616).  Returns a list of (verts (V, 3) float32,
    tris (T, 3) int32)."""
    with open(json_path) as f:
        js = json.load(f)
    cages = js["controlcages"] if isinstance(js, dict) else js
    out = []
    for cage in cages:
        v, f = np.asarray(cage["verts"], np.float64), cage["faces"]
        for _ in range(subdiv):
            v, f = catmull_clark(v, f)
        out.append((v.astype(np.float32), fan_triangulate(f)))
    return out


def smooth_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (MeshSmoothish, mesh.h:179)."""
    n = np.zeros_like(verts)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(b - a, c - b)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    length = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(length, 1e-20)


def _fma(a, b, c):
    """float32(a*b + c) rounded once: the product is exact in float64, the
    float64 sum is rounded to odd (its exact error by TwoSum), so the last
    rounding to float32 is the only one that counts."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = np.ascontiguousarray(p + c)
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(np.int64)
    return np.where(err != 0, bits | 1, bits).view(np.float64) \
        .astype(np.float32)


def _cross(a, b):
    """jnp.cross over the last axis as the JAX CPU build contracts it."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
                     _fma(ax, by, -(ay * bx))], axis=-1)


def _qrot(q, v):
    """maths.quat.qrot (v + w t + qv x t, t = 2 qv x v), float32."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    qv = np.broadcast_to(q[..., :3], v.shape)
    w = q[..., 3:4]
    t = np.float32(2.0) * _cross(qv, v)
    return (v + w * t) + _cross(qv, t)


def _qmul(a, b):
    """Hamilton product a*b (x, y, z, w), each term rounded in turn."""
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], axis=-1)


def pose_mesh(verts: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Transform mesh verts by a (7,) pose (rig/user space)."""
    pose = np.asarray(pose, np.float32)
    return _qrot(pose[3:7], verts) + pose[:3]


def export_obj(path: str, meshes, poses_user=None):
    """Write posed bone meshes as one OBJ (an offline viz artifact).

    meshes: list of (verts, tris); poses_user: (n, 7) user-frame poses
    (model.hand.get_pose_user of one track) or None for the rest pose."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        off = 1
        for i, (v, t) in enumerate(meshes):
            vv = pose_mesh(v, np.asarray(poses_user[i])) \
                if poses_user is not None else v
            f.write(f"o bone_{i}\n")
            for p in vv:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for tri in t:
                f.write(f"f {tri[0]+off} {tri[1]+off} {tri[2]+off}\n")
            off += len(vv)


def skin_dualquat(verts, weights, bone_ids, poses):
    """Dual-quaternion skinning (mesh.h:69): blend bone transforms per
    vertex.  verts (V, 3), weights (V, K), bone_ids (V, K) int, poses
    (B, 7).  Returns skinned verts (V, 3) float32."""
    poses = np.asarray(poses, np.float32)
    weights = np.asarray(weights, np.float32)
    q = poses[:, 3:7]                       # (B, 4) real part
    t = poses[:, :3]
    # dual part: 0.5 * (t, 0) * q
    tq = np.concatenate([t, np.zeros_like(t[:, :1])], -1)
    dual = np.float32(0.5) * _qmul(tq, q)
    qv = q[bone_ids]                        # (V, K, 4)
    dv = dual[bone_ids]
    # hemispherize against the first influence
    sign = np.sign(np.sum(qv * qv[:, :1], axis=-1, keepdims=True))
    sign = np.where(sign == 0, np.float32(1.0), sign).astype(np.float32)
    qb = np.sum(qv * sign * weights[..., None], axis=1)
    db = np.sum(dv * sign * weights[..., None], axis=1)
    norm = np.linalg.norm(qb, axis=-1, keepdims=True).astype(np.float32)
    qb = qb / norm
    db = db / norm
    # translation = 2 * dual * conj(real)
    conj = qb * np.asarray([-1.0, -1.0, -1.0, 1.0], np.float32)
    tb = np.float32(2.0) * _qmul(db, conj)[:, :3]
    return _qrot(qb, verts) + tb
