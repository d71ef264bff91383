"""Offline hand-model bake: JSON control cages -> static device arrays.

Replicates the reference model construction pipeline exactly once at load
time (PhysModel ctor, include/physmodel.h:444-475 + LoadHandModel,
include/handtrack.h:347-366):

    controlcages --2x Catmull-Clark--> subdiv verts --calchull(48)--> hull
    -> RigidBody (COM-centred verts, volume inertia) -> per-tri planes
    -> collision-vert shrink hack + ignore-pair list

Everything dynamic-shape or branchy happens here on the host; the output
`HandModelArrays` holds fixed-shape NumPy arrays, and `from_numpy_model`
places them on a device as the `HandModel` the tracker consumes.  The NumPy
bake is the JAX package's, kept as a copy so the port stands alone.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..geometry.hull import calchull
from ..geometry.solids import center_of_mass, inertia, tri_planes
from ..geometry.subdiv import catmull_clark

# The 8 model landmarks (handtrack.h:76-81): 3 palm points on bone 1 + 5 tips.
FEATURE_BONES = np.array([1, 1, 1, 4, 7, 10, 13, 16], np.int32)
FEATURE_OFFSETS = np.array([
    [0, 0, 0], [-0.03, 0, -0.03], [0.03, 0, -0.03],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
], np.float32)


@dataclasses.dataclass
class HandModelArrays:
    """Static hand-model geometry, padded to fixed shapes.

    All arrays are NumPy on the host; `from_numpy_model` places them on a
    device. n_bodies=17, n_joints=16 for the hand.
    """
    start_pose: np.ndarray        # (B, 7) physics-frame start pose (pos=rig+com)
    com: np.ndarray               # (B, 3) rig->physics origin offset
    mass: np.ndarray              # (B,)
    massinv: np.ndarray           # (B,)
    tensorinv_massless: np.ndarray  # (B, 3, 3) local inverse inertia (unit mass)
    verts: np.ndarray             # (B, V, 3) collision/support verts (COM frame, shrunk)
    vert_mask: np.ndarray         # (B, V) bool
    planes: np.ndarray            # (B, P, 4) hull planes (COM frame, unshrunk)
    plane_mask: np.ndarray        # (B, P) bool
    radius: np.ndarray            # (B,)
    radius_inner: np.ndarray      # (B,)
    damping: np.ndarray           # (B,)
    gravscale: np.ndarray         # (B,)
    joint_rbi0: np.ndarray        # (J,)
    joint_rbi1: np.ndarray        # (J,)
    joint_p0: np.ndarray          # (J, 3)  COM-adjusted attachment on rbi0
    joint_p1: np.ndarray          # (J, 3)  COM-adjusted attachment on rbi1
    joint_rangemin: np.ndarray    # (J, 3) degrees
    joint_rangemax: np.ndarray    # (J, 3) degrees
    joint_frame: np.ndarray       # (J, 4)
    collide_pairs: np.ndarray     # (C, 2) static non-ignored body pairs


    def fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def _build_ignore_pairs(rbi0, rbi1, n_bodies):
    """physmodel.h:260-277 build_ignore_lists + handtrack.h:354-357 thumb hack
    + handtrack.h:408-415 (bone 2 ignores everything, applied on first
    HandModelEnhancements call and therefore static in practice)."""
    ignore = set()

    def add(a, b):
        ignore.add((min(a, b), max(a, b)))

    joints = list(zip(rbi0, rbi1))
    for a, b in joints:
        add(a, b)
    for a0, a1 in joints:
        for b0, b1 in joints:
            if a0 == b0 and a1 != b1:      # siblings
                add(a1, b1)
            if a1 == b0:                   # grandparents
                add(a0, b1)
    for i in (7, 10, 13, 16):              # thumb-base pushes fingers out
        add(i, 2)
    for i in range(n_bodies):              # bone 2 (thumb base) ignores all
        if i != 2:
            add(2, i)
    pairs = [(i, j) for i in range(n_bodies) for j in range(i + 1, n_bodies)
             if (i, j) not in ignore]
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def bake_hand_model(json_path: str, pad_verts: int = 48, pad_planes: int = 96,
                    shrink_hack: bool = True) -> HandModelArrays:
    js = json.load(open(json_path))
    cages = js["controlcages"]
    joints = js["joints"]

    rbi0 = np.asarray([j["rbi0"] for j in joints], np.int32)
    rbi1 = np.asarray([j["rbi1"] for j in joints], np.int32)
    jp0 = np.asarray([j["p0"] for j in joints], np.float64)
    jp1 = np.asarray([j["p1"] for j in joints], np.float64)

    n_bodies = len(cages)
    verts_l, vmask_l, planes_l, pmask_l = [], [], [], []
    start_positions = np.zeros((n_bodies, 3))
    coms = np.zeros((n_bodies, 3))
    tensorinv = np.zeros((n_bodies, 3, 3))
    radius = np.zeros(n_bodies)
    radius_inner = np.zeros(n_bodies)

    rig_positions = np.zeros((n_bodies, 3))  # PositionUser of each body

    for i, cage in enumerate(cages):
        v, f = np.asarray(cage["verts"], np.float64), cage["faces"]
        v, f = catmull_clark(v, f)
        v, f = catmull_clark(v, f)
        hv, tris = calchull(v, 48)

        # rig-space chain position (physmodel.h:455): parent user-pos + p0 - p1
        if i == 0:
            pos = np.zeros(3)
        else:
            j = i - 1  # joint j attaches body rbi1[j]==i
            pos = rig_positions[rbi0[j]] + jp0[j] - jp1[j]
        rig_positions[i] = pos

        com = center_of_mass(hv, tris)
        hv = hv - com  # all verts shifted into COM frame (physics.h:159-161)
        coms[i] = com
        start_positions[i] = pos + com
        tensor = inertia(hv, tris, np.zeros(3))
        tensorinv[i] = np.linalg.inv(tensor)
        radius[i] = np.linalg.norm(hv, axis=1).max()

        pl = tri_planes(hv, tris)
        radius_inner[i] = -pl[:, 3].max()

        used = np.unique(tris.reshape(-1))
        hull_only = hv[used]
        if shrink_hack and i >= 2:  # handtrack.h:350-352 collision shrink
            hull_only = hull_only * np.array([0.7, 0.7, 0.9])

        assert len(hull_only) <= pad_verts, f"bone {i}: {len(hull_only)} verts"
        assert len(pl) <= pad_planes, f"bone {i}: {len(pl)} planes"
        vpad = np.zeros((pad_verts, 3))
        vpad[: len(hull_only)] = hull_only
        vm = np.zeros(pad_verts, bool)
        vm[: len(hull_only)] = True
        # padded planes get w=+inf surrogate so they never win mostabove/maxdir;
        # use a large negative dot instead: normal 0, w very negative.
        ppad = np.zeros((pad_planes, 4))
        ppad[:, 3] = -1e9  # dot(plane,(v,1)) = -1e9 for padding -> never max
        ppad[: len(pl)] = pl
        pm = np.zeros(pad_planes, bool)
        pm[: len(pl)] = True

        verts_l.append(vpad)
        vmask_l.append(vm)
        planes_l.append(ppad)
        pmask_l.append(pm)

    mass = np.ones(n_bodies)
    mass[0], mass[1] = 3.0, 5.0  # rbscalemass (physmodel.h:460-461)

    start_pose = np.concatenate(
        [start_positions, np.tile(np.array([0.0, 0, 0, 1]), (n_bodies, 1))], axis=1)

    return HandModelArrays(
        start_pose=start_pose.astype(np.float32),
        com=coms.astype(np.float32),
        mass=mass.astype(np.float32),
        massinv=(1.0 / mass).astype(np.float32),
        tensorinv_massless=tensorinv.astype(np.float32),
        verts=np.stack(verts_l).astype(np.float32),
        vert_mask=np.stack(vmask_l),
        planes=np.stack(planes_l).astype(np.float32),
        plane_mask=np.stack(pmask_l),
        radius=radius.astype(np.float32),
        radius_inner=radius_inner.astype(np.float32),
        damping=np.full(n_bodies, 0.8, np.float32),
        gravscale=np.zeros(n_bodies, np.float32),
        joint_rbi0=rbi0,
        joint_rbi1=rbi1,
        joint_p0=(jp0 - coms[rbi0]).astype(np.float32),
        joint_p1=(jp1 - coms[rbi1]).astype(np.float32),
        joint_rangemin=np.asarray([j["rangemin"] for j in joints], np.float32),
        joint_rangemax=np.asarray([j["rangemax"] for j in joints], np.float32),
        joint_frame=np.asarray([j["jointframe"] for j in joints], np.float32),
        collide_pairs=_build_ignore_pairs(rbi0, rbi1, n_bodies),
    )


FIELDS = tuple(f.name for f in dataclasses.fields(HandModelArrays))


class HandModel:
    """The baked model on a device: one tensor attribute per HandModelArrays
    field (float32, int64 body ids, bool masks), plus `np`, the host copy of
    every field, for the static indexing (joint topology, collide pairs) that
    the row factories resolve on the host."""

    def __init__(self, fields: dict, device):
        import torch
        self.device = torch.device(device)
        self.np = {k: np.array(fields[k]) for k in FIELDS}
        for k, v in self.np.items():
            if v.dtype == bool:
                t = torch.from_numpy(v.copy())
            elif np.issubdtype(v.dtype, np.integer):
                t = torch.from_numpy(v.astype(np.int64))
            else:
                t = torch.from_numpy(v.astype(np.float32))
            setattr(self, k, t.to(self.device))

    @property
    def n_bodies(self) -> int:
        return int(self.np["start_pose"].shape[0])

    def to(self, device) -> "HandModel":
        """This model on `device`: the same host copy, each tensor moved
        (`self` when it is there already)."""
        import torch
        device = torch.device(device)
        if device == self.device:
            return self
        out = object.__new__(HandModel)
        out.device, out.np = device, self.np
        for k in FIELDS:
            setattr(out, k, getattr(self, k).to(device))
        return out


def from_numpy_model(fields: dict, device=None) -> HandModel:
    """The carry-across function: a baked model as NumPy arrays (this
    package's HandModelArrays.fields(), or the JAX package's baked arrays
    converted with np.asarray) -> the port's HandModel on `device` (the
    card unless the caller asks for "cpu"; device.resolve_device)."""
    from ..device import resolve_device
    device = resolve_device(device)
    if isinstance(fields, HandModelArrays):
        fields = fields.fields()
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"model fields missing: {missing}")
    return HandModel(fields, device)
