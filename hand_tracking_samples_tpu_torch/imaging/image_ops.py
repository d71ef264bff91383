"""Depth-image operations (include/misc_image.h), the port's counterpart of
hand_tracking_samples_tpu.imaging.image_ops: the cloud functions of the
tracking frame, what the segmentation reads, and the image pyramid,
resampling, mesh and clip operations of misc_image.h.  Images carry the
tracks first: (T, H, W).  Depth enters as an int16 tensor holding the u16 raster
bit for bit (ops.cloud_kernel.depth_tensor); `depth_u16` widens it to int32
values 0..65535, the form the integer image operations run on."""
from __future__ import annotations

import numpy as np
import torch

from ..maths import fma as fq
from ..maths.fma import fma
from ..ops.cloud_kernel import (cloud_from_depth_planes, depth_tensor,
                                planes_points)

__all__ = ["cloud_from_depth", "cloud_from_depth_planes", "depth_tensor",
           "depth_u16", "downsample_min", "downsample_max", "downsample_avg",
           "downsample_fst", "upsample", "sample", "depth_mesh",
           "image_clip", "distance_transform", "threshold",
           "gather_pixels_u16", "sample_d", "point_cloud",
           "plane_split_masks", "mirror_points", "mirror_plane_split",
           "voxel_buckets", "voxel_subsample", "compact_points",
           "compact_planes"]


def depth_u16(depth):
    """(T, H, W) int16 holding u16 bits -> int32 values 0..65535."""
    return depth.to(torch.int32) & 0xFFFF


def cloud_from_depth(depth, cam, range_lo, range_hi, frac: int,
                     budget: int):
    """PointCloud + takesubsample + compaction (misc_image.h:409-417,
    handtrack.h:679): returns (points (T, budget, 3), mask (T, budget)).
    Every frac-th valid pixel in raster order is kept; when more than
    `budget` are kept, slot s takes kept point (s*K)//budget."""
    return planes_points(cloud_from_depth_planes(depth, cam, range_lo,
                                                 range_hi, frac, budget))


def downsample_min(img):
    """DownSampleMin (misc_image.h:85): 2x2 minimum, (T, H, W) ->
    (T, H/2, W/2)."""
    T, h, w = img.shape
    return img.reshape(T, h // 2, 2, w // 2, 2).amin(dim=(2, 4))


def downsample_max(img):
    """2x2 maximum, (T, H, W) -> (T, H/2, W/2)."""
    T, h, w = img.shape
    return img.reshape(T, h // 2, 2, w // 2, 2).amax(dim=(2, 4))


def downsample_avg(img):
    """DownSampleAvg (misc_image.h:91): pairwise (a+b)/2 applied as
    f(f(a, b), f(c, d)), with integer (floor) division for integer
    rasters.  Integer sums run in int32, as C promotes them (the JAX
    package sums in the raster's dtype, which wraps above 65535 for u16)."""
    T, h, w = img.shape
    x = img.reshape(T, h // 2, 2, w // 2, 2)
    if img.is_floating_point():
        ab = (x[:, :, 0, :, 0] + x[:, :, 0, :, 1]) / 2
        cd = (x[:, :, 1, :, 0] + x[:, :, 1, :, 1]) / 2
        return (ab + cd) / 2
    x = x.to(torch.int32)

    def half(a, b):
        return torch.div(a + b, 2, rounding_mode="floor")
    return half(half(x[:, :, 0, :, 0], x[:, :, 0, :, 1]),
                half(x[:, :, 1, :, 0], x[:, :, 1, :, 1])).to(img.dtype)


def downsample_fst(img):
    """The top-left sample of each 2x2 cell."""
    return img[:, ::2, ::2]


def upsample(img):
    """Each pixel to a 2x2 cell."""
    return img.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _cam_pose(cam, like):
    """A DCamera's (7,) pose or a TrackCamera's (T, 7) one, as (T|1, 7)."""
    p = torch.as_tensor(cam.pose, dtype=torch.float32, device=like.device)
    return p.reshape(-1, 7)


def sample(src, src_cam, dst_cam, background=0):
    """Sample (misc_image.h:143-150): plain point-resample of (T, H, W)
    under a new camera (no depth-plane correction), for IR and greyscale
    channels.  dst_cam a DCamera or a TrackCamera -> (T, h, w), src's
    dtype."""
    from ..maths.pose import pose_apply
    T = src.shape[0]
    W, H = dst_cam.dim
    dev = src.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    p = torch.stack([xs, ys], dim=-1).expand(T, H, W, 2)
    rays = dst_cam.deprojectz(p, torch.ones((T, H, W), device=dev))
    pose = _cam_pose(dst_cam, src)[:, None, None, :]
    pp = src_cam.projectz(pose_apply(pose, rays))
    ppi = pp.to(torch.int32)                       # C-cast truncation
    sw, sh = src_cam.dim
    inside = ((ppi[..., 0] >= 0) & (ppi[..., 0] <= sw - 1)
              & (ppi[..., 1] >= 0) & (ppi[..., 1] <= sh - 1))
    px = torch.clamp(ppi[..., 0], 0, sw - 1).long()
    py = torch.clamp(ppi[..., 1], 0, sh - 1).long()
    sampled = torch.gather(src.reshape(T, -1), 1,
                           (py * sw + px).reshape(T, -1)).reshape(T, H, W)
    return torch.where(inside, sampled,
                       torch.full((), background, dtype=src.dtype,
                                  device=dev))


def depth_mesh(depth, cam, range_lo, range_hi, gaplimit=float("inf"),
               skip: int = 1):
    """DepthMesh (misc_image.h:419-451) with static shapes: one vertex per
    (skip x skip) cell (the cell's top-left pixel), quads triangulated
    where all corners are in range and the depth gaps stay within
    `gaplimit`.  depth (T, H, W) u16 values -> (verts (T, h*w, 3),
    vert_mask (T, h*w), tris (2*(h-1)*(w-1), 3) int32, tri_mask (T, ntri))."""
    d = depth_u16(depth)[:, ::skip, ::skip].to(torch.float32) \
        * float(np.float32(cam.depth_scale))
    T, h, w = d.shape
    dev = d.device
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) * skip,
        torch.arange(w, dtype=torch.float32, device=dev) * skip,
        indexing="ij")
    verts = cam.deprojectz(torch.stack([xs, ys], -1).expand(T, h, w, 2),
                           d).reshape(T, -1, 3)
    vflat = ((d >= range_lo) & (d < range_hi)).reshape(T, -1)
    vid = torch.arange(h * w, device=dev).reshape(h, w)
    a = vid[:-1, :-1].reshape(-1)
    b = vid[1:, :-1].reshape(-1)
    c = vid[1:, 1:].reshape(-1)
    e = vid[:-1, 1:].reshape(-1)
    z = verts[..., 2]

    def ok(i, j):
        return vflat[:, i] & vflat[:, j] & ((z[:, i] - z[:, j]).abs()
                                            <= gaplimit)
    tris = torch.cat([torch.stack([a, b, c], -1),
                      torch.stack([c, e, a], -1)]).to(torch.int32)
    tmask = torch.cat([ok(a, b) & ok(b, c) & ok(c, a),
                       ok(c, e) & ok(e, a) & ok(a, c)], dim=1)
    return verts, vflat, tris, tmask


def image_clip(depth, cam, plane, val):
    """ImageClip (misc_image.h:454-460): pixels of (T, H, W) under `plane`
    (a, b, c, d) set to val."""
    T, h, w = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = cam.deprojectz(torch.stack([xs, ys], -1).expand(T, h, w, 2),
                         depth_u16(depth).to(torch.float32)
                         * float(np.float32(cam.depth_scale)))
    pl = torch.as_tensor(plane, dtype=torch.float32, device=dev)
    dval = (pts * pl[:3]).sum(-1) + pl[3]
    return torch.where(dval < 0, torch.full((), val, dtype=depth.dtype,
                                            device=dev), depth)


def _minplus_row(row):
    """r[x] = min_{k<=x} (row[k] + (x-k)) over the last axis."""
    idx = torch.arange(row.shape[-1], dtype=row.dtype, device=row.device)
    return torch.cummin(row - idx, dim=-1).values + idx


def _minplus_row_rev(row):
    """r[x] = min_{k>=x} (row[k] + (k-x)) over the last axis."""
    idx = torch.arange(row.shape[-1], dtype=row.dtype, device=row.device)
    b = (row + idx).flip(-1)
    return torch.cummin(b, dim=-1).values.flip(-1) - idx


def distance_transform(binary255):
    """misc_image.h:183-195: the Manhattan distance transform of a 0/255
    mask, clamped to 255, as two separable 1-D min-plus passes (exactly the
    reference's two raster passes).  (T, H, W) -> (T, H, W) int32."""
    img = binary255.to(torch.int32)
    col = img.transpose(1, 2)
    col = torch.minimum(_minplus_row(col), _minplus_row_rev(col))
    col = col.transpose(1, 2)
    out = torch.minimum(_minplus_row(col), _minplus_row_rev(col))
    return torch.clamp(out, max=255)


def threshold(depth, lo=None, hi=None):
    """Threshold (misc_image.h:179): predicate -> 0/255 mask (int32)."""
    m = torch.ones_like(depth, dtype=torch.bool)
    if lo is not None:
        m &= depth >= lo
    if hi is not None:
        m &= depth < hi
    return torch.where(m, 255, 0).to(torch.int32)


def gather_pixels_u16(img, r, c):
    """img (T, H, W), r/c (T, K) clipped row/col indices -> (T, K) float32
    pixel values (the JAX package picks them with exact one-hot matmuls;
    a gather gives the same values)."""
    T, H, W = img.shape
    flat = img.reshape(T, H * W)
    return torch.gather(flat, 1, r * W + c).to(torch.float32)


def sample_d(src, src_cam, dst_cam, background: int):
    """SampleD (misc_image.h:154-162): resample a depth image (T, H, W) int32
    under the per-track cameras dst_cam (imaging.camera.TrackCamera),
    correcting sampled depth to the destination image plane.  Returns
    (T, h, w) int32 holding u16 values.  The virtual cameras sit at the
    origin (their poses rotate only), as the segmentation makes them."""
    T = src.shape[0]
    W, H = dst_cam.dim
    dev = src.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    p = torch.stack([xs, ys], dim=-1).expand(T, H, W, 2)
    rays = dst_cam.deprojectz(p, torch.ones((T, H, W), device=dev))
    world = fq.qrot_z1(dst_cam.pose[:, None, None, 3:7].expand(T, H, W, 4),
                       rays[..., 0], rays[..., 1])  # the camera sits at 0
    pp = src_cam.projectz(world)
    ppi = pp.to(torch.int32)                       # C-cast truncation
    sw, sh = src_cam.dim
    inside = ((ppi[..., 0] >= 0) & (ppi[..., 0] <= sw - 1)
              & (ppi[..., 1] >= 0) & (ppi[..., 1] <= sh - 1))
    px = torch.clamp(ppi[..., 0], 0, sw - 1).long()
    py = torch.clamp(ppi[..., 1], 0, sh - 1).long()
    sampled = gather_pixels_u16(src, py.reshape(T, -1),
                                px.reshape(T, -1)).reshape(T, H, W)
    ppdir = fq.qrot(dst_cam.pose[:, 3:7], dst_cam.deprojectz(
        dst_cam.principal, torch.ones(T, device=dev)))          # (T, 3)
    deproj = src_cam.deprojectz_folded(ppi.to(torch.float32), sampled)
    pd = ppdir[:, None, None, :]
    corrected = fma(pd[..., 2], deproj[..., 2],
                    fma(pd[..., 1], deproj[..., 1],
                        pd[..., 0] * deproj[..., 0]))
    return torch.where(inside, corrected.to(torch.int32),
                       torch.full_like(px, int(background)).to(torch.int32))


def point_cloud(depth, cam, range_lo, range_hi):
    """PointCloud (misc_image.h:409-417) of every pixel, with a validity
    mask: depth (T, H, W) int16 (u16 bits) -> points (T, H*W, 3), mask
    (T, H*W).  The deprojection multiplies by the float32 reciprocal of
    the focal length, as the JAX CPU build runs it with the camera a
    constant (DCamera.deprojectz_folded)."""
    f = lambda x: float(np.float32(x))
    d = depth_u16(depth).to(torch.float32) * f(cam.depth_scale)
    T, h, w = d.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=d.device),
        torch.arange(w, dtype=torch.float32, device=d.device),
        indexing="ij")
    pts = cam.deprojectz_folded(torch.stack([xs, ys], -1).expand(T, h, w, 2),
                                d)
    mask = (d >= f(range_lo)) & (d < f(range_hi))
    return pts.reshape(T, h * w, 3), mask.reshape(T, h * w)


def _plane_value(points, plane):
    """points @ plane[:3] + plane[3] as the JAX CPU build computes it: the
    dot contracted as fma(z, c, fma(y, b, x*a)), then the offset added."""
    a, b, c, d = (float(np.float32(v)) for v in plane)
    return fma(points[..., 2], c, fma(points[..., 1], b,
                                      points[..., 0] * a)) + d


COPLANAR_EPS = 0.02                     # PlaneSplit's band, misc_image.h:462


def plane_split_masks(points, plane):
    """PlaneSplit (misc_image.h:462-473) as masks (under, coplanar, over)
    of points (..., 3); plane (a, b, c, d) floats."""
    pd = _plane_value(points, plane)
    eps = float(np.float32(COPLANAR_EPS))
    return pd <= -eps, (pd > -eps) & (pd <= eps), pd > eps


def _deprojection_factors(points, cam):
    """u (..., 3) with points = u * z as DCamera.deprojectz_folded makes
    them: (fl((px - cx) * rfx), fl((py - cy) * rfy), 1), the pixel found
    again from x / z (exact: |px - cx| < 2^20); u is 0 where z is 0, which
    does not change u * z."""
    x, y, z = (points[..., k].double() for k in range(3))
    ok = z > 0
    safe = torch.where(ok, z, torch.ones_like(z))
    u = []
    for v, c, f in ((x, cam.principal[0], cam.focal[0]),
                    (y, cam.principal[1], cam.focal[1])):
        r = float(np.float32(1.0) / np.float32(f))
        pix = torch.round(v / (safe * r) + c).float()
        u.append(torch.where(ok, (pix - c) * r, torch.zeros_like(pix)))
    return torch.stack([*u, torch.ones_like(u[0])], dim=-1)


def mirror_points(points, plane, cam=None):
    """Mirror (misc_image.h:474-479): points (..., 3) reflected across
    `plane`.  p - n*(2*pd) runs contracted as the JAX CPU build runs it:
    fma(-n, 2*pd, p) on stored points; with `cam`, the points are that
    camera's deprojection u*z (point_cloud, cloud_from_depth), which XLA
    recomputes inside the reflection and contracts as
    fma(u, z, -(n*(2*pd)))."""
    pd2 = 2.0 * _plane_value(points, plane)
    n = [float(np.float32(v)) for v in plane[:3]]
    if cam is None:
        out = [fma(-n[k], pd2, points[..., k]) for k in range(3)]
    else:
        u = _deprojection_factors(points, cam)
        out = [fma(u[..., k], points[..., 2], -(pd2 * n[k]))
               for k in range(3)]
    return torch.stack(out, dim=-1)


def mirror_plane_split(points, mask, plane, cam=None):
    """MirrorPlaneSplit (misc_image.h:480-485), the DS4 mirror rigs: points
    under the mirror plane are reflected back into the scene and the
    coplanar band is masked out.  points (T, N, 3), mask (T, N); cam: see
    mirror_points.  Returns (points, mask)."""
    under, coplanar, _ = plane_split_masks(points, plane)
    pts = torch.where(under[..., None], mirror_points(points, plane, cam),
                      points)
    return pts, mask & ~coplanar


VOXEL_HASH = (54851, 11909, 24781)      # physmodel.h:83
VOXEL_BUCKETS = 2048                    # the hash table's size, a power of 2


def voxel_buckets(points, mask, voxel_size: float):
    """The bucket sums and counts of voxel_subsample: (sums (T,
    VOXEL_BUCKETS, 3), counts (T, VOXEL_BUCKETS) int64) of the valid points
    (T, N, 3).

    The hash: floor(p / size) (XLA folds the constant division into a
    multiply by the float32 reciprocal) wraps to uint32 in the JAX
    package; the low bits of the int64 sum are the same, so the mask is
    taken at the end.  The sums: each bucket's points are added one by one
    in point order, as the JAX CPU build's scatter-add does, on either
    device (a stable sort groups the buckets, then one add per rank), so
    the sums are the same bits on the CPU and the card and from run to run;
    no atomics."""
    n_buckets = VOXEL_BUCKETS
    T, N, _ = points.shape
    dev = points.device
    rcp = float(np.float32(1.0) / np.float32(voxel_size))
    ipos = torch.floor(points * rcp).to(torch.int64)
    a, b, c = VOXEL_HASH
    h = (ipos[..., 0] * a + ipos[..., 1] * b + ipos[..., 2] * c) \
        & (n_buckets - 1)                                  # (T, N)
    key = torch.where(mask, h, torch.full_like(h, n_buckets))
    key, order = torch.sort(key, dim=1, stable=True)
    vals = torch.gather(points, 1, order[..., None].expand(T, N, 3))
    edges = torch.arange(n_buckets + 1, device=dev).expand(T, -1)
    starts = torch.searchsorted(key.contiguous(), edges.contiguous())
    cnts = starts[:, 1:] - starts[:, :-1]                  # (T, n_buckets)
    first = starts[:, :-1]
    sums = torch.zeros((T, n_buckets, 3), device=dev)
    zero = torch.zeros((), device=dev)
    for k in range(int(cnts.max()) if cnts.numel() else 0):
        idx = torch.clamp(first + k, max=N - 1)
        v = torch.gather(vals, 1, idx[..., None].expand(T, n_buckets, 3))
        sums = sums + torch.where((k < cnts)[..., None], v, zero)
    return sums, cnts


def voxel_subsample(points, mask, voxel_size: float, min_voxel_num: int):
    """voxelsubsample (physmodel.h:66-118): the valid points (T, N, 3)
    averaged per voxel of side voxel_size, voxels hashed into VOXEL_BUCKETS
    buckets by the reference's multiplicative hash (colliding voxels
    merge).  Returns (centroids (T, VOXEL_BUCKETS, 3), mask: bucket holds
    at least min_voxel_num points); voxel_buckets says how it sums."""
    sums, cnts = voxel_buckets(points, mask, voxel_size)
    cntf = cnts.to(torch.float32)
    out = sums / torch.clamp(cntf, min=1.0)[..., None]
    return out, cntf >= min_voxel_num


def compact_points(points, mask, budget: int):
    """Pack the valid points (T, N, 3) to the front in their order, fixed
    budget (points past it are dropped).  Returns (points (T, budget, 3),
    mask (T, budget))."""
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    order = order[:, :budget]
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    return pts, torch.gather(mask, 1, order)


def compact_planes(ph, keep, budget: int):
    """compact_points on the planes carrier: the kept lanes (keep (T, N)
    bool) of ph (T, 8, N) packed to the front of a (T, 8, budget) block in
    their order, mask row = slot validity, empty slots zero.  Kept lanes
    past the budget are dropped, as in the JAX package."""
    T, C, N = ph.shape
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    ok = keep & (rank < budget)
    src = ph.clone()
    src[:, 4] = keep.to(ph.dtype)
    out = torch.zeros((T, C, budget + 1), dtype=ph.dtype, device=ph.device)
    col = torch.where(ok, rank, torch.full_like(rank, budget))
    out.scatter_(2, col[:, None].expand(T, C, N), src * ok[:, None])
    return out[..., :budget]
