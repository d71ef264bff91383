"""Depth-image operations (include/misc_image.h), the port's counterpart of
hand_tracking_samples_tpu.imaging.image_ops: the cloud functions of the
tracking frame, what the segmentation reads, and the image pyramid,
resampling, mesh and clip operations of misc_image.h.  Images carry the
tracks first: (T, H, W).  Depth enters as an int16 tensor holding the u16 raster
bit for bit (ops.cloud_kernel.depth_tensor); `depth_u16` widens it to int32
values 0..65535, the form the integer image operations run on."""
from __future__ import annotations

import torch

from ..maths import fma as fq
from ..maths.fma import fma

__all__ = ["depth_u16", "downsample_min", "distance_transform", "threshold",
           "gather_pixels_u16", "sample_d", "compact_planes"]


def depth_u16(depth):
    """(T, H, W) int16 holding u16 bits -> int32 values 0..65535."""
    return depth.to(torch.int32) & 0xFFFF


def downsample_min(img):
    """DownSampleMin (misc_image.h:85): 2x2 minimum, (T, H, W) ->
    (T, H/2, W/2)."""
    T, h, w = img.shape
    return img.reshape(T, h // 2, 2, w // 2, 2).amin(dim=(2, 4))


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


COPLANAR_EPS = 0.02                     # PlaneSplit's band, misc_image.h:462


VOXEL_HASH = (54851, 11909, 24781)      # physmodel.h:83
VOXEL_BUCKETS = 2048                    # the hash table's size, a power of 2


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
