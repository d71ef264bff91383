"""The cloud half of include/misc_image.h's depth-image operations (the
port's counterpart of the cloud functions of
hand_tracking_samples_tpu.imaging.image_ops; the rest of that module is a
later slice).  Depth images are (T, H, W) int16 tensors holding u16 rasters
bit for bit (ops.cloud_kernel.depth_tensor)."""
from __future__ import annotations

from ..ops.cloud_kernel import (cloud_from_depth_planes, depth_tensor,
                                planes_points)

__all__ = ["cloud_from_depth", "cloud_from_depth_planes", "depth_tensor"]


def cloud_from_depth(depth, cam, range_lo, range_hi, frac: int,
                     budget: int):
    """PointCloud + takesubsample + compaction (misc_image.h:409-417,
    handtrack.h:679): returns (points (T, budget, 3), mask (T, budget)).
    Every frac-th valid pixel in raster order is kept; when more than
    `budget` are kept, slot s takes kept point (s*K)//budget."""
    return planes_points(cloud_from_depth_planes(depth, cam, range_lo,
                                                 range_hi, frac, budget))
