"""Heatmap decode (include/misc_image.h:298-399), the port's counterpart of
the decode half of hand_tracking_samples_tpu.imaging.heatmaps, over any
leading batch dims: peaks by first strict maximum (torch.argmax returns the
first maximal index, as jnp.argmax does), weighted sub-pixel peaks and peak
volumes."""
from __future__ import annotations

import torch


def image_find_max(img):
    """ImageFindMax (misc_image.h:298): first strict maximum in raster
    order.  img (..., H, W) -> (..., 2) int64 (x, y)."""
    W = img.shape[-1]
    idx = torch.argmax(img.flatten(-2), dim=-1)
    return torch.stack([idx % W, idx // W], dim=-1)


def _window(H, W, p, r, device):
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    px, py = p[..., 0, None, None], p[..., 1, None, None]
    return (xs, ys, (xs >= torch.clamp(px - r, min=0))
            & (xs < torch.clamp(px + r + 1, max=W))
            & (ys >= torch.clamp(py - r, min=0))
            & (ys < torch.clamp(py + r + 1, max=H)))


def peak_subpixel(img, p, r: int = 1):
    """PeakSubPixel (misc_image.h:313-326): weighted centroid over the
    (2r+1)^2 window clamped to the image.  img (..., H, W), p (..., 2)
    int -> (..., 2) float32."""
    H, W = img.shape[-2:]
    xs, ys, inwin = _window(H, W, p, r, img.device)
    w = torch.where(inwin, img.to(torch.float32), torch.zeros(()))
    wsum = w.sum((-2, -1))
    cx = (w * xs).sum((-2, -1)) / torch.clamp(wsum, min=1e-30)
    cy = (w * ys).sum((-2, -1)) / torch.clamp(wsum, min=1e-30)
    return torch.where((wsum == 0)[..., None], p.to(torch.float32),
                       torch.stack([cx, cy], dim=-1))


def peak_volume(img, pf, r: int = 1):
    """PeakVolume (misc_image.h:328-336): the sum over the window around
    round(pf)."""
    H, W = img.shape[-2:]
    p = (pf + 0.5).to(torch.int64)
    _, _, inwin = _window(H, W, p, r, img.device)
    return torch.where(inwin, img.to(torch.float32),
                       torch.zeros(())).sum((-2, -1))


def peaks_1d(img):
    """Peaks1D (misc_image.h:390-399): per-row argmax and 1-D weighted
    sub-pixel peak, normalised by (width-1).  img (..., R, W) -> (..., R)."""
    W = img.shape[-1]
    p = torch.argmax(img, dim=-1, keepdim=True)
    x = torch.arange(W, device=img.device)
    inwin = (x >= torch.clamp(p - 1, min=0)) & (x < torch.clamp(p + 2,
                                                                 max=W))
    w = torch.where(inwin, img.to(torch.float32), torch.zeros(()))
    wsum = w.sum(-1)
    v = (w * x).sum(-1) / torch.clamp(wsum, min=1e-30)
    return torch.where(wsum == 0, p[..., 0].to(torch.float32), v) / (W - 1)
