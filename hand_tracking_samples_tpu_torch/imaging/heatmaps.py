"""The heatmap codec (include/misc_image.h:241-399), the port's counterpart
of hand_tracking_samples_tpu.imaging.heatmaps, over any leading batch dims.

The label side renders uint8 Gaussian splats normalised to unit volume (sum
255 in byte space), byte for byte with the reference: the peak truncates
as C does, and the integer renormalisation divides int32 by int32 with
floor rounding, as `img*255 // sum` does.  The decode side finds peaks by
first strict maximum (torch.argmax returns the first maximal index, as
jnp.argmax does), weighted sub-pixel peaks and peak volumes."""
from __future__ import annotations

import numpy as np
import torch

from ..maths.libm import expf


def _to_grayscale(x):
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8).to(torch.int32)


def _gauss(d2, two_var: float):
    """exp(-d2 / two_var) as the JAX CPU build computes it in a jitted
    function: the division a multiply by the float32 reciprocal, its exp
    (maths.libm.expf)."""
    return expf(-d2 * float(np.float32(1.0) / np.float32(two_var)))


def _renormalise(img, dims):
    """img*255 // sum over dims where the sum is positive (int32)."""
    s = img.sum(dims, keepdim=True, dtype=torch.int32)
    return torch.where(s > 0, torch.div(img * 255, torch.clamp(s, min=1),
                                        rounding_mode="floor"), img)


def render_heatmap(peak, dim=(16, 16)):
    """RenderHeatMap (misc_image.h:259-270): a 5x5 Gaussian splat around
    the truncated peak, then integer volume normalisation to sum 255.
    peak (..., 2) float32 -> (..., H, W) uint8."""
    W, H = dim
    dev = peak.device
    hp = peak.to(torch.int32)[..., None, None, :]          # C truncation
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    inwin = ((xs >= torch.clamp(hp[..., 0] - 2, min=0))
             & (xs < torch.clamp(hp[..., 0] + 3, max=W))
             & (ys >= torch.clamp(hp[..., 1] - 2, min=0))
             & (ys < torch.clamp(hp[..., 1] + 3, max=H)))
    px, py = peak[..., 0, None, None], peak[..., 1, None, None]
    d2 = (px - xs) ** 2 + (py - ys) ** 2
    img = torch.where(inwin, _to_grayscale(_gauss(d2, 2.0 * 0.33)),
                      torch.zeros((), dtype=torch.int32, device=dev))
    return _renormalise(img, (-2, -1)).to(torch.uint8)


def render_heatmaps(peaks, dim=(16, 16)):
    """peaks (..., K, 2) -> (..., K, H, W) uint8."""
    return render_heatmap(peaks, dim)


def render_1d_heatmaps(values, width: int = 16):
    """Render1DHeatMaps (misc_image.h:279-295): one row per value, a
    Gaussian of std 0.5 around v*(width-1), row-normalised to sum 255 over
    the 5-tap window.  values (..., R) -> (..., R, width) uint8."""
    vv = (values * (width - 1))[..., None]
    x = torch.arange(width, device=values.device)
    iv = vv.to(torch.int32)
    inwin = (x >= torch.clamp(iv - 2, min=0)) & (x < torch.clamp(iv + 3,
                                                               max=width))
    r = torch.where(inwin, _to_grayscale(_gauss((x - vv) ** 2, 2.0 * 0.5)),
                    torch.zeros((), dtype=torch.int32, device=values.device))
    s = r.sum(-1, keepdim=True, dtype=torch.int32)
    r = torch.where((s > 0) & inwin,
                    torch.div(r * 255, torch.clamp(s, min=1),
                              rounding_mode="floor"), r)
    return r.to(torch.uint8)


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
