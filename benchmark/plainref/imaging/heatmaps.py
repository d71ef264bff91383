"""The heatmap codec (include/misc_image.h:241-399), the port's counterpart
of hand_tracking_samples_tpu.imaging.heatmaps, over any leading batch dims.

The label side renders uint8 Gaussian splats normalised to unit volume (sum
255 in byte space), byte for byte with the reference: the peak truncates
as C does, and the integer renormalisation divides int32 by int32 with
floor rounding, as `img*255 // sum` does.  The decode side finds peaks by
first strict maximum (torch.argmax returns the first maximal index, as
jnp.argmax does), weighted sub-pixel peaks and peak volumes."""
from __future__ import annotations

import torch



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
