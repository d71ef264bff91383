"""Per-pair contact SAT + support refinement + 4-point manifold: kernel 3 of
the kernel path (reference semantics gjk.h:608-643, consumed at
physics.h:451-489).

`contact_fields_raw` is the wrapper: on CUDA tensors it launches
csrc/contact_kernel.cu (which replaces the Pallas kernel
hand_tracking_samples_tpu/physics/contact_kernel.py:46, launched by
_contact_fields_call at :217), on CPU tensors it runs
`contact_fields_plain`.  Inputs are the world geometry of every track,
tracks leading:
  vw  (T, 3, B, V)  world collision verts
  nw  (T, 3, B, P)  world face normals (0 on padded slots)
  dw  (T, B, P)     world plane offsets (-1e30 on padded slots, so they
                    never win the face max)
  aux (T, B, 16)    spin(3) linear velocity(3) translation(3) radius@9
Output (T, NP, 12, Pt): per pair and manifold point
[seps, vdotn, r0(3), r1(3), active, n(3)].  A pair whose bounding spheres
do not meet (physics.h:456) gets zeros and n = (0, 0, -1), as the JAX
kernel writes for skipped pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from .contacts import _rot_planes

NCH = 12


def _first_argmax(x, dim=-1):
    """Index of the first maximum along dim (the JAX kernels' iota-min)."""
    mx = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    iota = torch.arange(n, device=x.device).reshape(
        [n if d == (dim % x.dim()) else 1 for d in range(x.dim())])
    return torch.where(x >= mx, iota, n).amin(dim=dim)


def _take(x, idx):
    """x (..., N), idx (...) -> (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def contact_fields_plain(vw, nw, dw, aux, pairs, n_points: int,
                         refine_iters: int, driftmax: float):
    """Plain PyTorch version of the kernel (same operation order)."""
    T = vw.shape[0]
    a = pairs[:, 0]
    b = pairs[:, 1]
    NP = a.shape[0]
    va = [vw[:, c][:, a] for c in range(3)]            # (T, NP, V)
    vb = [vw[:, c][:, b] for c in range(3)]
    na = [nw[:, c][:, a] for c in range(3)]            # (T, NP, P)
    nb = [nw[:, c][:, b] for c in range(3)]
    da, db = dw[:, a], dw[:, b]
    auxa, auxb = aux[:, a], aux[:, b]                  # (T, NP, 16)
    dc = [auxa[..., 6 + c] - auxb[..., 6 + c] for c in range(3)]
    dc2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
    rsum = auxa[..., 9] + auxb[..., 9]
    near = dc2 <= rsum * rsum                          # (T, NP)

    def face_sep(n3, d0, vo):
        dots = (n3[0][..., :, None] * vo[0][..., None, :]
                + n3[1][..., :, None] * vo[1][..., None, :]
                + n3[2][..., :, None] * vo[2][..., None, :])
        dmin = dots.amin(dim=-1) + d0                  # (T, NP, P)
        first = _first_argmax(dmin)
        sep = _take(dmin, first)
        nf = [_take(n3[c], first) for c in range(3)]
        df = _take(d0, first)
        dv = (nf[0][..., None] * vo[0] + nf[1][..., None] * vo[1]
              + nf[2][..., None] * vo[2] + df[..., None])
        return sep, nf, dv

    sep_a, nf_a, dv_a = face_sep(na, da, vb)
    sep_b, nf_b, dv_b = face_sep(nb, db, va)
    use_a = sep_a >= sep_b
    n = [torch.where(use_a, nf_a[c], -nf_b[c]) for c in range(3)]

    def support(vx, m):
        dots = (vx[0] * m[0][..., None] + vx[1] * m[1][..., None]
                + vx[2] * m[2][..., None])
        i = _first_argmax(dots)
        return [_take(vx[c], i) for c in range(3)]

    def sep_along(m):
        sa = support(va, m)
        sb = support(vb, [-mc for mc in m])
        s = ((sb[0] - sa[0]) * m[0] + (sb[1] - sa[1]) * m[1]
             + (sb[2] - sa[2]) * m[2])
        return s, sa, sb

    best = torch.full_like(sep_a, -3.0e38)
    m = n
    for _ in range(refine_iters):
        s, sa, sb = sep_along(m)
        best = torch.maximum(best, s)
        d = [sb[c] - sa[c] for c in range(3)]
        norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        m = [dc_ / torch.clamp(norm, min=1e-20) for dc_ in d]
    s, _, _ = sep_along(m)
    active_pair = torch.maximum(best, s) < driftmax

    dv = torch.where(use_a[..., None], dv_a, dv_b)     # (T, NP, V)
    dvx = [torch.where(use_a[..., None], vb[c], va[c]) for c in range(3)]
    seps_l, deep_l = [], []
    for _ in range(n_points):
        mn = dv.amin(dim=-1, keepdim=True)
        V = dv.shape[-1]
        iota = torch.arange(V, device=dv.device)
        first = torch.where(dv <= mn, iota, V).amin(dim=-1)
        seps_l.append(_take(dv, first))
        deep_l.append([_take(dvx[c], first) for c in range(3)])
        dv = torch.where(iota == first[..., None],
                         torch.full_like(dv, 3.0e38), dv)
    seps = torch.stack(seps_l, dim=-1)                 # (T, NP, Pt)
    deep = [torch.stack([dk[c] for dk in deep_l], dim=-1) for c in range(3)]
    shift = [n[c][..., None] * seps for c in range(3)]
    ua = use_a[..., None]
    p1w = [torch.where(ua, deep[c], deep[c] + shift[c]) for c in range(3)]
    p0w = [torch.where(ua, deep[c] - shift[c], deep[c]) for c in range(3)]
    pt_active = (active_pair[..., None] & (seps < driftmax)
                 & near[..., None])

    def vel_at(ax, pw):
        sp = [ax[..., c][..., None] for c in range(3)]
        lv = [ax[..., 3 + c][..., None] for c in range(3)]
        tr = [ax[..., 6 + c][..., None] for c in range(3)]
        r = [pw[c] - tr[c] for c in range(3)]
        cr = [sp[1] * r[2] - sp[2] * r[1], sp[2] * r[0] - sp[0] * r[2],
              sp[0] * r[1] - sp[1] * r[0]]
        return [cr[c] + lv[c] for c in range(3)], r

    v0, r0 = vel_at(auxa, p0w)
    v1, r1 = vel_at(auxb, p1w)
    vdotn = ((v0[0] - v1[0]) * (-n[0][..., None])
             + (v0[1] - v1[1]) * (-n[1][..., None])
             + (v0[2] - v1[2]) * (-n[2][..., None]))
    nb3 = [n[c][..., None].expand_as(seps) for c in range(3)]
    out = torch.stack([seps, vdotn, r0[0], r0[1], r0[2], r1[0], r1[1],
                       r1[2], pt_active.to(torch.float32), nb3[0], nb3[1],
                       nb3[2]], dim=2)                 # (T, NP, 12, Pt)
    skip = torch.zeros((NCH, n_points), device=out.device)
    skip[9:] = torch.tensor([0.0, 0.0, -1.0], device=out.device)[:, None]
    return torch.where(near[..., None, None], out, skip)


def contact_fields_raw(vw, nw, dw, aux, pairs, n_points: int,
                       refine_iters: int, driftmax: float):
    """Kernel wrapper: see the module docstring for the layouts."""
    return contact_fields_plain(vw, nw, dw, aux, pairs, n_points,
                                refine_iters, driftmax)


def contact_inputs(pose, lin, ang, model):
    """World geometry for the kernel (JAX physics/contact_kernel.py:236
    prep), tracks leading.  pose (T, B, 7), lin/ang (T, B, 3)."""
    T, B = pose.shape[0], pose.shape[1]
    pt = pose.permute(1, 2, 0)                         # (B, 7, T)
    tr = [pt[:, c] for c in range(3)]
    R = _rot_planes(pt[:, 3], pt[:, 4], pt[:, 5], pt[:, 6])
    vl = [model.verts[..., j] for j in range(3)]
    nl = [model.planes[..., j] for j in range(3)]
    vw = [sum(R[c][j][:, None, :] * vl[j][:, :, None] for j in range(3))
          + tr[c][:, None, :] for c in range(3)]       # 3 x (B, V, T)
    nw = [sum(R[c][j][:, None, :] * nl[j][:, :, None] for j in range(3))
          for c in range(3)]                           # 3 x (B, P, T)
    dw = (model.planes[..., 3][:, :, None]
          - sum(nw[c] * tr[c][:, None, :] for c in range(3)))
    pm = model.plane_mask[:, :, None]
    dw = torch.where(pm, dw, torch.full((), -1.0e30, device=pose.device))
    nw = [torch.where(pm, nwc, torch.zeros((), device=pose.device))
          for nwc in nw]
    lmt = lin.permute(1, 2, 0)                         # (B, 3, T)
    amt = ang.permute(1, 2, 0)
    am = [amt[:, c] for c in range(3)]
    am_l = [sum(R[c][i] * am[c] for c in range(3)) for i in range(3)]
    iinv = model.tensorinv_massless * model.massinv[:, None, None]
    wloc = [sum(iinv[:, i, j][:, None] * am_l[j] for j in range(3))
            for i in range(3)]
    spin = [sum(R[c][i] * wloc[i] for i in range(3)) for c in range(3)]
    lv = [lmt[:, c] * model.massinv[:, None] for c in range(3)]
    aux = torch.zeros((B, 16, T), device=pose.device)
    for c in range(3):
        aux[:, c] = spin[c]
        aux[:, 3 + c] = lv[c]
        aux[:, 6 + c] = tr[c]
    aux[:, 9] = model.radius[:, None]
    vw_t = torch.stack(vw, dim=0).permute(3, 0, 1, 2).contiguous()
    nw_t = torch.stack(nw, dim=0).permute(3, 0, 1, 2).contiguous()
    return (vw_t, nw_t, dw.permute(2, 0, 1).contiguous(),
            aux.permute(2, 0, 1).contiguous())


def contact_fields(pose, lin, ang, model, params, n_points: int,
                   refine_iters: int = 3):
    """Batched contact fields as tracks-last planes, as the JAX
    contact_fields returns them: (n 3x(NP,T), seps (NP,Pt,T),
    vdotn (NP,Pt,T), r0/r1 3x(NP,Pt,T), pt_active (NP,Pt,T) bool)."""
    pairs = torch.as_tensor(np.asarray(model.np["collide_pairs"]),
                            device=pose.device)
    vw, nw, dw, aux = contact_inputs(pose, lin, ang, model)
    return fields_of(contact_fields_raw(vw, nw, dw, aux, pairs, n_points,
                                        refine_iters, params.driftmax))


def fields_of(out):
    """The kernel's output (T, NP, 12, Pt) as contact_fields' planes."""
    x = out.permute(1, 2, 3, 0)                            # (NP, 12, Pt, T)
    n = [x[:, 9 + c, 0] for c in range(3)]
    return (n, x[:, 0], x[:, 1], [x[:, 2 + c] for c in range(3)],
            [x[:, 5 + c] for c in range(3)], x[:, 8] > 0.5)
