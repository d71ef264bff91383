"""Colored-schedule Gauss-Seidel solver: the port's counterpart of
hand_tracking_samples_tpu.physics.colored.

Rows whose body sets are disjoint commute, so a sweep can run as groups of
mutually disjoint rows in an order that keeps every conflicting pair's
relative order: the result equals the sequential sweep.  Single-body rows
(b0 = world) pack into a (C, B) slot matrix — slot (c, b) is the c-th row on
body b; rows with static body pairs (joints, contacts) are
precedence-colored on the host into groups.  `physics_update_colored`
computes each block's row constants with the JAX colored solver's own
expressions and runs the sweeps in the row-sweep kernel
(physics/row_sweep.py) with the rows in colored order: single-body blocks
slot-major then body, pair blocks group by group.  Within an exact group
the rows touch disjoint bodies, so one after another they give the JAX
package's one-hot group update exactly.  A block of jacobi phases
(`JacobiPhases`: the contact rows with contacts_mode="jacobi") is not
exact: the rows of a phase share bodies, and the row sweep runs each phase
as a jacobi level, every row on the momenta of the phase's start and each
body's deltas summed in row order (JAX colored.py:339-372, whose one-hot
product sums them in XLA's order).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .solver import LinearRows


def precedence_coloring(body_sets: Sequence[tuple]) -> list[list[int]]:
    """Greedy schedule: row i goes to the earliest group after every earlier
    conflicting row's group.  Returns the groups (lists of row indices);
    concatenated, they preserve all conflicting-pair orderings."""
    groups: list[list[int]] = []
    group_bodies: list[set] = []
    row_group = []
    sets = [{int(b) for b in bodies if b >= 0} for bodies in body_sets]
    for i, bs in enumerate(sets):
        earliest = 0
        for j in range(i):
            if bs & sets[j]:
                earliest = max(earliest, row_group[j] + 1)
        g = earliest
        while g < len(groups) and (group_bodies[g] & bs):
            g += 1
        while g >= len(groups):
            groups.append([])
            group_bodies.append(set())
        groups[g].append(i)
        group_bodies[g] |= bs
        row_group.append(g)
    return groups


class SingleBodyLinear(NamedTuple):
    """(..., C, B)-slotted rows with b0 = world."""
    normal: torch.Tensor      # (..., C, B, 3)
    r1: torch.Tensor          # (..., C, B, 3)
    targetdist: torch.Tensor  # (..., C, B)
    targetspeednobias: torch.Tensor
    fmin: torch.Tensor
    fmax: torch.Tensor
    active: torch.Tensor      # (..., C, B) bool


def pack_single_body_linear(rows: LinearRows, n_bodies: int,
                            slots: int) -> SingleBodyLinear:
    """Slot single-body rows (T, R) by (rank within body, body).  Bodies with
    more rows than `slots` keep a uniform subset: rank r -> slot
    (r*slots)//count, first occurrence wins, and the surviving rows' force
    limits scale by count/slots, as in the JAX package."""
    T, R = rows.b1.shape
    dev = rows.b1.device
    b = torch.clamp(rows.b1, min=0)
    act = rows.active & (rows.b1 >= 0)
    onehot = (b[..., None] == torch.arange(n_bodies, device=dev)) \
        & act[..., None]                                    # (T, R, B)
    oh = onehot.to(torch.int64)
    rank = ((torch.cumsum(oh, dim=1) - 1) * oh).sum(-1)     # (T, R)
    cnt_b = oh.sum(1)                                       # (T, B)
    cnt = (oh * cnt_b[:, None, :]).sum(-1)                  # (T, R)
    thin = cnt > slots
    safe = torch.clamp(cnt, min=1)
    nr = torch.where(thin, (rank * slots) // safe, rank)
    prev = torch.where(thin & (rank > 0), ((rank - 1) * slots) // safe,
                       torch.full_like(rank, -1))
    keep = (~thin) | (rank == 0) | (nr > prev)
    ok = act & keep & (nr < slots)
    comp = torch.where(thin, cnt.to(torch.float32) * (1.0 / slots),
                       torch.ones_like(rows.fmin))
    flat = torch.cat([
        rows.normal, rows.r1, rows.targetdist[..., None],
        rows.targetspeednobias[..., None], (rows.fmin * comp)[..., None],
        (rows.fmax * comp)[..., None], ok.to(torch.float32)[..., None]],
        dim=-1)                                             # (T, R, 11)
    out = torch.zeros((T, slots + 1, n_bodies, 11), dtype=flat.dtype,
                      device=dev)
    tt = torch.arange(T, device=dev)[:, None].expand(T, R)
    c = torch.where(ok, nr, torch.full_like(nr, slots))    # dropped -> spare
    sel = ok.reshape(-1)
    out[tt.reshape(-1)[sel], c.reshape(-1)[sel], b.reshape(-1)[sel]] = \
        flat.reshape(-1, 11)[sel]
    out = out[:, :slots]
    return SingleBodyLinear(
        normal=out[..., 0:3], r1=out[..., 3:6], targetdist=out[..., 6],
        targetspeednobias=out[..., 7], fmin=out[..., 8], fmax=out[..., 9],
        active=out[..., 10] > 0.5)


