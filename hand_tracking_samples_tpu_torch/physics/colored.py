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

import numpy as np
import torch

from .solver import (FLT_MAX, AngularRows, BodyParams, BodyState,
                     LinearRows, PhysicsParams)


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


class SingleBodyAngular(NamedTuple):
    """(..., C, B)-slotted angular rows with b0 = world."""
    axis: torch.Tensor       # (..., C, B, 3)
    targetspin: torch.Tensor
    mintorque: torch.Tensor
    maxtorque: torch.Tensor
    active: torch.Tensor


class StaticPairLinear(NamedTuple):
    """Rows (T, R) with static body pairs and their group schedule:
    gidx (G, W) row indices, gmask (G, W) (host arrays); jacobi: the
    groups are jacobi phases."""
    rows: LinearRows
    gidx: np.ndarray
    gmask: np.ndarray
    jacobi: bool = False


class StaticPairAngular(NamedTuple):
    rows: AngularRows
    gidx: np.ndarray
    gmask: np.ndarray
    jacobi: bool = False


class JacobiPhases(list):
    """Row groups whose rows apply their impulses at once (a phase of the
    jacobi contact schedule) rather than body-disjoint groups."""


def pad_groups(groups):
    """A group schedule padded to uniform width: (gidx (G, W) int,
    gmask (G, W) bool, jacobi: the groups are JacobiPhases).  (The JAX
    package's one-hot application matrices are a TPU device: the row
    sweep applies each row by its index.)"""
    G = len(groups)
    W = max(len(g) for g in groups) if groups else 1
    gidx = np.zeros((G, W), np.int64)
    gmask = np.zeros((G, W), bool)
    for gi, g in enumerate(groups):
        gidx[gi, :len(g)] = g
        gmask[gi, :len(g)] = True
    return gidx, gmask, isinstance(groups, JacobiPhases)


def make_static_pair_linear(rows: LinearRows, b0, b1) -> StaticPairLinear:
    """b0/b1: the static host-side body indices of each row."""
    groups = precedence_coloring(list(zip(np.asarray(b0), np.asarray(b1))))
    return StaticPairLinear(rows, *pad_groups(groups))


def make_static_pair_angular(rows: AngularRows, b0, b1) -> StaticPairAngular:
    groups = precedence_coloring(list(zip(np.asarray(b0), np.asarray(b1))))
    return StaticPairAngular(rows, *pad_groups(groups))


def pack_single_body_angular(rows: AngularRows, n_bodies: int,
                             slots: int) -> SingleBodyAngular:
    """Slot single-body angular rows (T, R) by (rank within body, body);
    rows past `slots` on a body are dropped."""
    T, R = rows.b1.shape
    dev = rows.b1.device
    b = torch.clamp(rows.b1, min=0)
    act = rows.active & (rows.b1 >= 0)
    oh = ((b[..., None] == torch.arange(n_bodies, device=dev))
          & act[..., None]).to(torch.int64)
    rank = ((torch.cumsum(oh, dim=1) - 1) * oh).sum(-1)
    ok = act & (rank < slots)
    flat = torch.cat([rows.axis, rows.targetspin[..., None],
                      rows.mintorque[..., None], rows.maxtorque[..., None],
                      ok.to(torch.float32)[..., None]], dim=-1)  # (T, R, 7)
    out = torch.zeros((T, slots, n_bodies, 7), device=dev)
    out[..., 4] = -FLT_MAX
    out[..., 5] = FLT_MAX
    tt = torch.arange(T, device=dev)[:, None].expand(T, R)
    sel = ok.reshape(-1)
    out[tt.reshape(-1)[sel], rank.reshape(-1)[sel], b.reshape(-1)[sel]] = \
        flat.reshape(-1, 7)[sel]
    return SingleBodyAngular(axis=out[..., 0:3], targetspin=out[..., 3],
                             mintorque=out[..., 4], maxtorque=out[..., 5],
                             active=out[..., 6] > 0.5)


def _order(gidx, gmask):
    """Rows of a group schedule in sweep order."""
    return gidx[gmask]


def _flat_sb(x):
    """(T, C, B, ...) -> (T, C*B, ...), slot-major then body."""
    return x.reshape((x.shape[0], x.shape[1] * x.shape[2]) + x.shape[3:])


def _sb_bodies(blk_active):
    C, B = blk_active.shape[1], blk_active.shape[2]
    return np.full(C * B, -1), np.tile(np.arange(B), C)


def physics_update_colored(state: BodyState, bodies: BodyParams,
                           linear_blocks: Sequence, angular_blocks: Sequence,
                           params: PhysicsParams, iterations: int = 16,
                           iterations_post: int = 4) -> BodyState:
    """Same semantics as physics_update for the given block schedule;
    blocks are processed in order each sweep."""
    from .solver import solve_and_integrate
    mom0, rows = colored_sweep_inputs(state, bodies, linear_blocks,
                                      angular_blocks, params)
    return solve_and_integrate(state, bodies, rows, mom0, params,
                               iterations, iterations_post)


def colored_sweep_inputs(state: BodyState, bodies: BodyParams,
                         linear_blocks: Sequence, angular_blocks: Sequence,
                         params: PhysicsParams):
    """What the row sweep reads for one colored solve: (mom0, rows), the
    row constants of each block by the JAX colored solver's own
    expressions (prep_sb_lin, prep_sp_lin, prep_sb_ang, prep_sp_ang)."""
    from .pgs_kernel import _batched_world_iinv
    from .row_sweep import angular_block, linear_block, sweep_rows
    from .solver import (angular_consts, angular_targets, init_momenta,
                         linear_consts, linear_targets, master_positions,
                         matvec)
    from ..maths import fma as fq
    dt = params.deltaT
    T = state.pose.shape[0]
    dev = state.pose.device
    mi = bodies.massinv
    mom0 = init_momenta(state, bodies, params)
    iinv = _batched_world_iinv(state.orientation, bodies.tensorinv_massless,
                               mi)                          # (T, B, 3, 3)
    lins = []
    for blk in linear_blocks:
        if isinstance(blk, SingleBodyLinear):
            # prep_sb_lin (colored.py:246-253)
            J1 = fq.cross(blk.r1, blk.normal)               # (T, C, B, 3)
            K1 = matvec(iinv[:, None], J1)
            denom = mi + fq.rsum3(fq.cross(K1, blk.r1), blk.normal)
            ok = blk.active & (denom != 0)
            dinv = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0),
                               torch.zeros((), device=dev))
            ts, tsp = linear_targets(blk.targetdist, blk.targetspeednobias,
                                     params)
            z = torch.zeros_like(J1)
            b0, b1 = _sb_bodies(blk.active)
            lins.append(linear_block(
                b0, b1, *[_flat_sb(x) for x in (
                    blk.normal, z, J1, z, K1, dinv, ts, tsp, blk.fmin * dt,
                    blk.fmax * dt, torch.zeros_like(dinv), blk.active)],
                np.full(len(b0), -1)))
        else:
            r = blk.rows
            order = _order(blk.gidx, blk.gmask)
            J0, J1, K0, K1, dinv = linear_consts(iinv, mi, r.b0, r.b1,
                                                 r.normal, r.r0, r.r1,
                                                 r.active)
            ts, tsp = linear_targets(r.targetdist, r.targetspeednobias,
                                     params)
            mrow = master_positions(r.friction_master)     # block rows
            pos = np.empty(len(mrow), np.int64)
            pos[order] = np.arange(len(order))
            mpos = np.where(mrow[order] >= 0,
                            pos[np.maximum(mrow[order], 0)], -1)
            oi = torch.as_tensor(order, device=dev)
            per_row = [r.b0.expand(T, -1), r.b1.expand(T, -1), r.normal,
                       J0, J1, K0, K1, dinv, ts, tsp, r.fmin * dt,
                       r.fmax * dt, r.friction_coef.expand_as(dinv),
                       r.active.expand_as(dinv)]
            phase = (np.nonzero(blk.gmask)[0] if blk.jacobi else None)
            lins.append(linear_block(*[x[:, oi] for x in per_row], mpos,
                                     phase))
    angs = []
    for blk in angular_blocks:
        if isinstance(blk, SingleBodyAngular):
            # prep_sb_ang (colored.py:271-275)
            K1 = matvec(iinv[:, None], blk.axis)
            denom = fq.rsum3(blk.axis, K1)
            ok = blk.active & (denom != 0)
            stt = torch.where(ok, 1.0 / torch.where(ok, denom, 1.0),
                              torch.zeros((), device=dev))
            spin, spinp = angular_targets(blk.targetspin, blk.mintorque)
            b0, b1 = _sb_bodies(blk.active)
            z = torch.zeros_like(K1)
            angs.append(angular_block(b0, b1, *[_flat_sb(x) for x in (
                blk.axis, z, K1, stt, spin, spinp, blk.mintorque * dt,
                blk.maxtorque * dt, blk.active)]))
        else:
            if blk.jacobi:
                raise ValueError("angular rows have no jacobi phases")
            r = blk.rows
            oi = torch.as_tensor(_order(blk.gidx, blk.gmask), device=dev)
            K0, K1, stt = angular_consts(iinv, r.b0, r.b1, r.axis, r.active)
            spin, spinp = angular_targets(r.targetspin, r.mintorque)
            per_row = [r.b0.expand(T, -1), r.b1.expand(T, -1),
                       r.axis.expand(T, -1, 3), K0, K1, stt, spin, spinp,
                       r.mintorque * dt, r.maxtorque * dt,
                       r.active.expand_as(stt)]
            angs.append(angular_block(*[x[:, oi] for x in per_row]))
    return mom0, sweep_rows(lins, angs, T, dev)
