"""The one traffic generator: a mix file of `traffic/` (its parameters)
and the seed -> which frame of the depth pool each track sees each frame.

The pool is `segments` runs of `segment_frames` consecutive animbank poses,
segment s starting at bank pose (s * segment_step) % (len(bank) -
segment_frames), the pattern of the port's tools/common.py
`protocol_frames` (track t there starts at (t * 37) % (len - F)).  Track t
plays segment t mod `segments`, one pose a frame, forward then backward at
the ends (period 2 * (segment_frames - 1)), from a seeded phase, so its
motion stays continuous however long the window runs.  Every seed gives
each segment the same number of tracks; only the phases (and the cuts)
move with the seed.

`cut_per_frame` > 0: from frame 1 on, each track independently cuts with
that probability to another segment (uniform over the others) at a
uniform phase: a hand that leaves the view and comes back, or a new user.

Frames are drawn in blocks of `block_frames` from one seeded stream, so
frame f's ids do not depend on how far a run got or how fast it ran.
"""
from __future__ import annotations

import numpy as np

KEYS = ("segments", "segment_frames", "segment_step", "cut_per_frame",
        "block_frames")


def protocol_starts(n_bank: int, n: int, frames: int, step: int):
    """The port's tools/common.py protocol_frames starts: run i starts at
    (i * step) % (n_bank - frames)."""
    return (np.arange(n) * step) % (n_bank - frames)


def pingpong(phase, length: int):
    """Forward then backward over 0..length-1: phase mod 2 * (length - 1)."""
    period = 2 * (length - 1)
    p = np.mod(phase, period)
    return np.where(p < length, p, period - p)


class Traffic:
    def __init__(self, spec: dict, tracks: int, seed: int, n_bank: int):
        missing = [k for k in KEYS if k not in spec]
        if missing:
            raise KeyError(f"traffic mix lacks {missing}")
        self.S = int(spec["segments"])
        self.L = int(spec["segment_frames"])
        self.q = float(spec["cut_per_frame"])
        self.block = int(spec["block_frames"])
        if tracks % self.S:
            raise ValueError(f"{tracks} tracks do not divide over "
                             f"{self.S} segments")
        if self.S * self.L > np.iinfo(np.int32).max or self.S < 2:
            raise ValueError("segments out of range")
        self.T = tracks
        self.starts = protocol_starts(n_bank, self.S, self.L,
                                      int(spec["segment_step"]))
        rng = np.random.default_rng([seed, 0])
        self._rng = np.random.default_rng([seed, 2])
        self.seg = np.arange(tracks) % self.S
        self.phase = rng.integers(0, 2 * (self.L - 1), tracks)
        self._blocks = []      # (ids (B, T) int32, cut (B, T) bool)
        self._next_f = 0

    def pool_bank_ids(self) -> np.ndarray:
        """(S * L,) the animbank pose of every pool frame."""
        return (self.starts[:, None] + np.arange(self.L)[None]).reshape(-1)

    def initial_pool_ids(self) -> np.ndarray:
        """(T,) each track's pool frame just before its first: the pose
        its state starts from."""
        return self.seg * self.L + pingpong(self.phase - 1, self.L)

    def _draw_block(self):
        B, T = self.block, self.T
        ids = np.empty((B, T), np.int32)
        cut = np.zeros((B, T), bool)
        if self.q > 0:
            roll = self._rng.random((B, T)) < self.q
            hop = self._rng.integers(1, self.S, (B, T))
            fresh = self._rng.integers(0, 2 * (self.L - 1), (B, T))
        seg, phase = self.seg, self.phase
        for i in range(B):
            f = self._next_f + i
            if self.q > 0 and f >= 1:
                c = roll[i]
                seg = np.where(c, (seg + hop[i]) % self.S, seg)
                phase = np.where(c, fresh[i], phase)
                cut[i] = c
            ids[i] = seg * self.L + pingpong(phase, self.L)
            phase = phase + 1
        self.seg, self.phase = seg, phase
        self._next_f += B
        self._blocks.append((ids, cut))

    def ensure(self, frames: int):
        """Draw blocks until frames 0..frames-1 exist."""
        while self._next_f < frames:
            self._draw_block()

    def ids(self, f: int) -> np.ndarray:
        """(T,) pool frame of every track at frame f."""
        self.ensure(f + 1)
        return self._blocks[f // self.block][0][f % self.block]

    def cut(self, f: int) -> np.ndarray:
        """(T,) the tracks that cut to another segment at frame f."""
        self.ensure(f + 1)
        return self._blocks[f // self.block][1][f % self.block]

    def block_of(self, b: int):
        """Block b's ids (block_frames, T) int32."""
        self.ensure((b + 1) * self.block)
        return self._blocks[b][0]
