"""The one traffic generator (portbench/traffic.py)."""
import json
import os

import numpy as np
import pytest

from portbench.traffic import Traffic, pingpong, protocol_starts

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BANK = 2336


def mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def frames(tr, n):
    return np.stack([tr.ids(f) for f in range(n)])


@pytest.mark.parametrize("name", ["synth", "reacquire"])
def test_deterministic_by_seed(name):
    spec = dict(mix(name), block_frames=16)
    a = Traffic(spec, 128, 2**31 + 5, N_BANK)
    b = Traffic(spec, 128, 2**31 + 5, N_BANK)
    c = Traffic(spec, 128, 7, N_BANK)
    fa, fb = frames(a, 40), frames(b, 40)
    assert np.array_equal(fa, fb)
    assert np.array_equal(a.initial_pool_ids(), b.initial_pool_ids())
    assert not np.array_equal(fa, frames(c, 40))
    # a block drawn later gives the same frames as one drawn at once
    d = Traffic(dict(spec, block_frames=40), 128, 2**31 + 5, N_BANK)
    if spec["cut_per_frame"] == 0:
        assert np.array_equal(frames(d, 40), fa)


def test_pingpong_continuous():
    """Forward then backward, one pose a frame, no jump at either end, and
    frame 0 follows the start pose."""
    tr = Traffic(dict(mix("synth"), block_frames=50), 256, 11, N_BANK)
    ids = np.concatenate([tr.initial_pool_ids()[None], frames(tr, 300)])
    L = tr.L
    seg, pos = ids // L, ids % L
    assert (seg == seg[0]).all()
    assert (np.abs(np.diff(pos, axis=0)) == 1).all()
    assert pos.min() == 0 and pos.max() == L - 1
    assert np.array_equal(pingpong(np.arange(2 * L), L)[L - 2:L + 2],
                          [L - 2, L - 1, L - 2, L - 3])


def test_same_segments_for_every_seed():
    """Every seed gives each segment the same number of tracks."""
    for seed in (1, 2, 2**33):
        tr = Traffic(mix("synth"), 512, seed, N_BANK)
        counts = np.bincount(tr.ids(0) // tr.L, minlength=tr.S)
        assert (counts == 512 // tr.S).all()


def test_pool_segments_spread_over_the_bank():
    spec = mix("synth")
    starts = protocol_starts(N_BANK, spec["segments"],
                             spec["segment_frames"], spec["segment_step"])
    assert len(set(starts)) == spec["segments"]
    assert starts.max() + spec["segment_frames"] <= N_BANK


def test_reacquire_cut_probability():
    """Each track cuts with probability cut_per_frame a frame (binomial,
    5 sigma), to another segment, and plays on continuously between
    cuts."""
    spec = dict(mix("reacquire"), block_frames=64)
    q = spec["cut_per_frame"]
    tr = Traffic(spec, 1024, 123456789012, N_BANK)
    n = 256
    ids = frames(tr, n)
    cut = np.stack([tr.cut(f) for f in range(n)])
    assert not cut[0].any()
    trials = (n - 1) * 1024
    k = int(cut[1:].sum())
    sd = np.sqrt(trials * q * (1 - q))
    assert abs(k - trials * q) < 5 * sd
    seg = ids // tr.L
    assert (seg[1:][cut[1:]] != seg[:-1][cut[1:]]).all()
    pos = ids % tr.L
    steady = ~cut[1:]
    assert (np.abs(np.diff(pos, axis=0))[steady] == 1).all()
    assert (seg[1:][steady] == seg[:-1][steady]).all()
    # roughly 1/8 of the tracks cut within any 4 frames
    share = np.mean([cut[f - 3:f + 1].any(0).mean()
                     for f in range(4, n, 4)])
    assert 0.09 < share < 0.15
