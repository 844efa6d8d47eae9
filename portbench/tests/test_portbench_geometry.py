"""The yardstick's work count against hand arithmetic."""

from __future__ import annotations

import pytest

from portbench import geometry


def test_flops_per_frame_16x_80k():
    # m = 131072 / 16 = 8192 (log2 13), h = 65536 (log2 16)
    want = 2.5 * 8192 * 13 + 6 * 65536 + 5 * 65536 * 16
    assert geometry.flops_per_frame(131072, 16) == want == 5_902_336


def test_flops_per_frame_16x_8k():
    # m = 1024 (log2 10), h = 8192 (log2 13)
    want = 2.5 * 1024 * 10 + 6 * 8192 + 5 * 8192 * 13
    assert geometry.flops_per_frame(16384, 16) == want == 607_232


def test_least_bytes_and_side():
    # 2048 frames of 16x/80k, one dispatch, f32 out:
    # 2048 * (8192 * 4 + 51072 * 4) + 65536 * 8
    b = geometry.least_bytes(131072, 16, 51072, 2048, 1, 4)
    assert b == 2048 * (32768 + 204288) + 524288
    t, side = geometry.least_seconds(131072, 16, 51072, 2048, 1, 4)
    assert side == "operations"
    assert t == pytest.approx(2048 * 5_902_336 / 67e12)
    # 16x/8k in s16: 2048 * (1024 * 4 + 8384 * 2) + 8192 * 8 bytes
    # (12.8 us at 3.35 TB/s) against 2048 * 607232 FLOP (18.6 us)
    assert geometry.least_bytes(16384, 16, 8384, 2048, 1, 2) == (
        2048 * (4096 + 16768) + 65536)
    t, side = geometry.least_seconds(16384, 16, 8384, 2048, 1, 2)
    assert side == "operations"
    assert t == pytest.approx(2048 * 607_232 / 67e12)
    # one frame of 16x/8k in f32 a dispatch: the filter's bytes decide
    t, side = geometry.least_seconds(16384, 16, 8384, 1, 1, 4)
    assert side == "bytes"
    assert t == pytest.approx((4096 + 33536 + 65536) / 3.35e12)


def test_served_frames_count_no_padding():
    # 3 steps that delivered 5 whole 16x/80k blocks to stereo streams:
    # 10 frames, whatever width and depth the steps were padded to
    before = dict(frames_out=1000 * 51072, steps=40)
    after = dict(frames_out=1005 * 51072, steps=43)
    assert geometry.served_frames(before, after, 51072, 2) == (10.0, 3)
