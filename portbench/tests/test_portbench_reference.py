"""The reference against a direct float64 convolution, and the control's
precision."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import audio, compare, reference, wire


def direct(taps: np.ndarray, x: np.ndarray, ratio: int) -> np.ndarray:
    """[C, n] input -> [C, n * ratio]: the zero-stuffed input convolved
    with the taps, cut at n * ratio (np.convolve, float64)."""
    up = np.zeros((x.shape[0], x.shape[1] * ratio))
    up[:, ::ratio] = x
    return np.stack([np.convolve(row, taps)[:up.shape[1]] for row in up])


@pytest.mark.parametrize("fmt", ["f32", "s16"])
@pytest.mark.parametrize("ratio,ntaps", [(4, 97), (16, 801)])
def test_segments_match_direct_convolution(fmt, ratio, ntaps):
    rng = np.random.default_rng(ntaps)
    taps = rng.normal(size=ntaps) / ntaps
    seed, n_in = 1234, 3 * audio.CHUNK // 2
    x = reference.stream_input(seed, 0, n_in, 2, fmt)
    want = direct(taps, x, ratio).T
    ref = reference.Reference(taps, ratio, 2, fmt)
    items = [(seed, 0, 300), (seed, 5 * ratio + 3, 1000),
             (seed, n_in * ratio - 777, 777), (seed, 44100 * ratio - 50, 100)]
    for (s, a, n), seg in zip(items, ref.segments(items, batch=3)):
        np.testing.assert_allclose(seg, want[a:a + n], rtol=0, atol=1e-12)


def test_s16_input_is_what_the_wire_carries():
    x = audio.frames(5, 100, 400)
    q = reference.stream_input(5, 100, 400, 2, "s16")
    assert np.array_equal(q * 32768.0, wire.quantize_s16(x).astype(float))
    assert np.abs(q - x).max() < 1 / 32768


def test_frames_are_chunked_and_loop():
    a = audio.frames(9, 44000, 44300)
    b = np.concatenate([audio.chunk(9, 0)[:, 44000:],
                        audio.chunk(9, 1)[:, :200]], axis=1)
    assert np.array_equal(a, b)
    loop = audio.LOOP * audio.CHUNK
    assert np.array_equal(audio.frames(9, 10, 90),
                          audio.frames(9, loop + 10, loop + 90))
    assert np.array_equal(audio.frames(9, -5, 3)[:, :5], np.zeros((2, 5)))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                  -3.14159], np.float32)
    r = reference.round_tf32(x)
    assert r[0] == np.float32(1.0 + 2 ** -10)
    assert r[1] == np.float32(1.0)            # tie to even
    assert r[2] == np.float32(1.0 + 2 ** -9)  # tie to even, up
    assert abs(r[3] - x[3]) <= 2 ** -10 * 4


@pytest.mark.parametrize("fmt,name", [("f32", "max_rel"), ("s16", "max_lsb")])
def test_control_fails_the_configured_limit(fmt, name):
    """The control (the reference in TF32 in the program's place) reads
    above each configuration's limit on the real bank, at a small size;
    the float64 reference against itself reads 0."""
    from portbench import run

    cell = run.load_cell("serve80k.live" if fmt == "f32" else "serve8k.live")
    path = (run.ROOT / cell["config"]["serve_flags"]["filter_dir"]
            / (cell["config"]["filter"] + ".json"))
    taps, meta = reference.read_taps(str(path))
    ref = reference.Reference(taps, meta["upsample_factor"], 2, fmt)
    tf32 = reference.Reference(taps, meta["upsample_factor"], 2, fmt,
                               precision="tf32")
    items = [(11, 0, 4096), (11, 200000, 4096), (12, 900001, 4096)]
    want = ref.segments(items)
    got = tf32.segments(items)
    if fmt == "s16":
        got = [reference.quantize_s16(g) for g in got]
        same = [reference.quantize_s16(w) for w in want]
    else:
        same = want
    limit = cell["config"]["check"][name]
    assert compare.sample_number(fmt, got, want) > limit
    assert compare.sample_number(fmt, same, want) == 0
