"""Each plain program of the port gives a frame the same bits whatever the
size of its dispatch, as the JAX package's CPU path does.

A stream's chunking, a mesh's time shards and the CLI's sharded granule
all decide how many frames share one dispatch. For every plain program
P, seeded frames F[C, 13, m] and a split of the 13 frames into runs of
1, 2, 3 or 5, the concatenation of P over the runs must equal P(F) bit
for bit (``assert_array_equal``), on stereo and on one channel. The
crossfeed step, stereo only, is fed the runs in turn with its tail
carried, against one step over all 13 blocks.

Which BLAS kernels a host runs decides whether a regression shows:
``torch.backends.cpu.get_cpu_capability()`` names them (a GEMM that lets
the kernel choose by the number of frames broke these on an AVX512 host
and passed on others). The frame kernel is held to the same rule on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu_torch.engine import crossfeed as tcf
from totton_tpu_torch.ops import fft as tfft
from totton_tpu_torch.ops import overlap_save as tos

DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(2)

N_FRAMES = 13
RUNS = [1, 2, 3, 5]
CHANNELS = {"stereo": 2, "mono": 1}
#: The deep case: stereo dispatches of MANY_FRAMES frames at the host's
#: default thread count, against runs of MANY_RUNS frames in turn (as
#: chip_smoke.py splits 512 blocks on the card).
MANY_FRAMES = 384
MANY_RUNS = (1, 3, 7, 64)


def _cfg(taps, fft, ratio):
    return tos.OverlapSaveConfig(taps=taps, fft_size=fft,
                                 block_size=fft - (taps - 1), ratio=ratio)


def _spectrum(cfg, seed=1):
    h = np.random.default_rng(seed).normal(size=cfg.taps)
    h *= np.exp(-np.arange(cfg.taps) * 4.0 / cfg.taps)
    return tos.filter_spectrum(h, cfg.fft_size)


def _frames_program(cfg, bundle, classic=False):
    assert bundle.classic == classic
    return cfg.frame_in, lambda f: tos.upsample_frames(f, bundle, cfg)


def _folded(ratio, taps=257, fft=4096):
    cfg = _cfg(taps, fft, ratio)
    return _frames_program(cfg, tos.fold_bundle(_spectrum(cfg), cfg))


def _classic():
    cfg = _cfg(1024, 4096, 1)
    return _frames_program(cfg, tos.fold_bundle(_spectrum(cfg), cfg),
                           classic=True)


def _fft2_real(n):
    return n, lambda f: torch.cat(tfft.fft2_real(f, n), -1)


def _rfft2_irfft2(n):
    def run(f):
        sr, si = tfft.rfft2(f, n)
        return torch.cat([sr, si, tfft.irfft2(sr, si, n)], -1)
    return n, run


#: name -> () -> (frame length m, program on [C, N, m] frames).
PROGRAMS = {
    "folded_2x": lambda: _folded(2),
    "folded_4x": lambda: _folded(4),
    "folded_8x": lambda: _folded(8),
    "folded_16x": lambda: _folded(16),
    "ratio1": lambda: _frames_program(
        _cfg(257, 2048, 1), tos.fold_bundle(_spectrum(_cfg(257, 2048, 1)),
                                            _cfg(257, 2048, 1))),
    "folded_4x_8192": lambda: _folded(4, 1025, 8192),
    "folded_16x_8192": lambda: _folded(16, 1025, 8192),
    "classic": _classic,
    "fft2_real_512": lambda: _fft2_real(512),
    "fft2_real_2048": lambda: _fft2_real(2048),
    "rfft2_irfft2": lambda: _rfft2_irfft2(1024),
    "fft2_real_1024": lambda: _fft2_real(1024),
}


def _runs(size):
    return [(lo, min(lo + size, N_FRAMES))
            for lo in range(0, N_FRAMES, size)]


#: (program, run, channels); the crossfeed step is stereo only.
CASES = [(name, run, ch) for name in list(PROGRAMS) + ["crossfeed_step"]
         for run in RUNS for ch in CHANNELS
         if not (name == "crossfeed_step" and ch == "mono")]


@pytest.mark.parametrize("name,run,channels", CASES,
                         ids=[f"{n}-runs_of_{r}-{c}" for n, r, c in CASES])
def test_frame_bits_do_not_depend_on_the_dispatch(name, run, channels):
    rng = np.random.default_rng(0)
    if name == "crossfeed_step":
        _check_crossfeed(rng, run)
        return
    m, program = PROGRAMS[name]()
    frames = torch.from_numpy((rng.normal(
        size=(CHANNELS[channels], N_FRAMES, m)) * 0.3).astype(np.float32))
    whole = program(frames).numpy()
    parts = np.concatenate([program(frames[:, lo:hi]).numpy()
                            for lo, hi in _runs(run)], axis=1)
    assert np.isfinite(whole).all() and whole.shape[:2] == frames.shape[:2]
    np.testing.assert_array_equal(parts, whole)


def _check_crossfeed(rng, run):
    cfg = tcf._cf_geometry(129)
    spectra = np.fft.rfft(rng.normal(size=(4, cfg.taps))
                          * np.exp(-np.arange(cfg.taps) / 32.0),
                          cfg.fft_size)
    h = (torch.from_numpy(spectra.real.astype(np.float32)),
         torch.from_numpy(spectra.imag.astype(np.float32)))
    step = tcf._make_cf_step(cfg)
    x = torch.from_numpy((rng.normal(size=(2, N_FRAMES * cfg.block_in))
                          * 0.3).astype(np.float32))
    tail0 = torch.from_numpy((rng.normal(size=(2, cfg.halo_in)) * 0.3)
                             .astype(np.float32))
    whole, whole_tail = step(tail0, x, h)
    tail, parts = tail0, []
    for lo, hi in _runs(run):
        y, tail = step(tail, x[:, lo * cfg.block_in: hi * cfg.block_in], h)
        parts.append(y.numpy())
    np.testing.assert_array_equal(np.concatenate(parts, -1), whole.numpy())
    np.testing.assert_array_equal(tail.numpy(), whole_tail.numpy())


@pytest.mark.parametrize("name", ["folded_16x", "folded_4x_8192",
                                  "folded_16x_8192", "classic",
                                  "rfft2_irfft2"])
def test_deep_dispatch_bits_do_not_depend_on_the_dispatch(name):
    """The same rule at a deep dispatch and every thread the host has:
    a GEMM's blocking across threads grows with the batch."""
    rng = np.random.default_rng(0)
    m, program = PROGRAMS[name]()
    frames = torch.from_numpy((rng.normal(size=(2, MANY_FRAMES, m)) * 0.3)
                              .astype(np.float32))
    runs, lo = [], 0
    while lo < MANY_FRAMES:
        hi = min(MANY_FRAMES, lo + MANY_RUNS[len(runs) % len(MANY_RUNS)])
        runs.append((lo, hi))
        lo = hi
    threads = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        whole = program(frames).numpy()
        parts = np.concatenate([program(frames[:, a:b]).numpy()
                                for a, b in runs], axis=1)
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(whole).all() and whole.shape[:2] == frames.shape[:2]
    np.testing.assert_array_equal(parts, whole)


#: Frames among which ``test_one_row_product_bits_do_not_depend_on_the_batch``
#: holds a one-row product, and the batch sizes it cuts from them.
ONE_ROW_FRAMES = 64
ONE_ROW_BATCHES = (1, 3, 7, 9, 21, 63)
ONE_ROW_CASES = [(t, b) for t in (2, 4) for b in ONE_ROW_BATCHES]


@pytest.mark.parametrize("threads,batch", ONE_ROW_CASES,
                         ids=[f"threads_{t}-batch_{b}"
                              for t, b in ONE_ROW_CASES])
def test_one_row_product_bits_do_not_depend_on_the_batch(threads, batch):
    """``frame_matmul`` on frames of one row each (a single-stage
    transform's product, [F, 512] against [512, 512]): the first ``batch``
    frames alone give the same bits as among ONE_ROW_FRAMES. A plain
    batched product of M = 1 rows broke this on an AVX512 host at 2 and
    4 threads."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(ONE_ROW_FRAMES, 512, generator=gen)
    w = torch.randn(512, 512, generator=gen)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        whole = tfft.frame_matmul(x, w)
        part = tfft.frame_matmul(x[:batch], w)
    finally:
        torch.set_num_threads(before)
    np.testing.assert_array_equal(part.numpy(), whole[:batch].numpy())
