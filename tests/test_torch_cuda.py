"""The port's CUDA kernels on the card, against their plain versions.

Every test of the port that needs an NVIDIA GPU lives here, marked
``cuda``; each skips without a card (the decision is taken inside the
test). The file imports neither jax nor the JAX package, and needs no
conftest, so that the card's machine, which has no jax, runs it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_cuda.py

(chip_smoke.py's phase ``ci`` runs that command and fails unless every
case passes). Tolerances: the frame kernel within rel 1e-5 of the plain
version (fp32, another summation order); the EQ cascade within rel 1e-5
with its state within rtol 1e-4, atol 1e-6 (the same fused multiply-adds
in the same order, so 0 is expected); the serve plane within rel 1e-5 of
the offline upsample on the card.
"""

import os
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from totton_tpu_torch.engine.upsampler import upsample_signal
from totton_tpu_torch.eq import iir
from totton_tpu_torch.eq.apo import parse_eq_string
from totton_tpu_torch.filters.sidecar import load_filter
from totton_tpu_torch.io.serve_client import ServeClient
from totton_tpu_torch.ops import fused_frames as ff
from totton_tpu_torch.ops import overlap_save as tos
from totton_tpu_torch.serve import StreamServer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILTER_DIR = os.path.join(REPO, "data", "coefficients")
RATE = 44100
FS = 44100.0
#: The frame kernel and the serve plane against the plain version.
REL = 1e-5
#: The cascade's kernel against the plain version (rel to the output's
#: peak); its carried state within rtol 1e-4, atol 1e-6.
REL_TOL = 1e-5

#: Ten bands of PK, LS and HS (the kinds of an APO headphone profile).
PROFILE_10 = """Preamp: -6 dB
Filter 1: ON PK Fc 31 Hz Gain 2.5 dB Q 1.2
Filter 2: ON LS Fc 105 Hz Gain 4 dB Q 0.7
Filter 3: ON PK Fc 220 Hz Gain -1.5 dB Q 1.4
Filter 4: ON PK Fc 500 Hz Gain 1 dB Q 2.0
Filter 5: ON PK Fc 1000 Hz Gain 3 dB Q 1.0
Filter 6: ON PK Fc 2200 Hz Gain -2 dB Q 3.0
Filter 7: ON PK Fc 4000 Hz Gain 2 dB Q 2.5
Filter 8: ON PK Fc 6500 Hz Gain -3 dB Q 4.0
Filter 9: ON HS Fc 8000 Hz Gain -2 dB Q 0.7
Filter 10: ON PK Fc 12000 Hz Gain 1.5 dB Q 1.0
"""


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _rel(a, b) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cfg(taps, fft, ratio):
    return tos.OverlapSaveConfig(taps=taps, fft_size=fft,
                                 block_size=fft - (taps - 1), ratio=ratio)


# ---- the frame kernel (csrc/fused_frames.cu) ---------------------------


def test_fold_bundle_on_cuda_builds_g_not_gw():
    """On a CUDA device the swap folds G (h bins; G1 and G2 at ratio 1) at
    every ratio."""
    dev = _card()
    for taps, fft, ratio in [(80001, 131072, 16), (8001, 16384, 4),
                             (1025, 4096, 1)]:
        cfg = _cfg(taps, fft, ratio)
        b = tos.fold_bundle(tos.filter_spectrum(np.ones(taps), fft,
                                                device=dev), cfg)
        assert b.weights.device.type == "cuda"
        assert tuple(b.weights.shape) == (
            (2, fft // 2, 2) if ratio == 1 else (fft // 2, 2))


# Frame counts the main path hands the kernel: a full 512-block stereo
# dispatch (1024), the ragged 32/8/1-block tail dispatches (64, 16, 2), one
# off every tile edge (18), and a round count (128).
CUDA_FRAME_COUNTS = [2, 16, 18, 64, 128, 1024]
#: Bundled filters by name; "ratio1_1025_4096" is the CLI's ratio-1
#: geometry and "e2e_2001_2048_2x" the one scripts/torch/
#: e2e_local_file_test.sh designs (44k_2x at 2000 taps: block 48, the
#: smallest block a served path gives the resident plan), each with a
#: seeded filter.
CUDA_FILTERS = ["filter_44k_16x_80000_min_phase",
                "filter_44k_2x_80000_min_phase",
                "filter_44k_16x_8000_min_phase",
                "filter_44k_2x_8000_min_phase",
                "ratio1_1025_4096", "e2e_2001_2048_2x"]
SEEDED = {"ratio1_1025_4096": (1025, 4096, 1, 100.0),
          "e2e_2001_2048_2x": (2001, 2048, 2, 250.0)}


@pytest.mark.parametrize("n_frames", CUDA_FRAME_COUNTS)
@pytest.mark.parametrize("name", CUDA_FILTERS)
def test_cuda_kernel_matches_plain(name, n_frames):
    dev = _card()
    rng = np.random.default_rng(0)
    if name in SEEDED:
        taps_n, fft, ratio, decay = SEEDED[name]
        cfg = _cfg(taps_n, fft, ratio)
        taps = rng.normal(size=taps_n) * np.exp(-np.arange(taps_n) / decay)
    else:
        lf = load_filter(os.path.join(FILTER_DIR, name + ".json"))
        cfg = tos.OverlapSaveConfig.from_sidecar(lf.sidecar)
        taps = lf.taps
    bundle = tos.fold_bundle(
        tos.filter_spectrum(taps, cfg.fft_size, device=dev), cfg)
    frames = torch.from_numpy(
        (rng.normal(size=(n_frames, cfg.frame_in)) * 0.3).astype(np.float32)
    ).to(dev)
    before = ff.LAUNCHES
    y = ff.fused_upsample_frames(frames, bundle, cfg)
    ref = tos.upsample_frames(frames, bundle, cfg)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == before + 1
    assert torch.isfinite(y).all().item()
    assert _rel(y.cpu().numpy(), ref.cpu().numpy()) < REL


#: The batch-invariance case's geometries: the e2e script's and 16x/80k.
SPLIT_FILTERS = ["e2e_2001_2048_2x", "filter_44k_16x_80000_min_phase"]
#: 13 frames, one launch against runs of 1, 2, 3 and 5 frames.
SPLIT_FRAMES = 13
SPLIT_RUNS = [1, 2, 3, 5]


@pytest.mark.parametrize("name", SPLIT_FILTERS)
def test_cuda_kernel_frame_bits_do_not_depend_on_the_dispatch(name):
    """Each frame's block is the same bits whatever the frames launched
    beside it, on stereo and on one channel (as
    tests/test_torch_batch_invariance.py holds the plain programs on the
    CPU)."""
    dev = _card()
    rng = np.random.default_rng(0)
    if name in SEEDED:
        taps_n, fft, ratio, decay = SEEDED[name]
        cfg = _cfg(taps_n, fft, ratio)
        taps = rng.normal(size=taps_n) * np.exp(-np.arange(taps_n) / decay)
    else:
        lf = load_filter(os.path.join(FILTER_DIR, name + ".json"))
        cfg = tos.OverlapSaveConfig.from_sidecar(lf.sidecar)
        taps = lf.taps
    bundle = tos.fold_bundle(
        tos.filter_spectrum(taps, cfg.fft_size, device=dev), cfg)

    def kernel(f):
        y = ff.fused_upsample_frames(
            f.reshape(-1, cfg.frame_in).contiguous(), bundle, cfg)
        return y.reshape(f.shape[0], f.shape[1], -1)

    for channels in (2, 1):
        frames = torch.from_numpy((rng.normal(
            size=(channels, SPLIT_FRAMES, cfg.frame_in)) * 0.3).astype(
                np.float32)).to(dev)
        whole = kernel(frames)
        assert torch.isfinite(whole).all().item()
        for run in SPLIT_RUNS:
            parts = torch.cat([kernel(frames[:, lo:lo + run])
                               for lo in range(0, SPLIT_FRAMES, run)], 1)
            assert torch.equal(parts, whole), (channels, run)


# ---- the EQ cascade (csrc/biquad_cascade.cu) ---------------------------


def _cuda_case(bands, n, seed):
    """(x, coeffs, state, preamp) on the card: the first ``bands`` of
    PROFILE_10 and thirty more peaks, a non-zero carried state."""
    dev = _card()
    text = PROFILE_10 + "".join(
        f"Filter {11 + i}: ON PK Fc {300 + 500 * i} Hz Gain "
        f"{1 if i % 2 else -1} dB Q 2\n" for i in range(30))
    prof = parse_eq_string(text)
    prof.bands = prof.bands[:bands]
    coeffs, preamp = iir.profile_to_coeff_matrix(prof, FS)
    x = torch.from_numpy((np.random.default_rng(seed).normal(size=(2, n))
                          * 0.3).astype(np.float32)).to(dev)
    c = torch.from_numpy(coeffs).to(dev)
    s0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, coeffs.shape[0], 2)).astype(np.float32) * 0.01).to(dev)
    return x, c, s0, preamp


def _check_cascade(x, c, s0, preamp):
    before = iir.LAUNCHES
    y, st = iir.cascade(x, c, s0, preamp)
    torch.cuda.synchronize()
    assert iir.LAUNCHES - before == -(-c.shape[0] // iir.MAX_BANDS)
    ref, ref_st = iir.cascade_plain(x, c, s0, preamp)
    assert ((y - ref).abs().max() / ref.abs().max()).item() <= REL_TOL
    assert torch.allclose(st, ref_st, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bands", [1, 10, 20, 32, 40])
def test_cuda_cascade_matches_plain(bands):
    """The kernel against the plain version on the card (40 bands: two
    launches of at most MAX_BANDS)."""
    _check_cascade(*_cuda_case(bands, 4096, 6))


@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_cuda_cascade_tails(n):
    """Partial tiles of 32 samples, with a carried state: the state after
    the last real sample."""
    _check_cascade(*_cuda_case(10, n, 7))


# ---- the serve plane through the frame kernel --------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _roundtrip(port, x, chunk):
    """Send [2, n] frames in chunks from a pump thread, half-close, and
    return the whole reply."""
    with ServeClient(f"tcp://127.0.0.1:{port}", x.shape[0], RATE,
                     timeout_s=60) as c:
        def pump():
            for i in range(0, x.shape[1], chunk):
                c.send(x[:, i:i + chunk])
            c.end_input()

        t = threading.Thread(target=pump)
        t.start()
        parts = []
        while (y := c.read_frames()) is not None:
            parts.append(y)
        t.join(timeout=60)
        assert not t.is_alive()
    return np.concatenate(parts, axis=1)


def _concurrent(port, signals, chunk):
    """Round trips of every signal at once; the replies in order."""
    out = [None] * len(signals)
    errors = []

    def run(i):
        try:
            out[i] = _roundtrip(port, signals[i], chunk)
        except Exception as e:  # re-raised below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(signals))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


def test_cuda_serves_two_streams_through_the_kernel(rng):
    _card()
    lf = load_filter(os.path.join(FILTER_DIR,
                                  "filter_44k_16x_8000_min_phase.json"))
    port = _free_port()
    srv = StreamServer(lf, f"tcp-listen://127.0.0.1:{port}", RATE,
                       max_streams=8, channels=2, device="cuda")
    srv.start()
    try:
        before = ff.LAUNCHES
        signals = [(rng.normal(size=(2, 20000 + 3001 * i)) * 0.3)
                   .astype(np.float32) for i in range(2)]
        replies = _concurrent(port, signals, chunk=4096)
        assert ff.LAUNCHES > before
        assert not srv.failed
    finally:
        srv.stop()
    for x, y in zip(signals, replies):
        assert _rel(y, upsample_signal(x, lf, device="cuda")) < REL
